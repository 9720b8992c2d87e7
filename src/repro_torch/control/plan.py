"""Per-window knob plans: the control plane's unit of actuation (Sec. 4.6;
port of ``repro.control.plan``).

A :class:`KnobPlan` bundles every deployment-time knob the paper's QoS
controller trades at run time — effective dimension D' (a *cap* on Alg. 1's
bank choice), bit-slice precision for the packed XNOR-popcount path, and
offsets on the tau_q / tau_byp similarity thresholds. Plans are frozen and
hashable, and the pipeline resolves them on the host: like the ASIC's
window-latched register file (and the static-banks contract in
``kernels.ops``), a plan is latched per dispatched step and fixes the word
selection every kernel of that step reads.

Semantics (all exact, nothing approximate):

  * ``banks`` caps Alg. 1's ``select_banks`` choice: effective banks =
    ``min(alg1_banks, plan.banks)``. A full-plan cap (B) is therefore a
    bit-exact no-op.
  * ``planes`` keeps the ``planes`` highest-order bit-slice planes of every
    enabled bank (of ``cfg.bit_planes`` total); the scan's enabled dims are
    ``item_memory.plan_dim_mask(cfg, banks, planes)`` and scores normalize
    by the reduced D'. ``planes == cfg.bit_planes`` is a bit-exact no-op.
  * ``tau_q_off`` / ``tau_byp_off`` shift the Alg. 1 thresholds (negative
    offsets make the cheap delta/bypass paths easier to enter). Zero
    offsets leave the config object untouched.
  * ``bucket_cap`` latches the compact dispatch's bucket tier
    (``fused="compact"``; see ``core.pipeline``). Pure scheduling — every
    tier is bit-exact, so it never participates in :attr:`is_full`.

Exactness under switching: the query cache tags each accumulator with
``types.plan_tag(banks, planes)``; after any plan switch the tag mismatches
and the stale delta path is rejected (Eq. 6's D' requirement), exactly as
the pre-existing banks-only tag did for bank changes.
"""
from __future__ import annotations

import dataclasses

from ..core.types import TorrConfig


@dataclasses.dataclass(frozen=True)
class KnobPlan:
    """Static per-window knob setting (frozen and hashable)."""

    banks: int               # cap on Alg. 1's bank choice (1..B)
    planes: int              # bit-slice planes kept (1..plane_total)
    plane_total: int         # cfg.bit_planes at build time (denominator)
    tau_q_off: float = 0.0   # shift on the delta-vs-full threshold
    tau_byp_off: float = 0.0 # shift on the bypass threshold
    # compact-dispatch bucket capacity (fused="compact"): the latched tier
    # of core.policy.bucket_ladder the full-path proposals compact to. A
    # *scheduling* knob, never a numeric one — any tier is bit-exact
    # (overflow falls back to the hoisted scan); None defers to the step's
    # bucket_cap argument / full capacity.
    bucket_cap: int | None = None

    def __post_init__(self):
        if not 1 <= self.planes <= self.plane_total:
            raise ValueError(
                f"planes={self.planes} outside 1..{self.plane_total}")
        if self.banks < 1:
            raise ValueError(f"banks={self.banks} must be >= 1")
        if self.bucket_cap is not None and self.bucket_cap < 1:
            raise ValueError(
                f"bucket_cap={self.bucket_cap} must be >= 1 (or None)")

    @property
    def is_full(self) -> bool:
        """True iff this plan is a bit-exact no-op on the uncontrolled step."""
        return (self.planes == self.plane_total
                and self.tau_q_off == 0.0 and self.tau_byp_off == 0.0)
        # note: a full *cap* (banks == B) is implied by min(); the cap only
        # matters when it actually binds, which is checked at the call site.

    def validate(self, cfg: TorrConfig) -> None:
        if self.plane_total != cfg.bit_planes:
            raise ValueError(
                f"plan built for {self.plane_total} bit planes, config has "
                f"{cfg.bit_planes}")
        if self.banks > cfg.B:
            raise ValueError(f"banks cap {self.banks} exceeds B={cfg.B}")

    def d_eff(self, cfg: TorrConfig) -> int:
        """D' when the bank cap binds (the plan's worst-case width)."""
        return cfg.d_eff_planned(min(self.banks, cfg.B), self.planes)

    def thresholds(self, cfg: TorrConfig) -> TorrConfig:
        """Config with this plan's tau offsets applied (identity at 0)."""
        if self.tau_q_off == 0.0 and self.tau_byp_off == 0.0:
            return cfg
        return dataclasses.replace(
            cfg,
            tau_q=cfg.tau_q + self.tau_q_off,
            tau_byp=cfg.tau_byp + self.tau_byp_off,
        )


def full_plan(cfg: TorrConfig) -> KnobPlan:
    """The identity plan: full banks, all planes, untouched thresholds."""
    return KnobPlan(banks=cfg.B, planes=cfg.bit_planes,
                    plane_total=cfg.bit_planes)
