"""Slack-driven QoS governor with an energy budget (paper Sec. 4.6 close-loop;
port of ``repro.control.governor``).

The paper's controller trades D', thresholds and precision at deployment
time to hit RT-30/RT-60 at millijoule energy. Here that is a *closed loop*
between serving telemetry and the compute path:

    deadline tracker ──projected slack──▶ governor ──KnobPlan──▶ engine step
         ▲                                   ▲                      │
         └── measured step latency (EMA) ────┴── EWMA energy ◀──────┘
                                                 (cycle model on telemetry)

Design:

  * **Plan ladder.** :func:`build_ladder` orders knob plans from the full
    plan (level 0) to the cheapest (drop one bit-slice plane at a time,
    then halve banks; the deepest levels also relax tau_q/tau_byp so the
    cheap delta/bypass paths trigger earlier). Every level's worst-case
    window cycles come from the *shared* Sec. 4.3 cost helper
    (``core.policy.window_cycles_deff``) — the same math Alg. 1's bank
    gating and the cycle-accurate simulator use, so the three cannot drift.
  * **Pure selection.** :func:`plan_level` is a pure function of
    (projected slack, queue depth, measured step EMA, EWMA energy,
    previous level) — unit-testable without clocks or threads, mirroring
    ``serving.deadline.decide``.
  * **Hysteresis.** Degrading (deeper level) is immediate — a missed
    deadline is worse than a narrow window. Recovering (wider D'/more
    planes) requires ``recover_hold`` consecutive comfortable windows and
    then steps up one level at a time, so the latched plan does not
    thrash on slack noise.
  * **Energy governor.** An optional mJ/window budget: the EWMA of modeled
    window energy (``perf.cycle_model`` applied to the telemetry each
    window actually produced) caps the ladder level even when slack is
    plentiful — static power is subtracted before scaling, since bank and
    plane gating only shed *dynamic* aligner power.

Environment overrides (read by :func:`policy_from_env`):

    var                  | default | meaning
    -------------------- | ------- | ------------------------------------
    ``TORR_GOV_MARGIN``  |    0.25 | fraction of the RT budget held back
    ``TORR_GOV_HOLD``    |       4 | comfortable windows before recovery
    ``TORR_GOV_ENERGY_MJ``|    off | mJ/window energy budget (0 = off)
    ``TORR_GOV_ALPHA``   |     0.2 | EWMA weight of newest window energy
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..configs.torr_edge import rt_budget_s
from ..core import policy as alg1
from ..core.types import TorrConfig
from ..perf.cycle_model import P_STATIC
from .plan import KnobPlan, full_plan


@dataclasses.dataclass(frozen=True)
class GovernorPolicy:
    """Static thresholds for the pure :func:`plan_level` function."""

    budget_s: float               # RT deadline (same as the DeadlinePolicy's)
    slack_margin: float = 0.25    # fraction of budget held back as safety
    recover_hold: int = 4         # comfortable windows before stepping up
    energy_budget_mj: float | None = None  # mJ/window target (None = off)
    energy_alpha: float = 0.2     # EWMA weight of the newest window energy
    meas_alpha: float = 0.25      # how fast the measurement EMA tracks plan
                                  # switches; keep equal to the deadline
                                  # tracker's step_ema_alpha


def policy_for(rt: str = "RT-60", **overrides) -> GovernorPolicy:
    base = GovernorPolicy(budget_s=rt_budget_s(rt))
    return dataclasses.replace(base, **overrides) if overrides else base


def policy_from_env(rt: str = "RT-60") -> GovernorPolicy:
    """Governor policy with ``TORR_GOV_*`` environment overrides applied."""
    kw = {}
    if os.environ.get("TORR_GOV_MARGIN"):
        kw["slack_margin"] = float(os.environ["TORR_GOV_MARGIN"])
    if os.environ.get("TORR_GOV_HOLD"):
        kw["recover_hold"] = int(os.environ["TORR_GOV_HOLD"])
    if os.environ.get("TORR_GOV_ENERGY_MJ"):
        mj = float(os.environ["TORR_GOV_ENERGY_MJ"])
        kw["energy_budget_mj"] = mj if mj > 0 else None
    if os.environ.get("TORR_GOV_ALPHA"):
        kw["energy_alpha"] = float(os.environ["TORR_GOV_ALPHA"])
    return policy_for(rt, **kw)


def build_ladder(cfg: TorrConfig) -> tuple[KnobPlan, ...]:
    """Knob plans from full (level 0) to cheapest.

    Precision degrades before dimension (dropping a low-order bit-slice
    plane is the gentlest knob — TaskCLIP/ImageHD-style graceful decay);
    once a single plane remains, banks halve. The deepest (bank-reduced)
    levels additionally relax the similarity thresholds so Alg. 1 admits
    more delta/bypass traffic while the loop is under pressure.
    """
    P, B = cfg.bit_planes, cfg.B
    ladder = [full_plan(cfg)]
    banks, planes = B, P
    while banks > 1 or planes > 1:
        if planes > 1:
            planes -= 1
            off_q, off_b = 0.0, 0.0
        else:
            banks = max(1, banks // 2)
            off_q, off_b = -0.05, -0.03
        ladder.append(KnobPlan(banks=banks, planes=planes, plane_total=P,
                               tau_q_off=off_q, tau_byp_off=off_b))
    return tuple(ladder)


def ladder_rel_cost(ladder: tuple[KnobPlan, ...], cfg: TorrConfig) -> np.ndarray:
    """Worst-case window cycles of each level relative to the full plan.

    Priced by the shared Sec. 4.3 helper at a nominal heavy window (all
    proposals full-path, N = N_hi) — the same worst case Alg. 1's bank
    gating solves against.
    """
    n_nom = max(cfg.N_hi, 1)
    ref = alg1.window_cycles_deff(n_nom, 0, cfg.D, cfg)
    return np.asarray([
        alg1.window_cycles_deff(n_nom, 0, p.d_eff(cfg), cfg) / ref
        for p in ladder
    ], np.float64)


def plan_level(
    slack_s: float,
    backlog: int,
    step_s: float,
    level: int,
    recover: int,
    rel_cost: np.ndarray,
    pol: GovernorPolicy,
    energy_ewma_mj: float = 0.0,
    rel_meas: float | None = None,
) -> tuple[int, int]:
    """Pure level selection: (new_level, new_recover_count).

    ``slack_s`` is the head window's remaining time to deadline, ``step_s``
    the engine's measured per-step latency EMA (0 = no measurement yet,
    optimistic), ``backlog`` the windows queued behind the head (they must
    drain inside the same slack). ``rel_meas`` is the relative cost the
    measurement EMA reflects — an EMA blends steps taken at *past* levels,
    so right after a plan switch it lags ``rel_cost[level]``; the
    :class:`Governor` tracks it with the same alpha the deadline tracker
    blends latencies with (default: the current level's cost). The governor
    picks the widest (lowest-index) level whose predicted drain time fits
    the slack after the safety margin, then applies the energy cap and the
    recovery hysteresis.
    """
    n_levels = len(rel_cost)
    rel_meas = rel_cost[level] if rel_meas is None else rel_meas
    usable = slack_s - pol.slack_margin * pol.budget_s
    if step_s <= 0.0:
        desired = 0
    else:
        # re-normalize the measurement to the full plan, then predict each
        # level's drain time for head + backlog
        step_full = step_s / rel_meas
        fits = step_full * rel_cost * (1 + backlog) <= usable
        desired = int(np.argmax(fits)) if fits.any() else n_levels - 1

    if pol.energy_budget_mj is not None and energy_ewma_mj > 0.0:
        # bank/plane gating sheds dynamic power only; static is a floor
        static_mj = P_STATIC * pol.budget_s * 1e3
        dyn = max(energy_ewma_mj - static_mj, 0.0)
        pred_mj = static_mj + dyn * rel_cost / rel_meas
        e_fits = pred_mj <= pol.energy_budget_mj
        e_level = int(np.argmax(e_fits)) if e_fits.any() else n_levels - 1
        desired = max(desired, e_level)

    if desired > level:            # degrade immediately
        return desired, 0
    if desired < level:            # recover gradually, after a hold
        recover += 1
        if recover >= pol.recover_hold:
            return level - 1, 0
        return level, recover
    return level, 0


class Governor:
    """Mutable loop state around the pure :func:`plan_level` table."""

    def __init__(self, cfg: TorrConfig, pol: GovernorPolicy,
                 ladder: tuple[KnobPlan, ...] | None = None,
                 metrics=None, slo=None):
        self.cfg = cfg
        self.pol = pol
        self.ladder = tuple(ladder) if ladder is not None else build_ladder(cfg)
        for p in self.ladder:
            p.validate(cfg)
        self.rel_cost = ladder_rel_cost(self.ladder, cfg)
        self.level = 0
        self._recover = 0
        # authoritative control-plane audit trail: one (banks, planes,
        # level) entry per update() call, i.e. per dispatched governed
        # step; replaying it with StreamEngine.set_plan reproduces the
        # governed run. One small tuple per step; clear() between runs if
        # a long-lived host needs the memory back.
        self.plan_log: list[tuple[int, int, int]] = []
        self._g_level = None
        if metrics is not None:
            self._g_level = metrics.gauge(
                "torr_plan_level",
                "Current ladder position (0 = full plan).")
            self._g_energy = metrics.gauge(
                "torr_energy_ewma_mj",
                "EWMA of modeled per-window energy (mJ).")
            self._c_switch = metrics.counter(
                "torr_plan_switches_total",
                "Knob-plan latch changes (hysteresis-damped).")
        # relative cost of the steps the latency EMA currently reflects:
        # blended at the same rate the deadline tracker blends latencies,
        # so step_s / rel_meas stays an unbiased full-plan estimate across
        # plan switches
        self._rel_meas = float(self.rel_cost[0])
        self.energy_ewma_mj = 0.0
        self.switches = 0
        self.windows_by_level = [0] * len(self.ladder)
        # optional RT-SLO feedback (duck-typed: anything with an
        # ``alert_level`` int, such as repro.obs.slo.SLOMonitor): per-update
        # slack is a *projection*, so slack noise can hold the plan wide
        # while real completions burn the miss budget. The burn-rate hook
        # closes that gap: at WARN the recovery hold is frozen (no widening
        # while the budget burns), at PAGE one extra degrade level is
        # forced. slo=None (the default) leaves plan_level's output
        # untouched.
        self._slo = slo

    @property
    def plan(self) -> KnobPlan:
        return self.ladder[self.level]

    def update(self, slack_s: float, step_s: float, backlog: int = 0,
               n_windows: int = 1) -> KnobPlan:
        """One control step: pick the plan for the next dispatched batch."""
        level, self._recover = plan_level(
            slack_s, backlog, step_s, self.level, self._recover,
            self.rel_cost, self.pol, self.energy_ewma_mj,
            rel_meas=self._rel_meas)
        if self._slo is not None:
            alert = self._slo.alert_level
            if alert >= 1 and level < self.level:
                # WARN: the miss budget is burning — hold position instead
                # of widening on a projection
                level, self._recover = self.level, 0
            if alert >= 2:
                # PAGE: force one extra degrade step (bounded by ladder)
                level = min(max(level, self.level) + 1,
                            len(self.ladder) - 1)
                self._recover = 0
        if level != self.level:
            self.switches += 1
            self.level = level
            if self._g_level is not None:
                self._c_switch.inc()
        a = self.pol.meas_alpha
        self._rel_meas = (1 - a) * self._rel_meas + a * float(self.rel_cost[level])
        self.windows_by_level[level] += n_windows
        plan = self.ladder[level]
        self.plan_log.append((int(plan.banks), int(plan.planes), level))
        if self._g_level is not None:
            self._g_level.set(level)
        return plan

    def observe_energy(self, mj: float) -> None:
        """Fold one window's modeled energy into the EWMA."""
        a = self.pol.energy_alpha
        self.energy_ewma_mj = mj if self.energy_ewma_mj <= 0.0 else \
            (1.0 - a) * self.energy_ewma_mj + a * mj
        if self._g_level is not None:
            self._g_energy.set(self.energy_ewma_mj)

    def summary(self) -> dict:
        p = self.plan
        return {
            "level": self.level,
            "n_levels": len(self.ladder),
            "plan_banks": p.banks,
            "plan_planes": p.planes,
            "plan_switches": self.switches,
            "windows_by_level": list(self.windows_by_level),
            "energy_ewma_mj": self.energy_ewma_mj,
        }
