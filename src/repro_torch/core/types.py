"""Shared configuration/state types for the TorR core (port of
``repro.core.types``).

The config mirrors the paper's deployment-time knobs: dimension D, bank count
B (so the effective dimension D' is a multiple of D/B), similarity thresholds
(tau_byp, tau_q), load thresholds (N_hi, q_hi), the delta budget, lane count
W and clock — the last two parameterize the cycle model of paper Sec. 4.7.
State types are dataclasses of tensors; a multi-stream step gives every
tensor a leading stream-slot axis ``[S]``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TorrConfig:
    """Static TorR configuration (hashable)."""

    # --- HDC geometry -----------------------------------------------------
    D: int = 8192            # full hypervector dimension
    B: int = 8               # item-memory banks (D' = k * D/B, k in 1..B)
    M: int = 128             # number of concept hypervectors in item memory
    feat_dim: int = 512      # encoder feature dim d (z_e in R^d)

    # --- cache / reuse ----------------------------------------------------
    K: int = 8               # query-cache depth
    N_max: int = 16          # max proposals (queries) per window
    delta_budget: int = 1024 # static |Delta| budget (multiple of 8)

    # --- Alg. 1 thresholds --------------------------------------------------
    tau_byp: float = 0.95    # bypass similarity threshold
    tau_q: float = 0.60      # delta-vs-full similarity threshold
    N_hi: int = 8            # high-load object count
    q_hi: int = 4            # high-load queue depth

    # --- reasoner ----------------------------------------------------------
    n_relations: int = 16    # relation hypervectors (used-for, part-of, ...)
    max_hops: int = 3        # max k-hop relation path length
    top_k: int = 5           # top-k key width for reasoner gating
    margin_eps: float = 0.02 # margin tolerance for reasoner gating

    # --- hardware model (paper Sec. 4.3 / 4.7, TSMC 28nm @ 1 GHz) ----------
    W: int = 64              # class lanes in the associative aligner
    clock_hz: float = 1.0e9  # 1 GHz
    accum_bits: int = 8      # accumulator precision knob
    bit_planes: int = 4      # bit-slice planes per bank (precision gating grain)

    # --- QoS ---------------------------------------------------------------
    fps_target: float = 60.0

    def __post_init__(self):
        if self.D % (self.B * 32) != 0:
            raise ValueError(f"D={self.D} must be divisible by 32*B={32 * self.B}")
        if self.delta_budget % 8 != 0:
            raise ValueError("delta_budget must be a multiple of 8")
        if self.bank_words % self.bit_planes != 0:
            raise ValueError(
                f"bank words D/(32B)={self.bank_words} must be divisible by "
                f"bit_planes={self.bit_planes}")

    @property
    def words(self) -> int:
        """Total packed 32-bit words per hypervector."""
        return self.D // 32

    @property
    def bank_dims(self) -> int:
        """Dimensions per bank (D/B)."""
        return self.D // self.B

    @property
    def bank_words(self) -> int:
        return self.bank_dims // 32

    def d_eff(self, banks):
        """Effective dimension D' for a given number of enabled banks."""
        return banks * self.bank_dims

    @property
    def plane_words(self) -> int:
        """Packed words per bit-slice plane within one bank."""
        return self.bank_words // self.bit_planes

    @property
    def plane_dims(self) -> int:
        """Dimensions per bit-slice plane within one bank."""
        return self.bank_dims // self.bit_planes

    def d_eff_planned(self, banks, planes: int):
        """Effective dimension under combined bank + bit-plane gating."""
        return banks * (self.plane_dims * planes)

    @property
    def cycles_per_window_budget(self) -> float:
        return self.clock_hz / self.fps_target


# Path encodings shared by the policy, pipeline and cycle model.
PATH_BYPASS = 0
PATH_DELTA = 1
PATH_FULL = 2
PATH_NAMES = ("bypass", "delta", "full")

# Static-lowering encodings recorded in WindowTelemetry (index-aligned with
# ``repro.core.types`` so traces decode with one vocabulary).
FUSED_NAMES = ("off", "switch", "prefix", "compact")
FUSED_IDS = {name: i for i, name in enumerate(FUSED_NAMES)}
DECIDE_NAMES = ("scan", "batched")
DECIDE_IDS = {name: i for i, name in enumerate(DECIDE_NAMES)}
DECIDE_NONE = -1   # non-compact lowerings run no decide pass

# The delta accumulator's exactness tag (Eq. 6): one int32 packs the
# (banks, planes) pair an accumulator was computed under; 0 (the init value)
# never collides because banks >= 1 for any real scan.
PLAN_TAG_BASE = 256


def plan_tag(banks, planes):
    """int32 tag for an accumulator computed under (banks, planes)."""
    return banks * PLAN_TAG_BASE + planes


@dataclasses.dataclass
class StreamBatch:
    """One batched multi-stream window step's inputs (S stream slots).

    Slot s carries stream s's next window. Idle slots are padded with
    ``valid`` all-False and ``queue_depth`` 0; the pipeline's pad branch
    leaves that slot's cache untouched. ``queue_depth`` is per stream, so
    Alg. 1's load gating stays per stream under batching.
    """

    q_packed: torch.Tensor     # int32 [S, N_max, D//32] proposal query HVs
    valid: torch.Tensor        # bool  [S, N_max]
    boxes: torch.Tensor        # f32   [S, N_max, 4]
    queue_depth: torch.Tensor  # int32 [S] per-stream backlog

    @property
    def n_streams(self) -> int:
        return self.q_packed.shape[0]


@dataclasses.dataclass
class WindowTelemetry:
    """Per-window execution trace (same fields as ``repro``'s).

    ``queue_depth``/``high_load`` echo the load signals Alg. 1's gate saw;
    ``banks``/``planes`` the knob plan the window ran with;
    ``fused_mode``/``decide_mode``/``bucket_tier`` the resolved lowering
    (``FUSED_IDS``/``DECIDE_IDS`` encodings).
    """

    path: torch.Tensor        # [N_max] int32, PATH_* per proposal
    delta_count: torch.Tensor # [N_max] int32, |Delta| per proposal
    banks: torch.Tensor       # [] int32, enabled banks this window
    rho: torch.Tensor         # [N_max] f32, similarity to nearest cached query
    n_valid: torch.Tensor     # [] int32, actual proposals this window
    reasoner_active: torch.Tensor  # [N_max] bool, reasoner ran (not gated)
    queue_depth: torch.Tensor # [] int32, backlog fed to H(N, q) this window
    high_load: torch.Tensor   # [] bool, H(N, q) as evaluated by Alg. 1
    planes: torch.Tensor      # [] int32, enabled bit-slice planes
    fused_mode: torch.Tensor  # [] int32, FUSED_IDS[...] the step ran with
    decide_mode: torch.Tensor # [] int32, DECIDE_IDS[...] or DECIDE_NONE
    bucket_tier: torch.Tensor # [] int32, compact bucket capacity (0 = n/a)


def map_tensors(fn, obj):
    """Apply ``fn`` to every tensor field of a dataclass of tensors (the
    port's stand-in for ``jax.tree_util.tree_map`` over one level)."""
    return dataclasses.replace(obj, **{
        f.name: fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
