"""Algorithm 1: similarity-gated path policy + FPS/QoS bank gating (port of
``repro.core.policy``).

Pure functions of (rho, |Delta|, N, q) and static thresholds. Every input
may carry leading batch axes. Float comparisons run in float32 against the
threshold rounded to float32, as JAX does with a weakly typed Python float.
"""
from __future__ import annotations

import torch

from .types import PATH_BYPASS, PATH_DELTA, PATH_FULL, TorrConfig


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to a float32 scalar on ``like``'s device, written by a
    fill (no host data crosses: the step's captured segments call it)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def high_load(n_objects: torch.Tensor, queue_depth: torch.Tensor,
              cfg: TorrConfig) -> torch.Tensor:
    """H(N, q) = (N >= N_hi) or (q >= q_hi)."""
    return torch.logical_or(n_objects >= cfg.N_hi, queue_depth >= cfg.q_hi)


def select_path(rho: torch.Tensor, delta_count: torch.Tensor,
                acc_tag_ok: torch.Tensor, high: torch.Tensor,
                cfg: TorrConfig) -> torch.Tensor:
    """Alg. 1 lines 2-8, with the delta-feasibility guards (budget, plan
    tag)."""
    delta_ok = torch.logical_and(
        rho >= _f32(cfg.tau_q, rho),
        torch.logical_and(delta_count <= cfg.delta_budget, acc_tag_ok),
    )
    bypass = torch.logical_and(rho >= _f32(cfg.tau_byp, rho), high)
    return torch.where(
        bypass, PATH_BYPASS, torch.where(delta_ok, PATH_DELTA, PATH_FULL)
    ).to(torch.int32)


def intra_window_coupled(actions: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Conflict-set predicate of the batched decide pass: bool [..., N],
    True where proposal i's path decision could depend on an earlier
    proposal of the same window — some valid j < i took a cache-writing
    path (delta or full). Bypass only touches ages, which can move a later
    LRU choice but never a later (action, idx, rho, |Delta|). A superset:
    a coupled proposal may still decide as it would on the frozen
    snapshot."""
    writes = torch.logical_and(
        valid, torch.logical_or(actions == PATH_DELTA, actions == PATH_FULL)
    ).to(torch.int32)
    return (torch.cumsum(writes, dim=-1) - writes) > 0


# Shared Sec. 4.3 cycle-cost math (plain arithmetic: Python ints or tensors).

PROPOSAL_OVERHEAD_CYCLES = 64  # pipelined PSU + reasoner + sort constant


def mw_cycles(cfg: TorrConfig) -> int:
    """ceil(M/W): cycles per broadcast column across the W class lanes."""
    return -(-cfg.M // cfg.W)


def aligner_cycles(n_full, delta_cols, d_eff, mw):
    """Sec. 4.3 aligner core: a full scan costs D'*ceil(M/W); the delta path
    one ceil(M/W) column-broadcast per corrected dimension."""
    return (n_full * d_eff + delta_cols) * mw


def proposal_overhead(n_proposals, mw):
    """Per-proposal pipelined PSU + reasoner + sort: ~M/W plus a constant."""
    return n_proposals * (mw + PROPOSAL_OVERHEAD_CYCLES)


def window_cycles_deff(n_full, n_delta, d_eff, cfg: TorrConfig):
    """Worst-case window cycles at an explicit effective dimension D'."""
    mw = mw_cycles(cfg)
    return (aligner_cycles(n_full, n_delta * cfg.delta_budget, d_eff, mw)
            + proposal_overhead(n_full + n_delta, mw))


def window_cycles(n_full, n_delta, banks, cfg: TorrConfig):
    """Cycle estimate per Sec. 4.3: full = D'*ceil(M/W), delta =
    |Dmax|*ceil(M/W), plus a per-proposal overhead."""
    return window_cycles_deff(n_full, n_delta, banks * cfg.bank_dims, cfg)


# Compact-dispatch bucket ladder: the static bucket capacities the compact
# lowering pads its full-path rows to, shared by the pipeline and the
# engine's load-aware auto dispatch (host ints).

def bucket_ladder(n_rows: int) -> tuple[int, ...]:
    """Bucket capacities for a flattened batch of ``n_rows``: powers of two
    below ``n_rows``, then ``n_rows`` itself (the no-savings tier)."""
    if n_rows < 1:
        raise ValueError(f"n_rows={n_rows} must be >= 1")
    caps = []
    c = 1
    while c < n_rows:
        caps.append(c)
        c *= 2
    caps.append(n_rows)
    return tuple(caps)


def bucket_tier(n_rows: int, want: int) -> int:
    """Smallest ladder capacity >= ``want`` (clamped to [1, n_rows])."""
    want = max(1, min(int(want), n_rows))
    for c in bucket_ladder(n_rows):
        if c >= want:
            return c
    return n_rows


def select_banks(n_objects: torch.Tensor, queue_depth: torch.Tensor,
                 cfg: TorrConfig) -> torch.Tensor:
    """QoS bank gating: largest bank count whose worst case (all full) fits
    the per-window cycle budget, which queue depth shrinks. int32 [...],
    always >= 1."""
    budget = (_f32(cfg.cycles_per_window_budget, queue_depth)
              / (1.0 + queue_depth.to(torch.float32)))
    n = torch.clamp(n_objects.to(torch.int64), min=1)
    candidates = torch.arange(1, cfg.B + 1, dtype=torch.int64,
                              device=n.device)
    worst = window_cycles(n[..., None], 0, candidates, cfg)     # [..., B]
    fits = worst.to(torch.float32) <= budget[..., None]
    best = torch.amax(torch.where(fits, candidates, 1), dim=-1)
    return best.to(torch.int32)
