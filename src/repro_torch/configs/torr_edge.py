"""The paper's own workload: TorR edge deployment configuration (port of
``repro.configs.torr_edge``).

D=8192 in 8 banks, 1024-concept item memory, depth-8 query cache, 64
aligner lanes at 1 GHz, with the RT-60/RT-30 QoS targets (paper Sec. 5).
"""
from __future__ import annotations

import dataclasses

from ..core.types import TorrConfig

# The paper's two QoS operating points: per-window completion deadlines.
RT_BUDGETS_S = {"RT-60": 1.0 / 60.0, "RT-30": 1.0 / 30.0}


def rt_budget_s(rt: str = "RT-60") -> float:
    """Per-window deadline in seconds for an RT-30/RT-60 operating point."""
    try:
        return RT_BUDGETS_S[rt]
    except KeyError:
        raise ValueError(
            f"unknown RT target {rt!r}; expected one of {sorted(RT_BUDGETS_S)}"
        ) from None


def torr_edge(rt: str = "RT-60", **overrides) -> TorrConfig:
    base = TorrConfig(
        D=8192, B=8, M=1024, K=8, N_max=128,
        delta_budget=2048, W=64, clock_hz=1.0e9,
        fps_target=1.0 / rt_budget_s(rt),
        tau_byp=0.95, tau_q=0.60, N_hi=8, q_hi=4,
        feat_dim=512,
    )
    return dataclasses.replace(base, **overrides) if overrides else base
