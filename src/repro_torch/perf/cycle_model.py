"""Cycle-accurate model of the TorR accelerator (paper Sec. 4.7 / 5.2; port
of ``repro.perf.cycle_model``).

Timing follows the paper's pipelined datapath at 1 GHz:
    cycles_full  ~= D' * ceil(M/W)          (one column/cycle, W lanes)
    cycles_delta ~= |Delta| * ceil(M/W)     (one flipped column/cycle)
    reasoner     ~= ceil(M/W) + c           (one score product/lane/cycle)
    PSU          ~= D'/32 + c               (XOR+popcount, 32 bits/cycle/word)
    sort/top-k   ~= M + k log k
    DMA          ~= query/score bits over a 128-bit/cycle host interface

Power follows Table 1 block peaks (TSMC 28 nm, 1 GHz), duty-cycled by the
fraction of window cycles each block is busy, with bank gating scaling the
aligner's dynamic power by D'/D. Static (clock tree + SRAM + leakage) power
is the calibration constant chosen so the five-task averages land on the
paper's measured 3.05-3.52 W envelope.

The model consumes WindowTelemetry traces — the *same* path decisions the
functional pipeline makes — so functional and timing models cannot drift
apart. It is host numpy: :func:`telemetry_cost` moves a window's telemetry
off the card once before reading it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.policy import aligner_cycles, bucket_tier, mw_cycles
from ..core.types import (DECIDE_NAMES, FUSED_NAMES, PATH_BYPASS, PATH_DELTA,
                          PATH_FULL, TorrConfig)

# --- Table 1 (TSMC 28 nm, 1 GHz): block peak powers in watts ---------------
P_ALIGNER = 3.52256
P_REASONER = 0.50432
P_PSU = 0.22016
P_SCORE_BUF = 0.11008
P_SORTER = 0.11008
P_CONTROLLER = 0.05504
P_HOST_DMA = 0.08256
P_FIFO_MISC = 0.05504
P_SRAM = 0.135
AREA = {
    "Associative Aligner": 4.488, "Lightweight Reasoner": 0.642,
    "Partial-Update Unit": 0.280, "Score Buffer (top-k)": 0.140,
    "Sorter": 0.140, "Controller (RT/QoS)": 0.070,
    "Host IF / DMA": 0.105, "Delta-index FIFO & misc.": 0.070,
    "Item memory (banked)": 0.50, "Query/Output caches": 0.03,
}
POWER_W = {
    "Associative Aligner": P_ALIGNER, "Lightweight Reasoner": P_REASONER,
    "Partial-Update Unit": P_PSU, "Score Buffer (top-k)": P_SCORE_BUF,
    "Sorter": P_SORTER, "Controller (RT/QoS)": P_CONTROLLER,
    "Host IF / DMA": P_HOST_DMA, "Delta-index FIFO & misc.": P_FIFO_MISC,
    "Item memory (banked)": 0.120, "Query/Output caches": 0.015,
}

# Calibrated constants (fit once against Table 3's five-task averages).
# A wider window (RT-30: dt = 33ms) aggregates ~2x the DVS events of RT-60,
# so encoder + aggregation cost scale with window width and inter-window
# coherence decays (rho_eff = rho^window_scale) — this is what reproduces
# the paper's near-2x latency growth from RT-60 to RT-30.
P_STATIC = 2.92          # clock tree + leakage + always-on control, W
DMA_BITS_PER_CYCLE = 128
ENCODER_CYCLES_PER_PROPOSAL = 36_000   # event-SNN share per proposal @ 60 FPS
HOST_OVERHEAD_CYCLES = 4_200_000       # window aggregation + host stack @ 60 FPS


@dataclasses.dataclass
class WindowCost:
    cycles: dict            # per-block busy cycles
    total_cycles: float
    energy_j: float
    power_w: float


def latency_summary(lat_s, budget_s: float) -> dict:
    """Distribution summary of per-window latencies against an RT budget.

    Shared vocabulary between the simulated cycle model (``simulate_task``)
    and measured serving telemetry (``serving.deadline``): both report
    the same keys, so dashboards/benchmarks can diff simulated vs measured
    envelopes directly. ``jitter_ms`` is p95 - median (the paper's jitter
    metric); ``miss_rate`` is the fraction of windows over budget.
    """
    lat = np.asarray(lat_s, np.float64)
    if lat.size == 0:
        return {"budget_ms": budget_s * 1e3, "n_windows": 0,
                "median_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
                "min_ms": 0.0, "max_ms": 0.0, "jitter_ms": 0.0,
                "headroom_ms": budget_s * 1e3, "miss_rate": 0.0}
    med = float(np.median(lat))
    p95 = float(np.percentile(lat, 95))
    p99 = float(np.percentile(lat, 99))
    return {
        "budget_ms": budget_s * 1e3,
        "n_windows": int(lat.size),
        "median_ms": med * 1e3,
        "p95_ms": p95 * 1e3,
        "p99_ms": p99 * 1e3,
        "min_ms": float(lat.min()) * 1e3,
        "max_ms": float(lat.max()) * 1e3,
        "jitter_ms": (p95 - med) * 1e3,
        "headroom_ms": (budget_s - p95) * 1e3,
        "miss_rate": float(np.mean(lat > budget_s)),
    }


def lowering_scan_rows(n_full: int, n_valid: int, fused: str = "switch",
                       bucket_cap: int | None = None) -> int:
    """Full-scan rows a *lowering* actually pays for one window.

    The ASIC (and the branch-economy ``"switch"``/``"off"`` lowerings) scan
    exactly the full-path proposals; the hoisted ``"prefix"`` lowering
    scans every row of the window regardless of the path mix; the
    reuse-aware ``"compact"`` lowering scans its static bucket tier — the
    smallest ``core.policy.bucket_ladder`` capacity holding the full-path
    rows when ``bucket_cap`` is None (a perfectly-tiered dispatcher), or
    the latched tier, degrading to every row when the bucket overflows
    (the exact fallback rescans the window). This is what makes modeled
    cycles shrink with the *hit rate* under compact dispatch while the
    always-hoisted lowering stays flat.
    """
    if fused in ("off", "switch"):
        return n_full
    if fused == "prefix":
        return n_valid
    if fused == "compact":
        if n_valid < 1:
            return 0
        cap = bucket_tier(n_valid, max(n_full, 1)) if bucket_cap is None \
            else min(int(bucket_cap), n_valid)
        return cap if n_full <= cap else n_valid
    raise ValueError(f"unknown lowering {fused!r}")


def decide_psu_cycles(n_valid: int, d_eff: int, decide: str = "scan") -> int:
    """PSU (cache-nearest) cycles for one window's decide work.

    ``"scan"`` is the sequential per-proposal pass: each of the ``n_valid``
    proposals pays its D'/32-word popcount column *plus* the ~8-cycle
    pipeline restart (drain/refill between dependent lookups — proposal
    i+1's nearest cannot issue until proposal i's cache write lands).
    ``"batched"`` is the batched intra-window decide
    (``core.pipeline._decide_pass_batched``): the popcount columns of all
    proposals stream through one wide pass, so the restart constant is
    paid once per window instead of once per proposal — the conflict scan
    that replays intra-window writes is O(K) bookkeeping off the PSU's
    critical path. Batched is never priced above scan for any
    ``n_valid >= 1`` (pinned by ``tests/test_decide_batched.py``).
    """
    per_row = d_eff // 32
    if decide == "batched":
        return n_valid * per_row + 8
    if decide == "scan":
        return n_valid * (per_row + 8)
    raise ValueError(f"unknown decide lowering {decide!r}")


def window_cost(path: np.ndarray, delta_count: np.ndarray, banks: int,
                reasoner_active: np.ndarray, n_valid: int,
                cfg: TorrConfig, rt_budget_s: float,
                window_scale: float = 1.0,
                d_eff: int | None = None,
                fused: str = "switch",
                bucket_cap: int | None = None,
                decide: str = "scan") -> WindowCost:
    """Cost of one window from its telemetry trace.

    ``d_eff`` overrides the bank-implied effective dimension when the
    window ran under a precision-gated knob plan (D' = banks * bank_dims *
    planes / bit_planes); :func:`telemetry_cost` derives it from telemetry.
    The aligner term comes from the shared Sec. 4.3 helper in
    ``core.policy`` — the same math Alg. 1 and the QoS governor price with.
    ``fused``/``bucket_cap`` price the aligner's scan rows per the actual
    lowering (:func:`lowering_scan_rows`); the default (``"switch"``) is
    the ASIC-faithful per-full-proposal cost. ``decide`` prices the PSU's
    cache-nearest pass per the decide lowering (:func:`decide_psu_cycles`);
    the default (``"scan"``) is the ASIC-faithful sequential FSM.
    """
    mw = mw_cycles(cfg)
    d_eff = banks * cfg.bank_dims if d_eff is None else int(d_eff)
    path = np.asarray(path)[:n_valid]
    dc = np.asarray(delta_count)[:n_valid]
    ra = np.asarray(reasoner_active)[:n_valid]

    n_full = int(np.sum(path == PATH_FULL))
    n_delta = int(np.sum(path == PATH_DELTA))
    n_byp = int(np.sum(path == PATH_BYPASS))

    scan_rows = lowering_scan_rows(n_full, int(n_valid), fused, bucket_cap)
    aligner = int(aligner_cycles(
        scan_rows, int(np.sum(dc[path == PATH_DELTA])), d_eff, mw))
    psu = decide_psu_cycles(int(n_valid), d_eff, decide)
    reasoner = int(np.sum(ra)) * (mw + 4)
    sorter = (n_full + n_delta) * (cfg.M + 32)
    dma = n_valid * (d_eff + cfg.M * 16) // DMA_BITS_PER_CYCLE
    encoder = int(n_valid * ENCODER_CYCLES_PER_PROPOSAL * window_scale)
    ctrl = n_valid * 16

    busy = {
        "aligner": aligner, "psu": psu, "reasoner": reasoner,
        "sorter": sorter, "dma": dma, "ctrl": ctrl,
    }
    total = (aligner + psu + reasoner + sorter + dma + ctrl
             + encoder + HOST_OVERHEAD_CYCLES * window_scale)
    t_window = total / cfg.clock_hz
    budget_cycles = rt_budget_s * cfg.clock_hz

    duty = {k: v / budget_cycles for k, v in busy.items()}
    p_dyn = (
        P_ALIGNER * duty["aligner"] * (d_eff / cfg.D)
        + P_PSU * duty["psu"]
        + P_REASONER * duty["reasoner"]
        + (P_SORTER + P_SCORE_BUF) * duty["sorter"]
        + P_HOST_DMA * duty["dma"]
        + (P_CONTROLLER + P_FIFO_MISC) * duty["ctrl"]
        + P_SRAM * (duty["aligner"] + duty["psu"])
    )
    power = P_STATIC + p_dyn
    energy = power * rt_budget_s          # frame-budget-locked energy
    return WindowCost(busy, total, energy, power)


def telemetry_cost(tel, cfg: TorrConfig, rt_budget_s: float,
                   window_scale: float = 1.0,
                   use_recorded_lowering: bool = False) -> WindowCost:
    """Cost one served window straight from its telemetry.

    Reads the knob plan the window *actually* ran with — ``banks`` and
    ``planes`` are both recorded in :class:`~repro_torch.core.types
    .WindowTelemetry` — so the QoS governor's energy feedback and any
    offline audit price precision-gated windows correctly. Fields may be
    numpy arrays or tensors on any device; tensors move to the host once,
    all fields together, before any is read.

    ``use_recorded_lowering=True`` additionally prices with the resolved
    ``fused_mode``/``decide_mode``/``bucket_tier`` the telemetry recorded
    (an opt-in: the default keeps the nominal ``fused="switch"`` pricing
    the governor's energy EWMA and table8's operating points are
    calibrated against, so enabling it changes modeled numbers — meant
    for lowering audits that diff measured vs modeled envelopes, e.g. on
    flight-recorder digests whose key names match these arguments).
    """
    tel = _host(tel)
    banks = int(tel.banks)
    planes = int(tel.planes)
    kw = {}
    if use_recorded_lowering:
        fused = FUSED_NAMES[int(tel.fused_mode)]
        decide_id = int(tel.decide_mode)
        tier = int(tel.bucket_tier)
        kw = {"fused": fused,
              "decide": DECIDE_NAMES[decide_id] if decide_id >= 0 else "scan",
              "bucket_cap": tier if tier > 0 else None}
    return window_cost(
        np.asarray(tel.path), np.asarray(tel.delta_count), banks,
        np.asarray(tel.reasoner_active), int(tel.n_valid), cfg, rt_budget_s,
        window_scale=window_scale,
        d_eff=int(cfg.d_eff_planned(banks, planes)), **kw)


def _host(tel):
    """``tel`` with every field a host numpy array. Tensors on the card are
    copied off asynchronously, all fields together, then waited for once:
    one synchronisation for the window, not one per field read."""
    vals = {f.name: getattr(tel, f.name) for f in dataclasses.fields(tel)}
    cards = [v.device for v in vals.values()
             if isinstance(v, torch.Tensor) and v.is_cuda]
    vals = {k: v.to("cpu", non_blocking=True) if isinstance(v, torch.Tensor)
            else v for k, v in vals.items()}
    if cards:
        torch.cuda.synchronize(cards[0])
    return dataclasses.replace(tel, **{k: np.asarray(v)
                                       for k, v in vals.items()})


def path_mix(rho: np.ndarray, delta: np.ndarray, high: bool,
             cfg: TorrConfig) -> np.ndarray:
    """Host-side (numpy) Alg. 1 path decision for trace simulation.

    Mirrors ``core.policy.select_path`` with the accumulator tag assumed
    valid — the shared decision table for every trace simulator
    (``simulate_task`` here), so the simulated path mix can't drift from
    the policy's rules.
    """
    path = np.full(rho.shape, PATH_FULL)
    path[(rho >= cfg.tau_q) & (delta <= cfg.delta_budget)] = PATH_DELTA
    if high:
        path[rho >= cfg.tau_byp] = PATH_BYPASS
    return path


# ---------------------------------------------------------------------------
# Task trace profiles: each task is a stochastic process over (object count,
# temporal coherence rho).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TaskProfile:
    name: str
    n_mean: float          # proposals per window
    n_std: float
    rho_mean: float        # query similarity between windows
    rho_std: float
    churn: float           # fraction of proposals that are new objects


TASK_PROFILES = {
    "pour wine": TaskProfile("pour wine", 86, 14, 0.86, 0.07, 0.10),
    "sports": TaskProfile("sports", 94, 18, 0.82, 0.09, 0.16),
    "cooking": TaskProfile("cooking", 74, 12, 0.88, 0.06, 0.08),
    "have breakfast": TaskProfile("have breakfast", 62, 9, 0.93, 0.04, 0.04),
    "take a rest": TaskProfile("take a rest", 64, 10, 0.92, 0.04, 0.05),
}


def _edge_config(rt: str) -> TorrConfig:
    return TorrConfig(D=8192, B=8, M=1024, K=8, N_max=128,
                      delta_budget=2048, W=64,
                      fps_target=60.0 if rt == "RT-60" else 30.0)


def simulate_task(task: str, rt: str = "RT-60", n_frames: int = 600,
                  seed: int = 0, cfg: TorrConfig | None = None) -> dict:
    """Replay a synthetic task trace through Alg. 1 + the cycle model."""
    prof = TASK_PROFILES[task]
    cfg = cfg or _edge_config(rt)
    rng = np.random.default_rng(seed)
    budget = 1.0 / cfg.fps_target
    window_scale = 60.0 * budget           # 1.0 @ RT-60, 2.0 @ RT-30
    mw = mw_cycles(cfg)

    lat, power, energy, banks_hist, mix = [], [], [], [], []
    for _ in range(n_frames):
        n = int(np.clip(rng.normal(prof.n_mean, prof.n_std), 4, cfg.N_max))
        queue = max(0, int(rng.normal(0.5, 0.8)))
        # Alg.1 line 9: D' to fit the budget in the worst (all-full) case
        banks = 1
        overhead = (HOST_OVERHEAD_CYCLES * window_scale
                    + n * ENCODER_CYCLES_PER_PROPOSAL * window_scale)
        for b in range(cfg.B, 0, -1):
            worst = aligner_cycles(n, 0, b * cfg.bank_dims, mw) + overhead
            if worst <= budget * cfg.clock_hz / (1.0 + queue):
                banks = b
                break
        d_eff = banks * cfg.bank_dims
        high = n >= cfg.N_hi or queue >= cfg.q_hi

        # wider windows decay coherence: rho_eff = rho ^ window_scale
        rho = np.clip(rng.normal(prof.rho_mean, prof.rho_std, n), -1, 1)
        rho_exp = 1.0 + 0.5 * (window_scale - 1.0)
        rho = np.sign(rho) * np.abs(rho) ** rho_exp
        new_obj = rng.random(n) < prof.churn * (1.0 + 0.5 * (window_scale - 1.0))
        rho = np.where(new_obj, rng.uniform(-0.1, 0.4, n), rho)
        delta = np.round((1 - rho) / 2 * d_eff).astype(int)

        path = path_mix(rho, delta, high, cfg)
        # reasoner gated on stable top-k: proxy with very high rho
        reasoner_active = (path != PATH_BYPASS) & (rho < 0.97)

        wc = window_cost(path, delta, banks, reasoner_active, n, cfg, budget,
                         window_scale)
        lat.append(wc.total_cycles / cfg.clock_hz)
        power.append(wc.power_w)
        energy.append(wc.energy_j)
        banks_hist.append(banks)
        mix.append([np.mean(path == p) for p in
                    (PATH_BYPASS, PATH_DELTA, PATH_FULL)])

    mix = np.array(mix)
    summary = latency_summary(np.array(lat), budget)
    summary.update({
        "task": task, "rt": rt,
        "power_w": float(np.mean(power)),
        "energy_mj": float(np.mean(energy) * 1e3),
        "banks_mean": float(np.mean(banks_hist)),
        "path_mix": {"bypass": float(mix[:, 0].mean()),
                     "delta": float(mix[:, 1].mean()),
                     "full": float(mix[:, 2].mean())},
    })
    return summary


def simulate_all(rt: str, n_frames: int = 600, seed: int = 0) -> list[dict]:
    return [simulate_task(t, rt, n_frames, seed) for t in TASK_PROFILES]
