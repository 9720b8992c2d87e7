"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero without
printing its result line):

  1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
     and the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, all at once);
  2. every kernel against its plain PyTorch version on the card, at the
     serving paths' shapes and at reduced, ragged and tied ones (bit-equal;
     ``sign_project_pack`` under its agreement rule), timed with CUDA events
     (median of 20 after warm-up) beside the plain version, a PyTorch
     library call where one exists, and the least time the card could take
     (``bound_ms``);
  3. serving at the edge config (``torr_edge()``) on the multi-stream
     step's default (prefix) lowering: 16 streams in 16 slots, 4 windows
     each of the traffic ``launch/serve.py`` serves (``simulate_sequence``
     with up to N_max proposals), features -> ``ops.encode_packed`` on the
     card -> ``StreamEngine.submit`` -> ``step`` -> ``sync``; the outputs,
     telemetry and final caches must be bit-equal to the same engine on the
     CPU (the plain versions);
  4. a reuse check on the same streams cut to K proposals per window (K is
     the cache depth): bypass and delta must occur after each stream's
     first window, and the card must again equal the CPU engine;
  5. the serial switch engine (``StreamEngine(serial=True)``: the
     ``fused_scores`` and ``delta_update`` kernels) on the served traffic,
     and the compact and auto engines (``fused="compact"``/``"auto"``: the
     ``packed_hamming_batched`` decide tables and the bucket scan) on both
     traffics, each bit-equal to the card's prefix engine of phase 3 or 4
     in every field but the lowering's own telemetry encodings; on the
     reuse traffic auto must reach the compact lowering;
  6. ``evaluate_task`` for the five TOOD tasks at the edge config on the
     card (AP@0.5 of TorR, dense and naive HDC, and TorR's path mix), one
     task's per-frame scores equal to the same run on the CPU.

Each path's kernel launches are counted from zero around that path's run
and must all be above zero. The line before the last is the per-kernel JSON
report; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and FP32 FLOP/s
# outside the tensor cores (an FMA is 2 operations)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# Integer issue rates of compute capability 9.0, per SM per clock (CUDA C++
# Programming Guide, throughput table of the arithmetic instructions): 64
# 32-bit integer adds, multiply-adds or bitwise ops, 16 population counts
INT32_PER_CLK, POPC_PER_CLK = 64, 16
REPS = 20
STREAMS, WINDOWS = 16, 4
# The auto engine's EWMA folds each step one dispatch late, from a cold
# 1.0: even with no full-path proposal after the first window it first
# picks a compact tier at the seventh window, so the reuse traffic runs
# longer than the served one
REUSE_WINDOWS = 10
CPU_WINDOWS = 4             # windows the CPU reference engines replay
SERIAL_WINDOWS = 2          # the serial engine serves the first windows
EVAL_FRAMES = 4             # frames per task of the evaluate_task phase


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=REPS, warmup=3) -> float:
    """Median CUDA-event time of ``fn`` in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, t_ops: float):
    """``(bound_ms, bound_by)`` from the bytes moved and the least seconds
    the operations take at their peak rate."""
    t_bytes = bytes_moved / PEAK_BYTES_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def phase_card():
    from repro_torch.device import smi

    log(smi("name,power.limit"))
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[build] {len(build.SIGNATURES)} kernels in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")


class Rates:
    """The card's integer issue rates: SMs at the highest SM clock."""

    def __init__(self):
        from repro_torch.device import smi

        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.clk = float(smi("clocks.max.sm").split()[0]) * 1e6  # "1980 MHz"
        log(f"[bound] {self.sms} SMs at {self.clk / 1e6:.0f} MHz")

    def popc_s(self, pairs: float) -> float:
        """Least seconds for ``pairs`` word pairs, each a xor, a popcount
        and an add: the slower of the popcount and the integer pipe."""
        return max(pairs / (self.sms * POPC_PER_CLK * self.clk),
                   2 * pairs / (self.sms * INT32_PER_CLK * self.clk))

    def int32_s(self, ops: float) -> float:
        return ops / (self.sms * INT32_PER_CLK * self.clk)


def _entry(name, source, replaces, err, ms, plain_ms, b, library_ms=None):
    log(f"[time] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms} ms, bound {b[0]:.4f} ms ({b[1]})")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                bound_by=b[1], library_ms=library_ms)


def _check(name, label, got, want):
    """Bit-equality of kernel outputs (a tensor or a tuple) with the plain
    version's; returns the largest absolute difference."""
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    log(f"[kernel] {name} {label}: max_abs_err {err}")
    if not all(bits_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} {label} != plain")
    return err


def phase_kernels(cfg, im_cuda):
    """Every kernel vs its plain version on the card, then timed."""
    from repro_torch.core import aligner, hdc
    from repro_torch.kernels import delta_update as du
    from repro_torch.kernels import fused_window as fw
    from repro_torch.kernels import ref
    from repro_torch.kernels import xnor_popcount_sim as xps

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(11)
    rates = Rates()
    report = {}

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    # bank_prefix_hamming: the hoisted S x N_max batch at full precision,
    # a reduced plan (planes=2, cap=4) through the column selection, and a
    # ragged shape
    S = STREAMS
    N, W = S * cfg.N_max, cfg.words
    q = words(N, W)
    im_w = im_cuda.packed
    M = im_w.shape[0]
    for label, (qq, hh, cap) in {
        "main": (q, im_w, cfg.B),
        "plan(planes=2,cap=4)": aligner._plan_columns_bank_major(
            q, im_cuda, 4, 2, cfg) + (4,),
        "ragged(N=37,M=1000)": (words(37, W), im_w[:1000], cfg.B),
    }.items():
        qq, hh = qq.contiguous(), hh.contiguous()
        err = _check("bank_prefix_hamming", label,
                     fw.bank_prefix_hamming(qq, hh, cap=cap),
                     ref.bank_prefix_hamming_ref(qq, hh, cap=cap))
        if label == "main":
            main_err = err
    # each input read once, the [N, M, cap] counts written once
    report["bank_prefix_hamming"] = _entry(
        "bank_prefix_hamming",
        "src/repro_torch/kernels/csrc/bank_prefix_hamming.cu",
        "src/repro/kernels/fused_window.py:253", main_err,
        cuda_ms(lambda: fw.bank_prefix_hamming(q, im_w, cap=cfg.B)),
        cuda_ms(lambda: ref.bank_prefix_hamming_ref(q, im_w, cap=cfg.B)),
        bound(4 * (N * W + M * W + N * M * cfg.B), rates.popc_s(N * M * W)))

    # fused_scores: one window's proposals against the item memory at the
    # switch path's widest plan (b = 8 banks) and a reduced one (b = 2),
    # a ragged shape, and an item memory of duplicated rows (every row's
    # maximum tied: the first copy must win and top2[1] == top2[0])
    Nw = cfg.N_max
    qw = words(Nw, W)
    dup = torch.cat([im_w[:M // 2], im_w[:M // 2]]).contiguous()
    for label, (qq, hh) in {
        "main(b=8)": (qw, im_w),
        "reduced(b=2)": (qw[:, :2 * cfg.bank_words].contiguous(),
                         im_w[:, :2 * cfg.bank_words].contiguous()),
        "ragged(N=37,M=1000,W=96)": (words(37, 96),
                                     im_w[:1000, :96].contiguous()),
        "tied(duplicated rows)": (qw, dup),
    }.items():
        d_eff = 32 * qq.shape[1]
        got = fw.fused_scores(qq, hh, d_eff=d_eff)
        err = _check("fused_scores", label, got,
                     ref.fused_scores_ref(qq, hh, d_eff=d_eff))
        if label.startswith("tied"):
            if not (bool((got[1] < M // 2).all())
                    and torch.equal(got[2][:, 0], got[2][:, 1])):
                raise AssertionError("fused_scores: ties not resolved to "
                                     "the first copy")
        if label.startswith("main"):
            main_err = err
    report["fused_scores"] = _entry(
        "fused_scores", "src/repro_torch/kernels/csrc/fused_scores.cu",
        "src/repro/kernels/fused_window.py:141", main_err,
        cuda_ms(lambda: fw.fused_scores(qw, im_w, d_eff=cfg.D)),
        cuda_ms(lambda: ref.fused_scores_ref(qw, im_w, d_eff=cfg.D)),
        bound(4 * (Nw * W + M * W + Nw * M + 3 * Nw),
              rates.popc_s(Nw * M * W)))

    # delta_update: one proposal of every stream (L = 16 rows of the
    # delta budget), half of each row padding, every fifth row all padding;
    # and a ragged M (no vector loads)
    L, Kb, D = S, cfg.delta_budget, cfg.D
    dmajor = im_cuda.dmajor
    acc = torch.randint(-4000, 4000, (L, M), generator=gen,
                        dtype=torch.int32).to(dev)
    idx = torch.randint(0, D, (L, Kb), generator=gen,
                        dtype=torch.int32).to(dev)
    wts = (torch.randint(0, 2, (L, Kb), generator=gen,
                         dtype=torch.int32) * 4 - 2)
    wts[:, Kb // 2:] = 0
    wts[::5] = 0
    wts = wts.to(dev)
    dm_r = dmajor[:, :1001].contiguous()
    for label, args in {
        "main(L=16,budget=2048)": (acc, dmajor, idx, wts),
        "ragged(M=1001)": (acc[:, :1001].contiguous(), dm_r, idx, wts),
    }.items():
        err = _check("delta_update", label, du.delta_update(*args),
                     ref.delta_update_ref(*args))
        if label.startswith("main"):
            main_err = err
    # bytes: the distinct dmajor rows the nonzero weights need, idx and w,
    # acc in and out; operations: one multiply-add per nonzero entry and
    # column on the 64-wide integer pipe
    nz = wts != 0
    rows = int(torch.unique(idx[nz]).numel())
    report["delta_update"] = _entry(
        "delta_update", "src/repro_torch/kernels/csrc/delta_update.cu",
        "src/repro/kernels/delta_update.py:37", main_err,
        cuda_ms(lambda: du.delta_update(acc, dmajor, idx, wts)),
        cuda_ms(lambda: ref.delta_update_ref(acc, dmajor, idx, wts)),
        bound(rows * M + 8 * L * Kb + 8 * L * M,
              rates.int32_s(int(nz.sum()) * M)))

    # packed_hamming_batched: the batched decide pass's two tables per
    # step, proposals vs cache snapshot [16, 128] x [16, 8] and proposals
    # vs proposals [16, 128] x [16, 128], and a ragged shape
    qb = words(S, cfg.N_max, W)
    eb = words(S, cfg.K, W)
    for label, (qq, hh) in {
        f"snapshot([{S},{cfg.N_max}]x[{S},{cfg.K}])": (qb, eb),
        f"proposals([{S},{cfg.N_max}]x[{S},{cfg.N_max}])": (qb, qb),
        "ragged([3,37]x[3,5],W=40)": (words(3, 37, 40), words(3, 5, 40)),
    }.items():
        err = _check("packed_hamming_batched", label,
                     xps.packed_hamming_batched(qq, hh),
                     ref.packed_hamming_ref(qq, hh))
        if label.startswith("proposals"):
            main_err = err

    def both(fn):
        return lambda: (fn(qb, eb), fn(qb, qb))

    pairs = S * cfg.N_max * (cfg.K + cfg.N_max) * W
    report["packed_hamming_batched"] = _entry(
        "packed_hamming_batched",
        "src/repro_torch/kernels/csrc/packed_hamming_batched.cu",
        "src/repro/kernels/xnor_popcount_sim.py:130", main_err,
        cuda_ms(both(xps.packed_hamming_batched)),
        cuda_ms(both(ref.packed_hamming_ref)),
        bound(4 * (S * cfg.N_max * W + S * cfg.K * W + S * cfg.N_max * W
                   + S * cfg.N_max * (cfg.K + cfg.N_max)),
              rates.popc_s(pairs)))

    # sign_project_pack: one step's worth of proposals (S x N_max rows)
    d = cfg.feat_dim
    z = torch.randn((N, d), generator=gen).to(dev)
    R = (torch.randn((D, d), generator=gen) / np.sqrt(d)).to(dev)
    got = fw.sign_project_pack(z, R)
    want = ref.sign_project_pack_ref(z, R)
    torch.cuda.synchronize()
    rule = ref.sign_pack_disagreement(z, R, got, want)
    log(f"[kernel] sign_project_pack: z {tuple(z.shape)} R {tuple(R.shape)} "
        f"bits {rule['bits']} decided_differ {rule['decided_differ']} "
        f"undecided_differ {rule['undecided_differ']}")
    if not rule["ok"]:
        raise AssertionError(f"sign_project_pack breaks the agreement rule "
                             f"{rule}")
    code_err = int((hdc.unpack_bits(got, D).to(torch.int32)
                    - hdc.unpack_bits(want, D).to(torch.int32)).abs().max())
    # the one library call: the float32 product alone (cuBLAS, TF32 off);
    # no PyTorch call computes the signs and packs them
    report["sign_project_pack"] = _entry(
        "sign_project_pack",
        "src/repro_torch/kernels/csrc/sign_project_pack.cu",
        "src/repro/kernels/fused_window.py:382", code_err,
        cuda_ms(lambda: fw.sign_project_pack(z, R)),
        cuda_ms(lambda: ref.sign_project_pack_ref(z, R)),
        bound(4 * (N * d + D * d + N * D // 32), 2 * N * D * d / PEAK_FP32_S),
        library_ms=cuda_ms(lambda: torch.matmul(z, R.T)))
    return report


# --- serving ----------------------------------------------------------------

# the lowering encodings (core.types FUSED_IDS / DECIDE_IDS) each engine's
# telemetry must carry
FUSED_PREFIX, FUSED_SWITCH, FUSED_COMPACT = 2, 1, 3
DECIDE_BATCHED, DECIDE_NONE = 1, -1
LOWERING_FIELDS = ("fused_mode", "decide_mode", "bucket_tier")


def _serve_card(cfg, sys_, frames, report, label, steps=None, **engine_kw):
    """Serve ``frames`` (S streams in S slots) through an engine on the
    card: features -> ``encode_packed`` -> ``submit`` -> ``step`` ->
    ``sync`` (all of them, or the first ``steps``), with every kernel's
    launches counted from zero around the run. Returns the engine, its
    per-stream results, the state after each step, each step's packed
    words and the launch counts."""
    from repro_torch.kernels import build
    from repro_torch.perf.profile_step import encode_step, submit_step
    from repro_torch.serving.stream_engine import StreamEngine

    S, T = len(frames), len(frames[0])
    R = torch.as_tensor(sys_.R).cuda()
    eng = StreamEngine(cfg, sys_.im, n_slots=S, **engine_kw)
    eng.warmup()
    eng.sync()
    build.reset_launches()
    t0 = time.perf_counter()
    for s in range(S):
        eng.admit(f"cam{s}", sys_.task_w[s % sys_.task_w.shape[0]])
    words, states = [], []
    for t in range(T):    # one encode call per step's windows
        words.append(encode_step(frames, t, R))
        submit_step(eng, frames, t, words[-1])
    res = {f"cam{s}": [] for s in range(S)}
    # each stream's backlog is its queue depth
    while eng.busy and (steps is None or len(states) < steps):
        for sid, r in eng.step().items():
            res[sid].append(r)
        states.append(eng.state)
    eng.sync()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    log(f"[{label}] {torch.cuda.get_device_name(0)}: {eng.stats.windows} "
        f"windows in {wall:.3f} s = {eng.stats.windows / wall:.1f} "
        f"windows/s, {1e3 * wall / eng.stats.steps:.1f} ms/step (encode "
        f"included); launches {launches}")
    for name, n in launches.items():
        if name in report and "launches" not in report[name] and n > 0:
            report[name]["launches"] = n
    return eng, res, states, words, launches


def _require_launched(label, launches, names):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} was not launched")


def _path_mix(frames, res):
    """Valid proposals after each stream's first window, by path (pad
    proposals report bypass, so only valid ones count)."""
    from repro_torch.core.types import PATH_NAMES

    mix = dict.fromkeys(PATH_NAMES, 0)
    for s, fr in enumerate(frames):
        for t, (_, tel) in enumerate(res[f"cam{s}"][1:], start=1):
            path = tel.path.cpu().numpy()[fr[t].valid]
            for i, name in enumerate(PATH_NAMES):
                mix[name] += int((path == i).sum())
    return mix


def _assert_results_equal(label, res, ref_res, skip=()):
    """Per-stream outputs and telemetry bit-equal, field by field, for the
    windows ``res`` holds (``skip`` names telemetry fields checked apart)."""
    for sid, wins in res.items():
        for t, ((o, tel), (oc, telc)) in enumerate(zip(wins, ref_res[sid])):
            for obj, objc in ((o, oc), (tel, telc)):
                for f in dataclasses.fields(obj):
                    if f.name in skip:
                        continue
                    if not bits_equal(getattr(obj, f.name),
                                      getattr(objc, f.name)):
                        raise AssertionError(
                            f"{label} {sid} window {t}: "
                            f"{type(obj).__name__}.{f.name} differs")


def _assert_caches_equal(label, cache, ref_cache):
    for f in dataclasses.fields(cache):
        if not bits_equal(getattr(cache, f.name), getattr(ref_cache, f.name)):
            raise AssertionError(f"{label} final cache.{f.name} differs")


def _equal_to_cpu(cfg, sys_, frames, res, states, words, label, n):
    """The same engine on the CPU (plain versions), fed the card's packed
    words (the same backlog), must give bit-equal outputs, telemetry and
    caches over its first ``n`` steps."""
    from repro_torch.perf.profile_step import submit_step
    from repro_torch.serving.stream_engine import StreamEngine

    t0 = time.perf_counter()
    S = len(frames)
    cpu = StreamEngine(cfg, sys_.im, n_slots=S, device="cpu")
    for s in range(S):
        cpu.admit(f"cam{s}", sys_.task_w[s % sys_.task_w.shape[0]])
    for t, w in enumerate(words):
        submit_step(cpu, frames, t, w.cpu())
    res_cpu = {sid: [] for sid in res}
    for _ in range(n):
        for sid, r in cpu.step().items():
            res_cpu[sid].append(r)
    log(f"[{label}] cpu reference engine, {n} windows: "
        f"{time.perf_counter() - t0:.1f} s")
    for sid, wins in res_cpu.items():
        if len(wins) != n:
            raise AssertionError(f"{label} {sid}: {len(wins)} windows")
    _assert_results_equal(label, res_cpu, res)
    _assert_caches_equal(label, states[n - 1].cache, cpu.state.cache)
    log(f"[{label}] card engine == CPU engine over {n} windows: outputs, "
        f"telemetry and caches bit-equal")


def phase_serving(cfg, sys_, frames, report, label, cpu_windows):
    """The multi-stream step's default (prefix) lowering on the card, its
    first ``cpu_windows`` windows checked bit-equal to the CPU engine;
    returns its results and the state after each step for the other
    lowerings to be held to."""
    eng, res, states, words, launches = _serve_card(cfg, sys_, frames,
                                                    report, label)
    _require_launched(label, launches,
                      ("bank_prefix_hamming", "sign_project_pack"))
    n_valid = [int(f.valid.sum()) for fr in frames for f in fr]
    log(f"[{label}] valid proposals per window {min(n_valid)}-"
        f"{max(n_valid)} (cache depth K={cfg.K}); after each stream's first "
        f"window, by path: {_path_mix(frames, res)}")
    for sid, wins in res.items():
        if len(wins) != len(frames[0]):
            raise AssertionError(f"{label} {sid}: {len(wins)} windows")
        for out, tel in wins:
            if out.scores.shape != (cfg.N_max, cfg.M) or \
                    not bool(torch.isfinite(out.scores).all()):
                raise AssertionError(f"{sid}: bad scores")
            if int(tel.fused_mode) != FUSED_PREFIX:
                raise AssertionError(f"{sid}: fused_mode {tel.fused_mode}")
    _equal_to_cpu(cfg, sys_, frames, res, states, words, label, cpu_windows)
    return res, states


def phase_lowering(cfg, sys_, frames, report, label, base, kernels,
                   lowerings, n_windows=None, **engine_kw):
    """An engine on another lowering, held bit-equal to the card's prefix
    engine (``base`` = its results and per-step states) in every field but
    the lowering encodings, which must be one of ``lowerings`` (tuples of
    fused_mode, decide_mode, bucket tier or None for any compact tier),
    over the first ``n_windows`` steps (all by default). Returns the
    per-window encodings."""
    base_res, base_states = base
    eng, res, states, _words, launches = _serve_card(
        cfg, sys_, frames, report, label, steps=n_windows, **engine_kw)
    _require_launched(label, launches, kernels)
    _assert_results_equal(label, res, base_res, skip=LOWERING_FIELDS)
    _assert_caches_equal(label, eng.state.cache,
                         base_states[len(states) - 1].cache)
    rows = len(frames) * cfg.N_max
    seen = []                     # per step: every stream's encodings
    for t in range(len(states)):
        encs = {tuple(int(getattr(wins[t][1], f)) for f in LOWERING_FIELDS)
                for wins in res.values()}
        enc = encs.pop()
        if encs or not any(enc[:2] == low[:2] and (
                enc[2] == low[2] if low[2] is not None
                else 0 < enc[2] < rows) for low in lowerings):
            raise AssertionError(f"{label} step {t}: lowering encodings "
                                 f"{encs | {enc}} not one of {lowerings}")
        seen.append(enc)
    log(f"[{label}] == card prefix engine in every field; lowering "
        f"(fused, decide, tier) per step: {seen}; path mix after the first "
        f"windows: {_path_mix(frames, res)}")
    return seen


def phase_evaluate(cfg, world, sys_):
    """evaluate_task for the five tasks on the card; one task's per-frame
    scores and telemetry equal to the same run on the CPU."""
    from repro_torch.data import tood_synth as ts
    from repro_torch.kernels import build
    from repro_torch.serving import tood_pipelines as tp

    build.reset_launches()
    t0 = time.perf_counter()
    results = [tp.evaluate_task(world, sys_, t, n_frames=EVAL_FRAMES, seed=0)
               for t in range(len(ts.TASKS))]
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    log(f"[evaluate] {len(results)} tasks x {EVAL_FRAMES} frames on the "
        f"card in {time.perf_counter() - t0:.1f} s; launches {launches}")
    _require_launched("evaluate", launches,
                      ("fused_scores", "delta_update", "sign_project_pack"))
    for r in results:
        mix = {k: round(v, 4) for k, v in r["path_mix"].items()}
        log(f"[evaluate] {r['task']}: AP@0.5 torr {r['ap_torr']:.2f} dense "
            f"{r['ap_dense']:.2f} naive_hdc {r['ap_naive_hdc']:.2f}; path "
            f"mix {mix}")
        if not all(np.isfinite([r["ap_torr"], r["ap_dense"],
                                r["ap_naive_hdc"]])):
            raise AssertionError(f"{r['task']}: AP not finite")
    t0 = time.perf_counter()
    frames = ts.simulate_sequence(world, 0, EVAL_FRAMES, 0,
                                  n_max=cfg.N_max)
    scores, tels = tp.run_torr(sys_, frames, 0, device="cpu")
    for t in range(EVAL_FRAMES):
        if not np.array_equal(scores[t].view(np.int32),
                              results[0]["scores"][t].view(np.int32)):
            raise AssertionError(f"evaluate task 0 frame {t}: scores differ "
                                 "between the card and the CPU")
        for f in dataclasses.fields(tels[t]):
            if not bits_equal(getattr(tels[t], f.name),
                              getattr(results[0]["telemetry"][t], f.name)):
                raise AssertionError(f"evaluate task 0 frame {t}: "
                                     f"telemetry {f.name} differs")
    log(f"[evaluate] task 0 on the CPU ({time.perf_counter() - t0:.1f} s): "
        f"per-frame scores and telemetry bit-equal to the card's")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.torr_edge import torr_edge
    from repro_torch.data import tood_synth as ts
    from repro_torch.perf.profile_step import edge_windows
    from repro_torch.serving import tood_pipelines as tp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    cfg = torr_edge()
    world = ts.make_world(0, M=cfg.M, d=cfg.feat_dim, n_tasks=5)
    sys_ = tp.build_system(world, cfg, torch.Generator().manual_seed(0))
    report = phase_kernels(cfg, sys_.im.to("cuda"))

    served = edge_windows(world, cfg, STREAMS, WINDOWS, cfg.N_max)
    reuse = edge_windows(world, cfg, STREAMS, REUSE_WINDOWS, cfg.K)
    base = phase_serving(cfg, sys_, served, report, "serve", CPU_WINDOWS)
    base_reuse = phase_serving(cfg, sys_, reuse, report,
                               f"reuse, windows cut to K={cfg.K} proposals",
                               CPU_WINDOWS)
    mix = _path_mix(reuse, base_reuse[0])
    if mix["bypass"] <= 0 or mix["delta"] <= 0:
        raise AssertionError("reuse traffic: no bypass or no delta after "
                             "the first windows")

    switch = (FUSED_SWITCH, DECIDE_NONE, 0)
    compact = (FUSED_COMPACT, DECIDE_BATCHED, None)
    prefix = (FUSED_PREFIX, DECIDE_NONE, 0)
    phase_lowering(cfg, sys_, served, report, "serial switch", base,
                   ("fused_scores", "delta_update"), (switch,),
                   n_windows=SERIAL_WINDOWS, serial=True)
    full_tier = (FUSED_COMPACT, DECIDE_BATCHED, STREAMS * cfg.N_max)
    compact_kernels = ("packed_hamming_batched", "bank_prefix_hamming")
    for traffic, b, frames in (("served", base, served),
                               ("reuse", base_reuse, reuse)):
        phase_lowering(cfg, sys_, frames, report, f"compact, {traffic}", b,
                       compact_kernels, (full_tier,), fused="compact")
        seen = phase_lowering(cfg, sys_, frames, report, f"auto, {traffic}",
                              b, ("bank_prefix_hamming",),
                              (prefix, compact), fused="auto")
        if traffic == "reuse" and not any(e[0] == FUSED_COMPACT
                                          for e in seen):
            raise AssertionError("auto never reached the compact lowering "
                                 "on the reuse traffic")
    phase_evaluate(cfg, world, sys_)
    missing = [n for n, r in report.items() if "launches" not in r]
    if missing:
        raise AssertionError(f"never launched on a path: {missing}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
