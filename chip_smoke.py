"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero without
printing its result line):

  1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
     and the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, all at once);
  2. every kernel against its plain PyTorch version on the card, at the
     serving paths' shapes and at reduced, ragged and tied ones (bit-equal;
     the two encodes under their agreement rule with no decided code
     differing, at 8, N_max and S x N_max rows and at a ragged shape whose
     all-zero and NaN rows must equal the plain version exactly), timed
     with CUDA events (median of 20 after warm-up) beside the plain
     version, a PyTorch library call where one exists, and the least time
     the card could take (``bound_ms``); the encodes, and their library
     call torch.matmul(z, R.T), also as device time per call from a CUDA
     graph of 20 calls (their ``ms``), with a 3xTF32 and an FP32 bound at
     each of the three row counts;
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
     task's per-frame scores and telemetry equal to the same run on the CPU
     fed the card's packed queries, which are held to the CPU's encode by
     the agreement rule;
  7. the int8 encode entry point ``ops.sign_project`` (the
     ``sign_project`` kernel) on one step's proposal features and at its
     benchmark caller's shape, held to the plain version by the agreement
     rule;
  8. the plan ladder: every level of ``build_ladder(torr_edge())`` latched
     with ``StreamEngine.set_plan`` on the prefix and compact engines (16
     streams, 2 windows each of both traffics, every step timed), and on
     the switch lowering of ``torr_window_step(plan=)`` for one stream;
     every lowering bit-equal to the card's prefix engine under the same
     plan, the telemetry's planes and bank cap checked, and the card's
     prefix engine equal to the CPU engine at two levels over the reuse
     windows;
  9. a governed run: the compact engine at RT-60 under a ``Governor`` fed
     by a ``DeadlineTracker`` and ``telemetry_cost``, one plan per step
     (the async engine's dispatch loop, written out on the host), then its
     ``plan_log`` replayed with ``set_plan`` on a fresh prefix engine,
     bit-equal;
 10. the device-idle share of every level and lowering of phase 8 on the
     served traffic (its second window again, under ``torch.profiler``),
     last, because a profiled step slows the steps after it.

Each path's kernel launches are counted from zero around that path's run
and must all be above zero. Each phase's seconds are logged as
``[phase]`` lines. The plan-ladder rows (ms/step, windows/s, idle share)
and the per-kernel report are printed as JSON before the last line, which
is ``{"ok": true, "device": {...}}``.
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

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, FP32 FLOP/s
# outside the tensor cores (an FMA is 2 operations) and TF32 FLOP/s on them
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_TF32_S = 495e12        # dense, on the tensor cores
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
PLAN_WINDOWS = 2            # windows per stream of each plan-ladder run
# ladder levels, as (banks, planes), at which the card's prefix engine is
# held to the CPU engine; (1, 1) carries the tau offsets
PLAN_CPU_LEVELS = ((8, 2), (1, 1))
GOVERNED_RT = "RT-60"


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


def device_ms(fn, calls=20, reps=10) -> float:
    """Device time of one call of ``fn`` in ms: ``calls`` calls captured
    back to back in one CUDA graph, the graph replayed ``reps`` times
    between CUDA events (median), so the host's time between the calls
    (wrapper, launch) is not counted. Inputs stay in L2 between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
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
    from repro_torch.core import aligner, item_memory
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
    # reduced plans through the column selection — (cap=4, planes=2), the
    # ladder's (8, 1) (pmajor blocks, 64 words) and (1, 1) (8 words) — and
    # a ragged shape
    S = STREAMS
    N, W = S * cfg.N_max, cfg.words
    q = words(N, W)
    im_w = im_cuda.packed
    M = im_w.shape[0]

    def plan_cols(qq, cap, planes):
        return tuple(x.contiguous() for x in aligner._plan_columns_bank_major(
            qq, im_cuda, cap, planes, cfg))

    for label, (qq, hh, cap) in {
        "main": (q, im_w, cfg.B),
        "plan(planes=2,cap=4)": plan_cols(q, 4, 2) + (4,),
        "plan(8,1): W=64, cap=8": plan_cols(q, 8, 1) + (8,),
        "plan(1,1): W=8, cap=1": plan_cols(q, 1, 1) + (1,),
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
    # switch path's widest plan (b = 8 banks), reduced ones (b = 2; the
    # ladder's (4, 1) and (1, 1), 32 and 8 words), a ragged shape, and an
    # item memory of duplicated rows (every row's maximum tied: the first
    # copy must win and top2[1] == top2[0])
    Nw = cfg.N_max
    qw = words(Nw, W)
    dup = torch.cat([im_w[:M // 2], im_w[:M // 2]]).contiguous()
    for label, (qq, hh) in {
        "main(b=8)": (qw, im_w),
        "reduced(b=2)": (qw[:, :2 * cfg.bank_words].contiguous(),
                         im_w[:, :2 * cfg.bank_words].contiguous()),
        "plan(4,1): W=32": plan_cols(qw, 4, 1),
        "plan(1,1): W=8": plan_cols(qw, 1, 1),
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
    # vs proposals [16, 128] x [16, 128], both also pre-masked by the
    # ladder's (1, 1) plan (ops.masked_hamming_all zeroes disabled words),
    # and a ragged shape
    qb = words(S, cfg.N_max, W)
    eb = words(S, cfg.K, W)
    wm = item_memory.plan_word_mask(cfg, 1, 1, dev)
    qm, em = torch.where(wm, qb, 0), torch.where(wm, eb, 0)
    for label, (qq, hh) in {
        f"snapshot([{S},{cfg.N_max}]x[{S},{cfg.K}])": (qb, eb),
        f"proposals([{S},{cfg.N_max}]x[{S},{cfg.N_max}])": (qb, qb),
        "snapshot, plan(1,1) mask": (qm, em),
        "proposals, plan(1,1) mask": (qm, qm),
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

    report.update(_encode_kernels(cfg, gen, dev, N))
    return report


def _encode_bounds(n, d, D, out_bytes):
    """(3xTF32 bound, FP32-FMA bound) of sign(z @ R.T) for n rows: z and R
    read once, the codes written once; the 3xTF32 product is three TF32
    products on the tensor cores, the FP32 one an FMA (2 operations) per
    term on the CUDA cores."""
    moved = 4 * (n * d + D * d) + out_bytes
    return (bound(moved, 3 * 2 * n * D * d / PEAK_TF32_S),
            bound(moved, 2 * n * D * d / PEAK_FP32_S))


def _encode_kernels(cfg, gen, dev, N):
    """sign_project_pack and sign_project: the agreement rule (no decided
    code may differ) at every timed shape and at a ragged one whose all-zero
    and NaN rows must equal the plain version exactly; one launch per call;
    then each timed at 8 rows (the benchmark caller's), N_max rows (one
    window) and N (one engine step, the main shape) beside the plain
    version, the FP32 product torch.matmul(z, R.T) (TF32 off) and both
    bounds."""
    from repro_torch.core import hdc
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_window as fw
    from repro_torch.kernels import ref
    from repro_torch.kernels import sign_project as sp

    d, D = cfg.feat_dim, cfg.D
    rows = (8, cfg.N_max, N)
    z = torch.randn((N, d), generator=gen).to(dev)
    R = (torch.randn((D, d), generator=gen) / np.sqrt(d)).to(dev)
    zr = torch.randn((37, d), generator=gen).to(dev)
    zr[5] = 0.0                      # y = +-0: every code +1
    zr[9, 100] = float("nan")        # y NaN: every code -1
    Rr = R[:8160].contiguous()
    kernels = {
        "sign_project_pack": dict(
            fn=fw.sign_project_pack, plain=ref.sign_project_pack_ref,
            rule=ref.sign_pack_disagreement, out_bytes=lambda n: n * D // 8,
            codes=lambda w, DD: hdc.unpack_bits(w, DD).to(torch.int32),
            replaces="src/repro/kernels/fused_window.py:382"),
        "sign_project": dict(
            fn=sp.sign_project, plain=ref.sign_project_ref,
            rule=ref.sign_disagreement, out_bytes=lambda n: n * D,
            codes=lambda c, DD: c.to(torch.int32),
            replaces="src/repro/kernels/sign_project.py:30"),
    }
    report = {}
    for name, k in kernels.items():
        shapes = {f"N={n}": (z[:n].contiguous(), R) for n in rows}
        shapes["ragged(N=37,D=8160), zero row 5, NaN row 9"] = (zr, Rr)
        errs = {}
        for label, (zz, RR) in shapes.items():
            before = build.LAUNCHES[name]
            got = k["fn"](zz, RR)
            if build.LAUNCHES[name] != before + 1:
                raise AssertionError(f"{name} {label}: "
                                     f"{build.LAUNCHES[name] - before} "
                                     f"launches for one call")
            want = k["plain"](zz, RR)
            torch.cuda.synchronize()
            rule = k["rule"](zz, RR, got, want)
            err = int((k["codes"](got, RR.shape[0])
                       - k["codes"](want, RR.shape[0])).abs().max())
            errs[label] = err
            log(f"[kernel] {name} {label}: bits {rule['bits']} "
                f"decided_differ {rule['decided_differ']} undecided_differ "
                f"{rule['undecided_differ']} max_abs_err {err}")
            if not rule["ok"] or rule["decided_differ"] != 0 or \
                    got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name} {label} breaks the agreement "
                                     f"rule {rule}")
            if label.startswith("ragged"):
                for row in (5, 9):
                    if not torch.equal(got[row], want[row]):
                        raise AssertionError(f"{name}: row {row} differs "
                                             "from the plain version")
        by_n = {}
        for n in rows:
            zz = z[:n].contiguous()
            b, b32 = _encode_bounds(n, d, D, k["out_bytes"](n))
            fn, plain = k["fn"], k["plain"]
            t = dict(
                ms=device_ms(lambda: fn(zz, R)),
                call_ms=cuda_ms(lambda: fn(zz, R)),
                plain_ms=cuda_ms(lambda: plain(zz, R)),
                library_ms=device_ms(lambda: torch.matmul(zz, R.T)),
                library_call_ms=cuda_ms(lambda: torch.matmul(zz, R.T)),
                bound_ms=b[0], bound_by=b[1], bound_fp32_ms=b32[0],
                bound_fp32_by=b32[1])
            by_n[n] = t
            log(f"[time] {name}(N={n}): kernel {t['ms']:.4f} ms on the device "
                f"({t['call_ms']:.4f} ms for one call with its host time), "
                f"torch.matmul {t['library_ms']:.4f} ms "
                f"({t['library_call_ms']:.4f}), plain {t['plain_ms']:.4f} ms, "
                f"bound {t['bound_ms']:.4f} ms 3xTF32 ({t['bound_by']}), "
                f"{t['bound_fp32_ms']:.4f} ms FP32 ({t['bound_fp32_by']}); "
                f"kernel / matmul {t['ms'] / t['library_ms']:.3f}")
        main = by_n[N]
        report[name] = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=k["replaces"], max_abs_err=errs[f"N={N}"],
            **{key: main[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "call_ms", "library_call_ms", "bound_fp32_ms")},
            by_rows={str(n): t for n, t in by_n.items()})
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


def _equal_to_cpu(cfg, sys_, frames, res, states, words, label, n,
                  plan=None):
    """The same engine on the CPU (plain versions), fed the card's packed
    words (the same backlog) under the same latched ``plan``, must give
    bit-equal outputs, telemetry and caches over its first ``n`` steps."""
    from repro_torch.perf.profile_step import submit_step
    from repro_torch.serving.stream_engine import StreamEngine

    t0 = time.perf_counter()
    S = len(frames)
    cpu = StreamEngine(cfg, sys_.im, n_slots=S, device="cpu")
    cpu.set_plan(plan)
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
    scores and telemetry equal to the same run on the CPU fed the card's
    packed queries."""
    from repro_torch.data import tood_synth as ts
    from repro_torch.kernels import build, ops, ref
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
    # task 0 again on the CPU, fed the card's packed queries (the encode
    # is held to the CPU's by its agreement rule, not bit for bit: a code
    # whose |y| is within rounding of zero may differ), the rest of the
    # pipeline bit for bit
    t0 = time.perf_counter()
    frames = ts.simulate_sequence(world, 0, EVAL_FRAMES, 0,
                                  n_max=cfg.N_max)
    R = torch.from_numpy(np.array(sys_.R, np.float32))
    words = []
    for t, f in enumerate(frames):
        card = ops.encode_packed(f.feats, R.cuda()).cpu()
        z = torch.from_numpy(np.array(f.feats, np.float32))
        rule = ref.sign_pack_disagreement(
            z, R, card, ops.encode_packed(f.feats, R, device="cpu"))
        log(f"[evaluate] task 0 frame {t} encode, card vs CPU: "
            f"decided_differ {rule['decided_differ']} undecided_differ "
            f"{rule['undecided_differ']} of {rule['bits']}")
        if not rule["ok"] or rule["decided_differ"]:
            raise AssertionError(f"evaluate task 0 frame {t}: the card's "
                                 f"encode breaks the agreement rule {rule}")
        words.append(card)
    scores, tels = tp.run_torr(sys_, frames, 0, device="cpu", words=words)
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
    log(f"[evaluate] task 0 on the CPU from the card's encodes "
        f"({time.perf_counter() - t0:.1f} s): per-frame scores and telemetry "
        f"bit-equal to the card's")


def phase_sign_project(sys_, frames, report):
    """The int8 encode entry point ``ops.sign_project`` on the first step's
    proposal features of every stream (S x N_max rows) and at its
    benchmark caller's shape (8 rows), with its launches counted; held to
    the plain version by the agreement rule. No serving path runs it."""
    from repro_torch.kernels import build, ops, ref

    R = torch.as_tensor(sys_.R).cuda()
    feats = np.stack([fr[0].feats for fr in frames])
    feats = feats.reshape(-1, feats.shape[-1])
    build.reset_launches()
    codes = [ops.sign_project(x, R) for x in (feats, feats[:8])]
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    _require_launched("sign_project entry", launches, ("sign_project",))
    report["sign_project"]["launches"] = launches["sign_project"]
    for x, c in zip((feats, feats[:8]), codes):
        z = torch.from_numpy(np.array(x, np.float32)).cuda()
        rule = ref.sign_disagreement(z, R, c, ref.sign_project_ref(z, R))
        log(f"[sign_project entry] ops.sign_project {tuple(c.shape)} int8: "
            f"decided_differ {rule['decided_differ']} undecided_differ "
            f"{rule['undecided_differ']}")
        if not rule["ok"]:
            raise AssertionError(f"ops.sign_project breaks the agreement "
                                 f"rule {rule}")
    log(f"[sign_project entry] launches {launches}")


def _device_busy_ms(fn) -> float:
    """Run ``fn`` (work that ends in a synchronize) under torch.profiler,
    device activity only, and return the summed duration of its device
    events in ms. The raw kineto events are summed as they come: building
    the profiler's Python event tree (``key_averages``, which gives the same
    total) costs seconds for a step of 31k launches."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    return busy


def _timed_steps(n, one, profile):
    """Run ``one(t)`` for t < n, timing each on the host clock (``one``
    ends in a synchronize); with ``profile`` the last run is under
    torch.profiler instead and gives only the device busy ms."""
    step_ms, busy = [], None
    for t in range(n):
        if profile and t == n - 1:
            busy = _device_busy_ms(lambda: one(t))
        else:
            t0 = time.perf_counter()
            one(t)
            step_ms.append(1e3 * (time.perf_counter() - t0))
    return step_ms, busy


def _serve_words(cfg, sys_, frames, words, plan, profile, **engine_kw):
    """Serve pre-encoded ``words`` (one [S x N_max, W] tensor per window,
    all submitted first) through an engine on the card with ``plan``
    latched, launches counted from zero. Returns its results, the state
    after each step, the launches, the host ms of each timed step and the
    device busy ms of the profiled one (see :func:`_timed_steps`)."""
    from repro_torch.kernels import build
    from repro_torch.perf.profile_step import submit_step
    from repro_torch.serving.stream_engine import StreamEngine

    S = len(frames)
    eng = StreamEngine(cfg, sys_.im, n_slots=S, **engine_kw)
    eng.set_plan(plan)
    eng.warmup()
    for s in range(S):
        eng.admit(f"cam{s}", sys_.task_w[s % sys_.task_w.shape[0]])
    for t, w in enumerate(words):
        submit_step(eng, frames, t, w)
    res = {f"cam{s}": [] for s in range(S)}
    states = []

    def one(_t):
        for sid, r in eng.step().items():
            res[sid].append(r)
        eng.sync()
        states.append(eng.state)

    build.reset_launches()
    step_ms, busy = _timed_steps(len(words), one, profile)
    return res, states, dict(build.LAUNCHES), step_ms, busy


def _switch_stream(cfg, sys_, frames, words, plan, profile):
    """Stream 0 of ``words`` through ``torr_window_step(fused="switch",
    plan=plan)`` on the card, with the queue depth the engine gives it
    (its backlog after the pop); launches counted from zero."""
    from repro_torch.core import pipeline
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    im = sys_.im.to(resolve_device())
    T, n = len(words), cfg.N_max
    st = pipeline.init_state(cfg, sys_.task_w[0])
    res = []

    def one(t):
        nonlocal st
        fr = frames[0][t]
        st, out, tel = pipeline.torr_window_step(
            st, im, words[t][:n], fr.valid, fr.boxes, T - 1 - t, cfg,
            plan=plan, fused="switch")
        res.append((out, tel))
        torch.cuda.synchronize()

    build.reset_launches()
    step_ms, busy = _timed_steps(T, one, profile)
    return st, res, dict(build.LAUNCHES), step_ms, busy


def _check_plan_windows(label, res, plan, encoding):
    """Every window ran the plan's planes within its bank cap, with
    finite scores, and records the lowering ``encoding``."""
    for sid, wins in res.items():
        for t, (out, tel) in enumerate(wins):
            got = tuple(int(getattr(tel, f)) for f in LOWERING_FIELDS)
            if int(tel.planes) != plan.planes or \
                    int(tel.banks) > plan.banks or got != encoding or \
                    not bool(torch.isfinite(out.scores).all()):
                raise AssertionError(
                    f"{label} {sid} window {t}: planes {int(tel.planes)}, "
                    f"banks {int(tel.banks)}, lowering {got}")


# the plan ladder's engines: name, engine knobs, the kernels each must
# launch, and its (fused_mode, decide_mode) telemetry encoding
PLAN_LOWERINGS = (
    ("prefix", {}, ("bank_prefix_hamming",), (FUSED_PREFIX, DECIDE_NONE)),
    ("compact", dict(fused="compact"),
     ("packed_hamming_batched", "bank_prefix_hamming"),
     (FUSED_COMPACT, DECIDE_BATCHED)))


def phase_plans(cfg, sys_, served, reuse):
    """Every level of the edge ladder on the prefix, compact and switch
    lowerings, both traffics, each step timed (see the module docstring,
    phase 8). Returns one row per (traffic, level, lowering)."""
    from repro_torch.control import build_ladder
    from repro_torch.core.types import map_tensors
    from repro_torch.perf.profile_step import encode_step

    ladder = build_ladder(cfg)
    R = torch.as_tensor(sys_.R).cuda()
    S = len(served)
    rows = []
    T = PLAN_WINDOWS
    for traffic, frames in (("served", served), ("reuse", reuse)):
        frames = [fr[:T] for fr in frames]
        words = [encode_step(frames, t, R) for t in range(T)]
        for level, plan in enumerate(ladder):
            tag = f"plan {level} ({plan.banks},{plan.planes}) {traffic}"
            runs = {}
            for low, kw, kernels, enc in PLAN_LOWERINGS:
                tier = S * cfg.N_max if low == "compact" else 0
                res, states, launches, ms, _busy = _serve_words(
                    cfg, sys_, frames, words, plan, False, **kw)
                _require_launched(f"{tag} {low}", launches, kernels)
                _check_plan_windows(f"{tag} {low}", res, plan, enc + (tier,))
                runs[low] = (res, states, ms, S)
            base_res, base_states = runs["prefix"][:2]
            res, states = runs["compact"][:2]
            _assert_results_equal(f"{tag} compact", res, base_res,
                                  skip=LOWERING_FIELDS)
            _assert_caches_equal(f"{tag} compact", states[-1].cache,
                                 base_states[-1].cache)
            st, res_sw, launches, ms, _busy = _switch_stream(
                cfg, sys_, frames, words, plan, False)
            _require_launched(f"{tag} switch", launches,
                              ("fused_scores", "delta_update"))
            _check_plan_windows(f"{tag} switch", {"cam0": res_sw}, plan,
                                (FUSED_SWITCH, DECIDE_NONE, 0))
            _assert_results_equal(f"{tag} switch", {"cam0": res_sw},
                                  base_res, skip=LOWERING_FIELDS)
            _assert_caches_equal(f"{tag} switch", st.cache, map_tensors(
                lambda x: x[0], base_states[-1].cache))
            runs["switch"] = (res_sw, None, ms, 1)
            for low, (_r, _s, ms, wins) in runs.items():
                row = dict(traffic=traffic, level=level, banks=plan.banks,
                           planes=plan.planes, lowering=low, ms_per_step=ms,
                           windows_per_s=1e3 * wins / statistics.median(ms),
                           device_busy_ms=None, idle_share=None)
                rows.append(row)
                log(f"[{tag} {low}] {wins} windows/step: ms/step "
                    f"{[round(x, 2) for x in ms]} = "
                    f"{row['windows_per_s']:.1f} windows/s")
            log(f"[{tag}] compact and switch == card prefix engine in every "
                f"field; path mix after the first window "
                f"{_path_mix(frames, base_res)}")
            if traffic == "reuse" and \
                    (plan.banks, plan.planes) in PLAN_CPU_LEVELS:
                _equal_to_cpu(cfg, sys_, frames, base_res, base_states,
                              words, tag, T, plan=plan)
    return rows


def phase_plan_idle(cfg, sys_, served, rows):
    """The device-idle share of every (level, lowering) on the served
    traffic: the same two windows again on a fresh engine, the second
    under torch.profiler, its device busy time against the second
    window's host time in :func:`phase_plans`. It runs after every timed
    phase, since a profiled step slows the untraced steps after it."""
    from repro_torch.control import build_ladder
    from repro_torch.perf.profile_step import encode_step

    R = torch.as_tensor(sys_.R).cuda()
    frames = [fr[:PLAN_WINDOWS] for fr in served]
    words = [encode_step(frames, t, R) for t in range(PLAN_WINDOWS)]
    row_of = {(r["level"], r["lowering"]): r for r in rows
              if r["traffic"] == "served"}
    for level, plan in enumerate(build_ladder(cfg)):
        busy = {low: _serve_words(cfg, sys_, frames, words, plan, True,
                                  **kw)[-1]
                for low, kw, _k, _e in PLAN_LOWERINGS}
        busy["switch"] = _switch_stream(cfg, sys_, frames, words, plan,
                                        True)[-1]
        for low, b in busy.items():
            row = row_of[(level, low)]
            row["device_busy_ms"] = b
            row["idle_share"] = 1.0 - b / row["ms_per_step"][-1]
        log(f"[plan {level} ({plan.banks},{plan.planes}) served idle] "
            + "; ".join(f"{low}: device busy {b:.2f} ms of "
                        f"{row_of[(level, low)]['ms_per_step'][-1]:.2f} ms, "
                        f"idle {row_of[(level, low)]['idle_share']:.4f}"
                        for low, b in busy.items()))


def phase_governed(cfg, sys_, frames):
    """The compact engine under the QoS governor at RT-60 (phase 9): each
    step the tightest window's slack, the tracker's step EMA and the
    backlog pick the plan; each served window's modeled energy feeds the
    governor back. Then the plan log replayed on a fresh prefix engine."""
    from repro_torch.configs.torr_edge import rt_budget_s
    from repro_torch.control import Governor, build_ladder, policy_for
    from repro_torch.kernels import build
    from repro_torch.perf.cycle_model import telemetry_cost
    from repro_torch.perf.profile_step import encode_step, submit_step
    from repro_torch.serving import deadline
    from repro_torch.serving.stream_engine import StreamEngine

    S, T = len(frames), len(frames[0])
    budget = rt_budget_s(GOVERNED_RT)
    R = torch.as_tensor(sys_.R).cuda()
    words = [encode_step(frames, t, R) for t in range(T)]
    tracker = deadline.DeadlineTracker(deadline.policy_for(GOVERNED_RT))
    gov = Governor(cfg, policy_for(GOVERNED_RT))

    def engine(**kw):
        eng = StreamEngine(cfg, sys_.im, n_slots=S, **kw)
        eng.warmup()
        for s in range(S):
            eng.admit(f"cam{s}", sys_.task_w[s % sys_.task_w.shape[0]])
        for t, w in enumerate(words):
            submit_step(eng, frames, t, w)
        return eng

    eng = engine(fused="compact")
    # window t of every stream left the camera at frame time t
    t0 = tracker.now()
    arrival = [t0 + t * budget for t in range(T)]
    res = {f"cam{s}": [] for s in range(S)}
    step_ms = []
    build.reset_launches()
    for t in range(T):
        slack = budget - (tracker.now() - arrival[t])
        eng.set_plan(gov.update(slack, tracker.step_ema_s,
                                backlog=T - 1 - t, n_windows=S))
        t1 = time.perf_counter()
        out = eng.step()
        eng.sync()
        dur = time.perf_counter() - t1
        tracker.observe_step(dur)
        step_ms.append(1e3 * dur)
        for sid, (o, tel) in out.items():
            res[sid].append((o, tel))
            gov.observe_energy(1e3 * telemetry_cost(
                tel, cfg, budget, window_scale=60.0 * budget).energy_j)
            tracker.complete(arrival[t])
    launches = dict(build.LAUNCHES)
    _require_launched("governed", launches,
                      ("packed_hamming_batched", "bank_prefix_hamming"))
    summ = tracker.summary()
    log(f"[governed] compact engine, {GOVERNED_RT} ({1e3 * budget:.2f} ms), "
        f"{S} streams x {T} windows: plan_log {gov.plan_log}; ms/step "
        f"{[round(x, 2) for x in step_ms]}; governor {gov.summary()}; "
        f"deadline p99 {summ['p99_ms']:.1f} ms, miss_rate "
        f"{summ['miss_rate']:.3f}; launches {launches}")

    ladder = build_ladder(cfg)
    replay = engine()
    res2 = {sid: [] for sid in res}
    for _banks, _planes, level in gov.plan_log:
        replay.set_plan(ladder[level])
        for sid, r in replay.step().items():
            res2[sid].append(r)
    replay.sync()
    _assert_results_equal("governed replay", res, res2, skip=LOWERING_FIELDS)
    _assert_caches_equal("governed replay", eng.state.cache,
                         replay.state.cache)
    log(f"[governed] plan_log replayed with set_plan on a fresh prefix "
        f"engine: every window and the final caches bit-equal")


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
    t_start = t_phase = time.perf_counter()

    def done(name):
        nonlocal t_phase
        now = time.perf_counter()
        log(f"[phase] {name}: {now - t_phase:.1f} s")
        t_phase = now

    phase_card()
    phase_build()
    done("card and build")
    cfg = torr_edge()
    world = ts.make_world(0, M=cfg.M, d=cfg.feat_dim, n_tasks=5)
    sys_ = tp.build_system(world, cfg, torch.Generator().manual_seed(0))
    report = phase_kernels(cfg, sys_.im.to("cuda"))
    done("kernels")

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
    done("serving (prefix, with its two CPU references)")

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
    done("lowerings (serial switch, compact, auto)")
    phase_evaluate(cfg, world, sys_)
    done("evaluate")
    phase_sign_project(sys_, served, report)
    rows = phase_plans(cfg, sys_, served, reuse)
    done("plan ladder")
    phase_governed(cfg, sys_, reuse)
    done("governed")
    phase_plan_idle(cfg, sys_, served, rows)
    done("plan ladder idle share")
    missing = [n for n, r in report.items() if "launches" not in r]
    if missing:
        raise AssertionError(f"never launched on a path: {missing}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"plan_ladder": rows}))
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
