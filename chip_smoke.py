"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero without
printing its result line). Every engine runs with its default ``jit=True``
(each step segment replayed from a CUDA graph captured once per static
key, ``core/capture.py``) and ``run_torr`` likewise; phase 10 runs every
captured run of phases 3-5 and 8 again eagerly and holds the two bit for
bit:

  1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
     the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, all at once), and the tensor-core probe of
     ``perf/mma_probe.py`` (``[probe]`` lines: the int8 and 1-bit product
     routes the hamming kernels can take, their rates on this card);
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
     each of the three row counts; ``fused_scores`` and ``delta_update`` at
     the shapes their launches use (N = N_max and S x N_max rows; L = 1
     and S rows with the whole budget and one entry weighted) the same two
     ways, ``fused_scores`` beside its int8 tensor-core bound (its
     ``bound_ms``: the card's peak rate for this work), the popcount bound
     and torch._int_mm on the unpacked +-1 codes (a reference, not the
     library column: it reads 8x the bytes); ``bank_prefix_hamming`` and
     ``packed_hamming_batched`` the same way at their launch shapes (the
     step's S x N_max rows and the ladder's reduced plans; each decide
     table on its own), their ``bound_ms`` at the card's 1-bit
     tensor-core rate (their products' route; the int8 and popcount
     bounds beside it) and PyTorch's fill of the output beside them,
     bit-equal there and on adversarial inputs (all
     ones against all zeros, equal rows, words zeroed on both sides,
     ragged N, M and W); the compact bucket tiers after phase 5;
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
     ``fused_scores`` and ``delta_update`` kernels) on both traffics;
     after the served run, the weighted entries per row of its proposals'
     ``delta_update`` launches, read from the run's telemetry, are printed
     and ``delta_update`` is checked and timed at their median (the
     report's main shape),
     and the compact (batched and scan decide) and auto engines
     (``fused="compact"``/``"auto"``: the ``packed_hamming_batched``
     decide tables and the bucket scan) on both
     traffics, each bit-equal to the card's prefix engine of phase 3 or 4
     in every field but the lowering's own telemetry encodings; on the
     reuse traffic auto must reach the compact lowering; every bucket
     tier those runs' telemetry shows is then checked and timed on
     ``bank_prefix_hamming``;
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
  9. a governed run: ``AsyncStreamEngine`` on the compact lowering at
     RT-60 with a ``DeadlineTracker`` and a ``Governor`` (its warm-up
     captures every ladder level), 16 streams of the reuse windows fed
     live, window t of every stream submitted at frame time t; it prints
     p99, miss rate, shed, escalated, the ``plan_log`` and the graphs
     captured inside the served loop with their seconds, and fails unless
     a reduced plan was latched for a served step; then the run replayed
     on a fresh sync prefix engine, each step's windows, queue depths and
     plan as the async run served them, every served window and the final
     caches bit-equal;
 9a. async == sync: ``AsyncStreamEngine(paused=True, tracker=None)`` on
     the prefix and compact lowerings over both traffics' packed words of
     phases 3 and 4, and on the serial switch engine over one window a
     stream: every output, telemetry field and final cache bit-equal to
     that lowering's captured sync run of phases 3-5 (serial switch: to a
     captured sync engine's drain of the same windows); the sync drain's
     and the async engine's ms/step and windows/s, then each run again
     under torch.profiler: device busy ms and idle share against that
     run's own wall time;
 9b. the launcher once: ``run_torr_streams(16, 4, rt="RT-60",
     governor=True)`` with its metrics JSON, flight JSONL and Chrome trace
     in a temporary directory; every window served or shed and at least
     one served, the three artifacts parsed, the launches after the
     engine's warm-up at least one ``bank_prefix_hamming`` a served step;
 10. eager == captured: every run of phases 3-5 and 8 again with
     ``StreamEngine(jit=False)`` (the switch stream without a graph
     family), on the same packed words: every output, telemetry field and
     final cache bit-equal to the captured run's; each run's eager and
     captured ms/step (steps timed to their sync), then one line with each
     lowering's, the graph counts and ``torch.cuda.memory_reserved()``
     (the graph count and memory are also printed after phase 8);
 11. the device-idle share of every level and lowering of phase 8 on the
     served traffic (its second window again, under ``torch.profiler``),
     last, because a profiled step slows the steps after it.

Each path's kernel launches are counted from zero around that path's run
and must all be above zero; a replayed graph adds the launches its
capture recorded (``GraphFamily``), so the counts keep their meaning.
Each phase's seconds are logged as ``[phase]`` lines. The plan-ladder
rows (captured and eager ms/step, windows/s, idle share), the async vs
sync rows and the per-kernel report are printed as JSON before the last
line, which is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import threading
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
PEAK_INT8_S = 1979e12       # dense int8 TOP/s, on the tensor cores
# 1-bit products on the tensor cores (b1 .and.popc), counted as int8 ops
# are, 64 a 32-bit word pair: the data sheet gives no rate; 8x the int8
# peak, which wgmma b1 reaches on an H100 (perf/mma_probe.py: 248.2 T word
# pairs/s against the int8 peak's 30.9 T)
PEAK_B1_S = 8 * PEAK_INT8_S
# Integer issue rates of compute capability 9.0, per SM per clock (CUDA C++
# Programming Guide, throughput table of the arithmetic instructions): 64
# 32-bit integer adds, multiply-adds or bitwise ops, 16 population counts
INT32_PER_CLK, POPC_PER_CLK = 64, 16
REPS = 20
# the classes of one block of fused_scores.cu (the tie cases put a copy of
# the maximum in each)
FS_CLASS_TILE = 128
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


def bits_equal(a, b) -> bool:
    """Tensors (on any device) or host arrays, equal bit for bit."""
    a, b = (torch.as_tensor(x).detach().cpu() for x in (a, b))
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
    from repro_torch.perf import mma_probe

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[build] {len(build.SIGNATURES)} kernels in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")
    mma_probe.probe(log)


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


def phase_kernels(cfg, im_cuda, rates):
    """Every kernel vs its plain version on the card, then timed."""
    from repro_torch.core import aligner

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(11)
    report = {}

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    N = STREAMS * cfg.N_max
    im_w = im_cuda.packed

    def plan_cols(qq, cap, planes):
        return tuple(x.contiguous() for x in aligner._plan_columns_bank_major(
            qq, im_cuda, cap, planes, cfg))

    report["bank_prefix_hamming"] = _prefix_kernel(cfg, im_w, words,
                                                   plan_cols, rates)
    report["fused_scores"] = _fused_scores_kernel(cfg, im_w, words,
                                                  plan_cols, rates)
    report["delta_update"] = _delta_update_kernel(cfg, im_cuda.dmajor, gen,
                                                  rates)
    report["packed_hamming_batched"] = _batched_kernel(cfg, words, dev,
                                                       rates)
    report.update(_encode_kernels(cfg, gen, dev, N))
    return report


def _adversarial(words, n, m, w):
    """Packed inputs on which a wrong decomposition shows: all ones
    against all zeros (hamming 32 w at the last boundary), equal rows
    (0), and random rows with every third word zeroed on both sides (a
    plan's disabled words), each [n, w] x [m, w]."""
    q, h = words(n, w), words(m, w)
    ones = torch.full_like(q, -1)
    zmask = (torch.arange(w, device=q.device) % 3 == 1)
    return {
        "all ones x all zeros": (ones, torch.zeros_like(h)),
        "equal rows": (q, q[:m].clone() if m <= n else
                       q.repeat(-(-m // n), 1)[:m].contiguous()),
        "masked words zeroed on both sides": (torch.where(zmask, 0, q),
                                              torch.where(zmask, 0, h)),
    }


def _hamming_time(name, label, fn, plain, moved, pairs, rates, int_mm):
    """One launch shape of a hamming kernel timed two ways (a CUDA graph of
    20 calls; one call with its host time) beside the plain version, its
    bound at the card's 1-bit tensor-core rate, the kernels' route
    (``bound_ms``: 64 operations a word pair at ``PEAK_B1_S``, against the
    bytes), the int8 tensor-core bound (``bound_int8_ms``: the same count
    at 1,979 TOP/s), the popcount bound (``bound_popc_ms``), PyTorch's
    fill of the output (``fill_ms``: writing it alone, device time) and
    ``int_mm``, torch._int_mm on the unpacked +-1 codes over the full
    width (a reference: 8x the bytes, not the same function; None below
    its 17-row minimum)."""
    b = bound(moved, 64 * pairs / PEAK_B1_S)
    b8 = bound(moved, 64 * pairs / PEAK_INT8_S)
    bp = bound(moved, rates.popc_s(pairs))
    out = fn()
    t = dict(ms=device_ms(fn), call_ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
             bound_ms=b[0], bound_by=b[1], bound_int8_ms=b8[0],
             bound_int8_by=b8[1], bound_popc_ms=bp[0], bound_popc_by=bp[1],
             fill_ms=device_ms(out.zero_), int_mm_ms=None,
             int_mm_call_ms=None)
    if int_mm is not None:
        t.update(int_mm_ms=device_ms(int_mm), int_mm_call_ms=cuda_ms(int_mm))
    ref_txt = ("n/a" if int_mm is None else
               f"{t['int_mm_ms']:.4f} ms ({t['int_mm_call_ms']:.4f})")
    log(f"[time] {name} {label}: kernel {t['ms']:.4f} ms on the device "
        f"({t['call_ms']:.4f} ms for one call with its host time), plain "
        f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms 1-bit tensor "
        f"cores ({t['bound_by']}), {t['bound_int8_ms']:.4f} ms int8 "
        f"({t['bound_int8_by']}), {t['bound_popc_ms']:.4f} ms popcount "
        f"({t['bound_popc_by']}); kernel / bound "
        f"{t['ms'] / t['bound_ms']:.2f}, / int8 bound "
        f"{t['ms'] / t['bound_int8_ms']:.2f}, / popcount bound "
        f"{t['ms'] / t['bound_popc_ms']:.2f}; fill of the output "
        f"{t['fill_ms']:.4f} ms; reference torch._int_mm on "
        f"unpacked +-1 int8 codes {ref_txt}")
    return t


def _pm1_int_mm(q, h):
    """torch._int_mm of the +-1 codes of q [n, w] and h [m, w] (None where
    torch._int_mm does not take the shape), checked against the hamming
    of the full width: dot_pm1 = 32 w - 2 hamming."""
    from repro_torch.core import hdc
    from repro_torch.kernels import ref

    n, w = q.shape
    if n <= 16 or (32 * w) % 8 or h.shape[0] % 8:
        return None
    q_pm1 = hdc.unpack_bits(q, 32 * w)
    h_pm1 = hdc.unpack_bits(h, 32 * w).T

    def fn():
        return torch._int_mm(q_pm1, h_pm1)

    if not torch.equal(fn(), 32 * w - 2 * ref.packed_hamming_ref(q, h)):
        raise AssertionError("torch._int_mm of the +-1 codes != 32 W - 2 H")
    return fn


def _prefix_kernel(cfg, im_w, words, plan_cols, rates):
    """bank_prefix_hamming against its plain version at the hoisted
    S x N_max batch (the prefix step's launch, and the compact step's on
    overflow or at its no-savings tier) at full precision, at the
    ladder's reduced plans through the column selection -- (cap=4,
    planes=2), (8, 1) (W = 64, cap = 8) and (1, 1) (W = 8, cap = 1) -- at
    ragged shapes (W = 40 with cap 1, 5 and 8) and on the adversarial
    inputs; then the step's launch and both reduced plans timed
    (:func:`_hamming_time`). The compact tiers are timed after the compact
    and auto runs (:func:`_prefix_tiers`)."""
    from repro_torch.kernels import fused_window as fw
    from repro_torch.kernels import ref

    name = "bank_prefix_hamming"
    N, W, M = STREAMS * cfg.N_max, cfg.words, im_w.shape[0]
    q = words(N, W)
    cases = {
        "main": (q, im_w, cfg.B),
        "plan(planes=2,cap=4)": plan_cols(q, 4, 2) + (4,),
        "plan(8,1): W=64, cap=8": plan_cols(q, 8, 1) + (8,),
        "plan(1,1): W=8, cap=1": plan_cols(q, 1, 1) + (1,),
        "ragged(N=37,M=1000)": (words(37, W), im_w[:1000], cfg.B),
    }
    for cap in (1, 5, 8):
        cases[f"ragged(N=37,M=1001,W=40,cap={cap})"] = (
            words(37, 40), words(1001, 40), cap)
    # 32 W >= 65,536: the kernel stages 32-bit counts
    cases["wide(N=37,M=45,W=2048,cap=8)"] = (words(37, 2048), words(45, 2048),
                                             8)
    for label, (a, b) in _adversarial(words, 45, 77, 40).items():
        for cap in (1, 5, 8):
            cases[f"{label}(N=45,M=77,W=40,cap={cap})"] = (a, b, cap)
    errs = {}
    for label, (qq, hh, cap) in cases.items():
        qq, hh = qq.contiguous(), hh.contiguous()
        got = _one_launch(name, lambda: fw.bank_prefix_hamming(qq, hh,
                                                               cap=cap))
        errs[label] = _check(name, label, got,
                             ref.bank_prefix_hamming_ref(qq, hh, cap=cap))
    by_shape = {}
    for label, (qq, hh, cap) in (
            (f"step(N={N},W={W},cap={cfg.B})", cases["main"]),
            (f"plan(8,1)(N={N},W=64,cap=8)", cases["plan(8,1): W=64, cap=8"]),
            (f"plan(1,1)(N={N},W=8,cap=1)", cases["plan(1,1): W=8, cap=1"])):
        by_shape[label] = _prefix_time(label, qq, hh, cap, rates)
    main = by_shape[f"step(N={N},W={W},cap={cfg.B})"]
    return dict(name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/bank_prefix_hamming.cu",
                replaces="src/repro/kernels/fused_window.py:253",
                max_abs_err=max(errs.values()), library_ms=None,
                main_shape=f"step(N={N},W={W},cap={cfg.B})",
                **{k: main[k] for k in (
                    "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_int8_ms", "bound_popc_ms", "int_mm_ms")},
                by_shape=by_shape)


def _prefix_time(label, q, h, cap, rates):
    from repro_torch.kernels import fused_window as fw
    from repro_torch.kernels import ref

    n, w = q.shape
    m = h.shape[0]
    # each input read once, the [n, m, cap] counts written once
    return _hamming_time(
        "bank_prefix_hamming", label,
        lambda: fw.bank_prefix_hamming(q, h, cap=cap),
        lambda: ref.bank_prefix_hamming_ref(q, h, cap=cap),
        4 * (n * w + m * w + n * m * cap), n * m * w, rates,
        _pm1_int_mm(q, h))


def _prefix_tiers(cfg, im_w, tiers, report, rates):
    """bank_prefix_hamming checked and timed at every compact bucket tier
    the compact and auto runs launched (their ``bucket_tier`` telemetry):
    a bucket of ``tier`` rows against the item memory at full precision."""
    from repro_torch.kernels import fused_window as fw
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cpu").manual_seed(13)
    entry = report["bank_prefix_hamming"]
    log(f"[tiers] compact bucket tiers launched by the compact and auto "
        f"runs: {sorted(tiers)}")
    W = cfg.words
    for tier in sorted(tiers):
        q = torch.randint(-2 ** 31, 2 ** 31 - 1, (tier, W), generator=gen,
                          dtype=torch.int32).to(im_w.device)
        label = f"compact tier(N={tier},W={W},cap={cfg.B})"
        entry["max_abs_err"] = max(entry["max_abs_err"], _check(
            "bank_prefix_hamming", label,
            fw.bank_prefix_hamming(q, im_w, cap=cfg.B),
            ref.bank_prefix_hamming_ref(q, im_w, cap=cfg.B)))
        entry["by_shape"][label] = _prefix_time(label, q, im_w, cfg.B, rates)


def _batched_kernel(cfg, words, dev, rates):
    """packed_hamming_batched against its plain version: the batched
    decide pass's two tables of a step, proposals vs cache snapshot
    [16, 128] x [16, 8] and proposals vs proposals [16, 128] x [16, 128],
    both also pre-masked by the ladder's (1, 1) plan
    (ops.masked_hamming_all zeroes disabled words), ragged shapes (W = 40,
    M = 1 and 5, N = 37), the 2-D form, and the adversarial inputs; then
    each table timed on its own (:func:`_hamming_time`; the int8
    reference is S calls of torch._int_mm, one a stream)."""
    from repro_torch.core import item_memory
    from repro_torch.kernels import ref
    from repro_torch.kernels import xnor_popcount_sim as xps

    name = "packed_hamming_batched"
    S, Nw, K, W = STREAMS, cfg.N_max, cfg.K, cfg.words
    qb = words(S, Nw, W)
    eb = words(S, K, W)
    wm = item_memory.plan_word_mask(cfg, 1, 1, dev)
    qm, em = torch.where(wm, qb, 0), torch.where(wm, eb, 0)
    snap, prop = f"snapshot([{S},{Nw}]x[{S},{K}])", \
        f"proposals([{S},{Nw}]x[{S},{Nw}])"
    cases = {
        snap: (qb, eb),
        prop: (qb, qb),
        "snapshot, plan(1,1) mask": (qm, em),
        "proposals, plan(1,1) mask": (qm, qm),
        "ragged([3,37]x[3,5],W=40)": (words(3, 37, 40), words(3, 5, 40)),
        "ragged([3,37]x[3,1],W=40)": (words(3, 37, 40), words(3, 1, 40)),
        "ragged([2,37]x[2,8],W=8)": (words(2, 37, 8), words(2, 8, 8)),
        "ragged([2,37]x[2,45],W=13)": (words(2, 37, 13), words(2, 45, 13)),
        "wide([2,37]x[2,45],W=2048)": (words(2, 37, 2048),
                                       words(2, 45, 2048)),
        "2-D [37,40]x[77,40]": (words(37, 40), words(77, 40)),
    }
    for label, (a, b) in _adversarial(words, 37, 8, 40).items():
        cases[f"{label}([1,37]x[1,8],W=40)"] = (a[None], b[None])
    errs = {label: _check(name, label,
                          _one_launch(name, lambda: xps.packed_hamming_batched(
                              qq.contiguous(), hh.contiguous())),
                          ref.packed_hamming_ref(qq.contiguous(),
                                                 hh.contiguous()))
            for label, (qq, hh) in cases.items()}
    by_shape = {}
    for label in (snap, prop):
        qq, hh = cases[label]
        m = hh.shape[1]
        mms = [_pm1_int_mm(qq[s], hh[s]) for s in range(S)]
        by_shape[label] = _hamming_time(
            name, label, lambda: xps.packed_hamming_batched(qq, hh),
            lambda: ref.packed_hamming_ref(qq, hh),
            4 * (S * Nw * W + S * m * W + S * Nw * m), S * Nw * m * W, rates,
            None if None in mms else (lambda: [f() for f in mms]))
    main = by_shape[prop]
    return dict(name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/packed_hamming_batched.cu",
                replaces="src/repro/kernels/xnor_popcount_sim.py:130",
                max_abs_err=max(errs.values()), library_ms=None,
                main_shape=prop,
                **{k: main[k] for k in (
                    "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_int8_ms", "bound_popc_ms", "int_mm_ms")},
                by_shape=by_shape)


def _one_launch(name, fn):
    """``fn()`` with the check that it launched ``name`` exactly once."""
    from repro_torch.kernels import build

    before = build.LAUNCHES[name]
    out = fn()
    if build.LAUNCHES[name] != before + 1:
        raise AssertionError(f"{name}: {build.LAUNCHES[name] - before} "
                             "launches for one call")
    return out


def _fused_scores_kernel(cfg, im_w, words, plan_cols, rates):
    """fused_scores against its plain version at one window's proposals
    (N = N_max, the switch step's launch) and one engine step's
    (N = S x N_max, the batched switch lowering's widest launch) at the
    widest plan, at reduced plans, ragged M and W, M = 1 (top2[1] =
    INT32_MIN), and three tie patterns: copies 512 classes apart, adjacent
    copies (one class tile) and a copy in every FS_CLASS_TILE-class tile
    (each tile of the kernel's class split holds the tied maximum); the
    first copy must win and top2[1] == top2[0]. Then both N timed two ways
    (a CUDA graph of 20 calls, and one call with its host time) beside the
    plain version, the int8 tensor-core bound (``bound_ms``: the kernel's
    products run there), the popcount bound (``bound_popc_ms``), and the
    int8 product torch._int_mm on the unpacked +-1 operands (a reference
    that reads 8x the bytes, not a library call of the same function)."""
    from repro_torch.core import hdc
    from repro_torch.kernels import fused_window as fw
    from repro_torch.kernels import ref

    Nw, W, M = cfg.N_max, cfg.words, im_w.shape[0]
    rows = (Nw, STREAMS * Nw)
    qs = {n: words(n, W) for n in rows}
    qw, half, T = qs[Nw], M // 2, FS_CLASS_TILE
    # label: (item memory, classes the first copy of each tie lies under,
    # or 2 for adjacent copies: the first copy's index is even)
    ties = {
        f"tied(copies {half} apart)": (
            torch.cat([im_w[:half], im_w[:half]]), half),
        "tied(adjacent copies, one class tile)": (
            im_w[:half].repeat_interleave(2, dim=0), 2),
        f"tied(a copy in every {T}-class tile)": (
            im_w[:T].repeat(M // T, 1), T),
    }
    cases = {
        f"main(N={n},b=8)": (qs[n], im_w) for n in rows}
    cases.update({
        "reduced(b=2)": (qw[:, :2 * cfg.bank_words], im_w[:, :2 * cfg.bank_words]),
        "plan(4,1): W=32": plan_cols(qw, 4, 1),
        "plan(1,1): W=8": plan_cols(qw, 1, 1),
        "ragged(N=37,M=1000,W=96)": (words(37, 96), im_w[:1000, :96]),
        "ragged(N=128,M=1001,W=37)": (qw[:, :37], im_w[:1001, :37]),
        "M=1": (qw, im_w[:1]),
    })
    cases.update({k: (qw, v[0]) for k, v in ties.items()})
    errs = {}
    for label, (qq, hh) in cases.items():
        qq, hh = qq.contiguous(), hh.contiguous()
        d_eff = 32 * qq.shape[1]
        got = _one_launch("fused_scores",
                          lambda: fw.fused_scores(qq, hh, d_eff=d_eff))
        errs[label] = _check("fused_scores", label, got,
                             ref.fused_scores_ref(qq, hh, d_eff=d_eff))
        if label in ties:
            under = ties[label][1]
            first = (got[1] % 2 == 0) if under == 2 else (got[1] < under)
            if not (bool(first.all())
                    and torch.equal(got[2][:, 0], got[2][:, 1])):
                raise AssertionError(f"fused_scores {label}: ties not "
                                     "resolved to the first copy")
        if label == "M=1" and not (bool((got[1] == 0).all()) and bool(
                (got[2][:, 1] == ref.INT32_MIN).all())):
            raise AssertionError("fused_scores M=1: best != 0 or "
                                 "top2[1] != INT32_MIN")
    by_rows = {}
    for n in rows:
        q = qs[n]
        q_pm1 = hdc.unpack_bits(q, 32 * W)
        im_pm1 = hdc.unpack_bits(im_w, 32 * W)

        def fn():
            return fw.fused_scores(q, im_w, d_eff=cfg.D)

        def int_mm():
            return torch._int_mm(q_pm1, im_pm1.T)

        # the int8 product of the +-1 codes is acc - (d_eff - 32 W)
        if not torch.equal(int_mm() + (cfg.D - 32 * W), fn()[0]):
            raise AssertionError("torch._int_mm of the +-1 codes != acc")
        moved = 4 * (n * W + M * W + n * M + 3 * n)
        b = bound(moved, 2 * n * M * 32 * W / PEAK_INT8_S)
        bp = bound(moved, rates.popc_s(n * M * W))
        t = dict(ms=device_ms(fn), call_ms=cuda_ms(fn),
                 plain_ms=cuda_ms(lambda: ref.fused_scores_ref(
                     q, im_w, d_eff=cfg.D)),
                 bound_ms=b[0], bound_by=b[1], bound_popc_ms=bp[0],
                 bound_popc_by=bp[1], int_mm_ms=device_ms(int_mm),
                 int_mm_call_ms=cuda_ms(int_mm))
        by_rows[str(n)] = t
        log(f"[time] fused_scores(N={n},M={M},W={W}): kernel {t['ms']:.4f} "
            f"ms on the device ({t['call_ms']:.4f} ms for one call with its "
            f"host time), plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms int8 tensor cores ({t['bound_by']}), "
            f"{t['bound_popc_ms']:.4f} ms popcount ({t['bound_popc_by']}); "
            f"reference torch._int_mm on unpacked +-1 int8 operands "
            f"[{n},{32 * W}] x [{32 * W},{M}] (8x the bytes) "
            f"{t['int_mm_ms']:.4f} ms ({t['int_mm_call_ms']:.4f}); kernel / "
            f"int8 bound {t['ms'] / t['bound_ms']:.2f}, kernel / popcount "
            f"bound {t['ms'] / t['bound_popc_ms']:.2f}, kernel / "
            f"torch._int_mm {t['ms'] / t['int_mm_ms']:.2f}")
    main = by_rows[str(Nw)]
    return dict(name="fused_scores", route="cuda",
                source="src/repro_torch/kernels/csrc/fused_scores.cu",
                replaces="src/repro/kernels/fused_window.py:141",
                max_abs_err=max(errs.values()), library_ms=None,
                **{k: main[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "call_ms",
                    "bound_popc_ms", "int_mm_ms")},
                by_rows=by_rows)


def _delta_rows(L, K, nnz, D, gen):
    """idx, weight int32 [L, K] laid out as ``aligner.delta_indices`` lays
    them out: row l's first nnz[l] entries carry weight +-2 at ascending
    distinct dims, the rest are padding (index 0, weight 0)."""
    idx = torch.zeros((L, K), dtype=torch.int32)
    w = torch.zeros((L, K), dtype=torch.int32)
    for r, n in enumerate(nnz):
        idx[r, :n] = torch.randperm(D, generator=gen)[:n].sort().values
        w[r, :n] = torch.randint(0, 2, (n,), generator=gen) * 4 - 2
    return idx, w


def _delta_bound(idx, w, M, D, rates):
    """bytes: the distinct dmajor rows the nonzero weights need, idx and w,
    acc in and out; operations: one multiply-add per nonzero entry and
    column on the 64-wide integer pipe."""
    nz = w != 0
    ix = idx[nz]
    rows = int(torch.unique(torch.where(ix < 0, ix + D, ix).clamp(0, D - 1))
               .numel())
    L, K = idx.shape
    return bound(rows * M + 8 * L * K + 8 * L * M,
                 rates.int32_s(int(nz.sum()) * M))


def _delta_time(label, args, rates):
    """delta_update at ``args`` timed two ways beside the plain version and
    the bound of this fill; logs and returns the times."""
    from repro_torch.kernels import delta_update as du
    from repro_torch.kernels import ref

    acc, dmajor, idx, w = args
    b = _delta_bound(idx, w, dmajor.shape[1], dmajor.shape[0], rates)
    t = dict(ms=device_ms(lambda: du.delta_update(*args)),
             call_ms=cuda_ms(lambda: du.delta_update(*args)),
             plain_ms=cuda_ms(lambda: ref.delta_update_ref(*args)),
             bound_ms=b[0], bound_by=b[1],
             nonzero=int((w != 0).sum()))
    log(f"[time] delta_update {label}: kernel {t['ms']:.4f} ms on the "
        f"device ({t['call_ms']:.4f} ms for one call with its host time), "
        f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}); kernel / bound {t['ms'] / t['bound_ms']:.2f}")
    return t


def _delta_check(label, args):
    from repro_torch.kernels import delta_update as du
    from repro_torch.kernels import ref

    return _check("delta_update", label,
                  _one_launch("delta_update", lambda: du.delta_update(*args)),
                  ref.delta_update_ref(*args))


def _delta_fill(L, nnz, cfg, dmajor, gen, pad_row=False):
    """(acc, dmajor, idx, w) with L rows of nnz weighted entries each of
    the edge budget (the last row all padding with ``pad_row``)."""
    dev = dmajor.device
    M, D, K = dmajor.shape[1], dmajor.shape[0], cfg.delta_budget
    counts = [nnz] * L
    if pad_row:
        counts[-1] = 0
    idx, w = _delta_rows(L, K, counts, D, gen)
    acc = torch.randint(-4000, 4000, (L, M), generator=gen,
                        dtype=torch.int32)
    return acc.to(dev), dmajor, idx.to(dev), w.to(dev)


def _delta_update_kernel(cfg, dmajor, gen, rates):
    """delta_update against its plain version: the serial switch step's
    launch shape (L = 1 row: one proposal of one stream) and the batched
    switch lowering's (L = 16, one proposal of every stream), each with the
    whole budget weighted (a proposal whose flip count reaches it) and with
    one weighted entry (at L = 16 the last row all padding), all timed; the
    L = 16 input of the earlier slices (half of each row padding, every
    fifth row all padding; timed too), a ragged M (no vector loads), an
    all-padding row, indices out of range with weight (a negative one
    wrapped from the end once, then every one clamped to [0, D), as JAX's
    gather takes them: -1, -5, -D, -D - 3, D + 6 among them), K = 1 and K = 1001 (not a multiple of the
    kernel's budget split). The fill that the serial switch run's launches
    see most is timed after that run (:func:`_delta_median`)."""
    dev = dmajor.device
    L, Kb, D, M = STREAMS, cfg.delta_budget, cfg.D, dmajor.shape[1]
    acc = torch.randint(-4000, 4000, (L, M), generator=gen,
                        dtype=torch.int32).to(dev)
    idx = torch.randint(0, D, (L, Kb), generator=gen,
                        dtype=torch.int32).to(dev)
    wts = (torch.randint(0, 2, (L, Kb), generator=gen,
                         dtype=torch.int32) * 4 - 2)
    wts[:, Kb // 2:] = 0
    wts[::5] = 0
    wts = wts.to(dev)
    main = (acc, dmajor, idx, wts)
    oor_idx, oor_w = idx[:2].clone(), wts[:2].clone()
    oor_idx[0, :3] = torch.tensor([-5, D + 100, 2 ** 31 - 1])
    oor_w[0, :3] = torch.tensor([2, -2, 2])
    oor_idx[1, -1], oor_w[1, -1] = -(2 ** 31), -2
    neg_idx, neg_w = idx[:2].clone(), wts[:2].clone()
    neg_idx[0, :5] = torch.tensor([-1, -5, -D, -D - 3, D + 6])
    neg_w[0, :5] = torch.tensor([2, -2, 2, -2, 2])
    neg_idx[1, -5:] = torch.tensor([-1, -5, -D, -D - 3, D + 6])
    neg_w[1, -5:] = torch.tensor([-2, 2, -2, 2, -2])
    timed = {f"L={n},nnz={k}": _delta_fill(n, k, cfg, dmajor, gen,
                                           pad_row=(n > 1 and k == 1))
             for n in (1, L) for k in (Kb, 1)}
    cases = {"main(L=16,budget=2048)": main,
             "ragged(M=1001)": (acc[:, :1001].contiguous(),
                                dmajor[:, :1001].contiguous(), idx, wts),
             "L=1, all padding": _delta_fill(1, 0, cfg, dmajor, gen),
             "indices out of range, weighted": (acc[:2].contiguous(), dmajor,
                                                oor_idx, oor_w),
             "negative indices -1, -5, -D, -D-3 and D+6, weighted": (
                 acc[:2].contiguous(), dmajor, neg_idx, neg_w),
             "K=1": (acc, dmajor, idx[:, :1].contiguous(),
                     torch.where(wts[:, :1] == 0, 2, wts[:, :1]).contiguous()),
             "K=1001": (acc, dmajor, idx[:, :1001].contiguous(),
                        torch.where(wts[:, :1001] == 0, 2,
                                    wts[:, :1001]).contiguous())}
    cases.update(timed)
    errs = {label: _delta_check(label, args) for label, args in cases.items()}
    by_shape = {label: _delta_time(label, args, rates)
                for label, args in timed.items()}
    by_shape["main(L=16,budget=2048)"] = _delta_time(
        "main(L=16,budget=2048)", main, rates)
    first = by_shape["L=1,nnz=2048"]
    return dict(name="delta_update", route="cuda",
                source="src/repro_torch/kernels/csrc/delta_update.cu",
                replaces="src/repro/kernels/delta_update.py:37",
                max_abs_err=max(errs.values()), library_ms=None,
                main_shape="L=1,nnz=2048",
                **{k: first[k] for k in ("ms", "call_ms", "plain_ms",
                                         "bound_ms", "bound_by")},
                by_shape=by_shape)


def _delta_fill_counts(cfg, frames, res):
    """Weighted entries of the ``delta_update`` row each valid proposal of
    an engine run launches: ``delta_indices`` weights the first
    min(|Delta|, budget) entries, and the telemetry keeps |Delta|. Padding
    proposals launch too, but their |Delta| is not kept (it reads 0)."""
    counts = [np.minimum(tel.delta_count.cpu().numpy()[fr[t].valid],
                         cfg.delta_budget)
              for s, fr in enumerate(frames)
              for t, (_, tel) in enumerate(res[f"cam{s}"])]
    return torch.from_numpy(np.concatenate(counts))


def _delta_median(cfg, dmajor, counts, report, rates):
    """Print the distribution of weighted entries per row over the serial
    switch run's proposals' delta_update launches, then check and time the
    kernel at the median fill at L = 1 (the launch shape of that run, now
    the report's main shape) and L = 16."""
    if counts.numel() == 0:
        raise AssertionError("serial switch run: no proposal")
    c = counts.to(torch.float64)
    q = [int(torch.quantile(c, p)) for p in (0.0, 0.1, 0.25, 0.5, 0.75,
                                              0.9, 1.0)]
    med = q[3]
    log(f"[delta fill] serial switch run: {counts.numel()} proposals' rows "
        f"of {cfg.delta_budget} budget entries; weighted entries per row "
        f"min/p10/p25/median/p75/p90/max {q}; rows with no weighted entry "
        f"{int((counts == 0).sum())}, rows with the whole budget weighted "
        f"{int((counts == cfg.delta_budget).sum())}")
    gen = torch.Generator(device="cpu").manual_seed(12)
    entry = report["delta_update"]
    for n in (1, STREAMS):
        label = f"L={n},nnz={med} (median)"
        args = _delta_fill(n, med, cfg, dmajor, gen)
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   _delta_check(label, args))
        entry["by_shape"][label] = _delta_time(label, args, rates)
    main = entry["by_shape"][f"L=1,nnz={med} (median)"]
    entry.update(main_shape=f"L=1,nnz={med} (median)",
                 **{k: main[k] for k in ("ms", "call_ms", "plain_ms",
                                         "bound_ms", "bound_by")})
    entry["fill_quantiles"] = q


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
            got = _one_launch(name, lambda: k["fn"](zz, RR))
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
DECIDE_SCAN, DECIDE_BATCHED, DECIDE_NONE = 0, 1, -1
LOWERING_FIELDS = ("fused_mode", "decide_mode", "bucket_tier")


def _serve_card(cfg, sys_, frames, report, label, steps=None, words=None,
                warm=True, **engine_kw):
    """Serve ``frames`` (S streams in S slots) through an engine on the
    card: features -> ``encode_packed`` (or the given per-step ``words``)
    -> ``submit`` -> ``step`` -> ``sync`` (all of them, or the first
    ``steps``), each step timed on the host clock up to its sync, with
    every kernel's launches counted from zero around the run. ``warm``
    runs the engine's warm-up first (with ``jit`` it captures the first
    key). Returns the engine, its per-stream results, the state after each
    step, each step's packed words, the launch counts and the step times
    in ms."""
    from repro_torch.kernels import build
    from repro_torch.perf.profile_step import encode_step, submit_step
    from repro_torch.serving.stream_engine import StreamEngine

    S, T = len(frames), len(frames[0])
    R = torch.as_tensor(sys_.R).cuda()
    eng = StreamEngine(cfg, sys_.im, n_slots=S, **engine_kw)
    t0 = time.perf_counter()
    if warm:
        eng.warmup()
    eng.sync()
    warm_s = time.perf_counter() - t0
    build.reset_launches()
    t0 = time.perf_counter()
    for s in range(S):
        eng.admit(f"cam{s}", sys_.task_w[s % sys_.task_w.shape[0]])
    encode = words is None
    words = [] if encode else words
    for t in range(T):    # one encode call per step's windows
        if encode:
            words.append(encode_step(frames, t, R))
        submit_step(eng, frames, t, words[t])
    res = {f"cam{s}": [] for s in range(S)}
    states, step_ms = [], []
    # each stream's backlog is its queue depth
    while eng.busy and (steps is None or len(states) < steps):
        t1 = time.perf_counter()
        out = eng.step()
        eng.sync()
        step_ms.append(1e3 * (time.perf_counter() - t1))
        for sid, r in out.items():
            res[sid].append(r)
        states.append(eng.state)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    # each graph's segment, host value and kernel nodes
    nodes = {f"{k[0]}{list(k[5:])}": eng.graphs.entry(k).kernel_nodes
             for k in (eng.graphs.keys() if eng.graphs else ())}
    log(f"[{label}] {torch.cuda.get_device_name(0)}: {eng.stats.windows} "
        f"windows in {wall:.3f} s = {eng.stats.windows / wall:.1f} "
        f"windows/s, {1e3 * wall / eng.stats.steps:.1f} ms/step (encode "
        f"included); steps alone {[round(x, 2) for x in step_ms]} ms; "
        f"warm-up {warm_s:.3f} s; graphs (kernel nodes) {nodes}; launches "
        f"{launches}")
    for name, n in launches.items():
        if name in report and "launches" not in report[name] and n > 0:
            report[name]["launches"] = n
    return eng, res, states, words, launches, step_ms


def _captured_run(runs, label, res, cache, step_ms, graphs, eager, row=None):
    """Record a captured run for :func:`phase_eager`: its results, final
    cache, step times and graph count, and ``eager``, which runs the same
    thing with ``jit=False`` and returns (results, final cache, step ms)."""
    runs.append(dict(label=label, res=res, cache=cache,
                     ms=statistics.median(step_ms), graphs=graphs,
                     eager=eager, row=row))


def _eager_serve(cfg, sys_, frames, label, words, steps=None, **engine_kw):
    """:func:`_serve_card` of the same words on ``StreamEngine(jit=False)``
    (no warm-up: the kernels are built)."""
    def run():
        eng, res, _states, _words, _launches, ms = _serve_card(
            cfg, sys_, frames, {}, f"{label}, eager", steps=steps,
            words=words, warm=False, jit=False, **engine_kw)
        return res, eng.state.cache, ms
    return run


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


def phase_serving(cfg, sys_, frames, report, label, cpu_windows, runs):
    """The multi-stream step's default (prefix) lowering on the card, its
    first ``cpu_windows`` windows checked bit-equal to the CPU engine;
    returns its results and the state after each step for the other
    lowerings to be held to, and its packed words; records the run for
    :func:`phase_eager`."""
    eng, res, states, words, launches, step_ms = _serve_card(
        cfg, sys_, frames, report, label)
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
    _captured_run(runs, label, res, eng.state.cache, step_ms, len(eng.graphs),
                  _eager_serve(cfg, sys_, frames, label, words))
    return res, states, words


def phase_lowering(cfg, sys_, frames, report, label, base, kernels,
                   lowerings, runs, n_windows=None, **engine_kw):
    """An engine on another lowering, held bit-equal to the card's prefix
    engine (``base`` = its results and per-step states) in every field but
    the lowering encodings, which must be one of ``lowerings`` (tuples of
    fused_mode, decide_mode, bucket tier or None for any compact tier),
    over the first ``n_windows`` steps (all by default); the run is
    recorded for :func:`phase_eager`. Returns the per-step encodings and
    the engine's per-stream results."""
    base_res, base_states, _words = base
    eng, res, states, words, launches, step_ms = _serve_card(
        cfg, sys_, frames, report, label, steps=n_windows, **engine_kw)
    _captured_run(runs, label, res, eng.state.cache, step_ms, len(eng.graphs),
                  _eager_serve(cfg, sys_, frames, label, words,
                               steps=n_windows, **engine_kw))
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
    return seen, res


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
    after each step, the launches, the host ms of each timed step, the
    device busy ms of the profiled one (see :func:`_timed_steps`) and the
    engine's graph count."""
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
    return (res, states, dict(build.LAUNCHES), step_ms, busy,
            len(eng.graphs) if eng.graphs else 0)


def _switch_stream(cfg, sys_, frames, words, plan, profile, jit=True):
    """Stream 0 of ``words`` through ``torr_window_step(fused="switch",
    plan=plan)`` on the card, with the queue depth the engine gives it
    (its backlog after the pop), through a graph family of its own (as
    ``run_torr`` runs it; an all-pad window captures its first key before
    the timed windows, as an engine's warm-up does) or, without ``jit``,
    eagerly; launches counted from zero. Returns the final state, the results, the launches, the
    step ms, the device busy ms and the graph count."""
    from repro_torch.core import capture, pipeline
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    im = sys_.im.to(resolve_device())
    graphs = capture.GraphFamily() if jit else None
    T, n = len(words), cfg.N_max
    st = pipeline.init_state(cfg, sys_.task_w[0])
    res = []
    if jit:   # an all-pad window at the first depth captures, untimed
        fr = frames[0][0]
        pipeline.torr_window_step(
            st, im, torch.zeros_like(words[0][:n]), np.zeros_like(fr.valid),
            fr.boxes, T - 1, cfg, plan=plan, fused="switch", graphs=graphs)

    def one(t):
        nonlocal st
        fr = frames[0][t]
        st, out, tel = pipeline.torr_window_step(
            st, im, words[t][:n], fr.valid, fr.boxes, T - 1 - t, cfg,
            plan=plan, fused="switch", graphs=graphs)
        res.append((out, tel))
        torch.cuda.synchronize()

    build.reset_launches()
    step_ms, busy = _timed_steps(T, one, profile)
    return (st, res, dict(build.LAUNCHES), step_ms, busy,
            len(graphs) if graphs else 0)


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


def phase_plans(cfg, sys_, served, reuse, runs):
    """Every level of the edge ladder on the prefix, compact and switch
    lowerings, both traffics, each step timed (see the module docstring,
    phase 8); every run is recorded for :func:`phase_eager`. Returns one
    row per (traffic, level, lowering)."""
    from repro_torch.control import build_ladder
    from repro_torch.core.types import map_tensors
    from repro_torch.perf.profile_step import encode_step

    ladder = build_ladder(cfg)
    R = torch.as_tensor(sys_.R).cuda()
    S = len(served)
    rows = []
    T = PLAN_WINDOWS
    n_graphs = []
    for traffic, frames in (("served", served), ("reuse", reuse)):
        frames = [fr[:T] for fr in frames]
        words = [encode_step(frames, t, R) for t in range(T)]
        for level, plan in enumerate(ladder):
            tag = f"plan {level} ({plan.banks},{plan.planes}) {traffic}"
            runs_l = {}
            for low, kw, kernels, enc in PLAN_LOWERINGS:
                tier = S * cfg.N_max if low == "compact" else 0
                res, states, launches, ms, _busy, graphs = _serve_words(
                    cfg, sys_, frames, words, plan, False, **kw)
                _require_launched(f"{tag} {low}", launches, kernels)
                _check_plan_windows(f"{tag} {low}", res, plan, enc + (tier,))
                runs_l[low] = (res, states, ms, S, graphs, kw)
                n_graphs.append(graphs)
            base_res, base_states = runs_l["prefix"][:2]
            res, states = runs_l["compact"][:2]
            _assert_results_equal(f"{tag} compact", res, base_res,
                                  skip=LOWERING_FIELDS)
            _assert_caches_equal(f"{tag} compact", states[-1].cache,
                                 base_states[-1].cache)
            st, res_sw, launches, ms, _busy, graphs = _switch_stream(
                cfg, sys_, frames, words, plan, False)
            n_graphs.append(graphs)
            _require_launched(f"{tag} switch", launches,
                              ("fused_scores", "delta_update"))
            _check_plan_windows(f"{tag} switch", {"cam0": res_sw}, plan,
                                (FUSED_SWITCH, DECIDE_NONE, 0))
            _assert_results_equal(f"{tag} switch", {"cam0": res_sw},
                                  base_res, skip=LOWERING_FIELDS)
            _assert_caches_equal(f"{tag} switch", st.cache, map_tensors(
                lambda x: x[0], base_states[-1].cache))
            runs_l["switch"] = ({"cam0": res_sw}, [st], ms, 1, graphs, None)
            for low, (res, states, ms, wins, graphs, kw) in runs_l.items():
                row = dict(traffic=traffic, level=level, banks=plan.banks,
                           planes=plan.planes, lowering=low, ms_per_step=ms,
                           eager_ms_per_step=None,
                           windows_per_s=1e3 * wins / statistics.median(ms),
                           device_busy_ms=None, idle_share=None)
                rows.append(row)
                log(f"[{tag} {low}] {wins} windows/step: ms/step "
                    f"{[round(x, 2) for x in ms]} = "
                    f"{row['windows_per_s']:.1f} windows/s; graphs {graphs}")
                _captured_run(runs, f"{tag} {low}", res, states[-1].cache,
                              ms, graphs,
                              _eager_plan(cfg, sys_, frames, words, plan, kw),
                              row=row)
            log(f"[{tag}] compact and switch == card prefix engine in every "
                f"field; path mix after the first window "
                f"{_path_mix(frames, base_res)}")
            if traffic == "reuse" and \
                    (plan.banks, plan.planes) in PLAN_CPU_LEVELS:
                _equal_to_cpu(cfg, sys_, frames, base_res, base_states,
                              words, tag, T, plan=plan)
    log(f"[plan ladder graphs] {sum(n_graphs)} graphs captured over "
        f"{len(n_graphs)} engines and switch streams (at most "
        f"{max(n_graphs)} each); torch.cuda.memory_reserved "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB")
    return rows


def _eager_plan(cfg, sys_, frames, words, plan, kw):
    """The eager twin of a ladder run: the engine (``kw``) with
    ``jit=False``, or the switch stream without a graph family (``kw`` is
    None); returns (results, final cache, step ms)."""
    def run():
        if kw is None:
            st, res, _l, ms, _b, _g = _switch_stream(cfg, sys_, frames, words,
                                                     plan, False, jit=False)
            return {"cam0": res}, st.cache, ms
        res, states, _l, ms, _b, _g = _serve_words(cfg, sys_, frames, words,
                                                   plan, False, jit=False,
                                                   **kw)
        return res, states[-1].cache, ms
    return run


def phase_eager(runs):
    """Every captured run of phases 3-5 and 8 again on the eager step
    (``StreamEngine(jit=False)``, the switch stream without graphs): every
    output, telemetry field and final cache must be bit-equal to the
    captured run's. Prints each run's eager and captured ms/step and one
    line with each lowering's, the graph counts and the memory the
    caching allocator holds."""
    for r in runs:
        res, cache, ms = r["eager"]()
        for sid, wins in r["res"].items():
            if len(res[sid]) != len(wins):
                raise AssertionError(f"{r['label']} eager: {sid} "
                                     f"{len(res[sid])} windows")
        _assert_results_equal(f"{r['label']} eager", res, r["res"])
        _assert_caches_equal(f"{r['label']} eager", cache, r["cache"])
        r["eager_ms"] = statistics.median(ms)
        if r["row"] is not None:
            r["row"]["eager_ms_per_step"] = ms
        log(f"[eager == captured] {r['label']}: outputs, telemetry and final "
            f"caches bit-equal; ms/step eager {r['eager_ms']:.2f}, captured "
            f"{r['ms']:.2f} ({r['graphs']} graphs)")
    log("[eager vs captured] median ms/step, eager / captured: " + "; ".join(
        f"{r['label']} {r['eager_ms']:.2f} / {r['ms']:.2f} ({r['graphs']} "
        f"graphs)" for r in runs if r["row"] is None)
        + f"; torch.cuda.memory_reserved "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB")


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
                                  **kw)[4]
                for low, kw, _k, _e in PLAN_LOWERINGS}
        busy["switch"] = _switch_stream(cfg, sys_, frames, words, plan,
                                        True)[4]
        for low, b in busy.items():
            row = row_of[(level, low)]
            row["device_busy_ms"] = b
            row["idle_share"] = 1.0 - b / row["ms_per_step"][-1]
        log(f"[plan {level} ({plan.banks},{plan.planes}) served idle] "
            + "; ".join(f"{low}: device busy {b:.2f} ms of "
                        f"{row_of[(level, low)]['ms_per_step'][-1]:.2f} ms, "
                        f"idle {row_of[(level, low)]['idle_share']:.4f}"
                        for low, b in busy.items()))


class FrameClock:
    """The deadline tracker's clock: the host's monotonic clock, except on
    a thread that pinned it to a frame's time, where it returns that time:
    the arrival stamp of every window the thread submits meanwhile."""

    def __init__(self):
        self._pinned = threading.local()

    def pin(self, t) -> None:
        self._pinned.t = t

    def __call__(self) -> float:
        t = getattr(self._pinned, "t", None)
        return time.monotonic() if t is None else t


def _submit_futures(eng, frames, words, T):
    """Submit window t < T of every stream ``cam<s>`` (its N_max rows of
    step t's words) to an async engine. Returns each stream's futures."""
    n = eng.cfg.N_max
    futs = {f"cam{s}": [] for s in range(len(frames))}
    for t in range(T):
        for s, fr in enumerate(frames):
            futs[f"cam{s}"].append(eng.submit(
                f"cam{s}", words[t][s * n:(s + 1) * n], fr[t].valid,
                fr[t].boxes))
    return futs


def _admit_all(eng, sys_, S):
    for s in range(S):
        eng.admit(f"cam{s}", sys_.task_w[s % sys_.task_w.shape[0]])


def _captures_after(graphs, n0):
    """The captures a graph family made after its first ``n0``, as
    (segment, seconds)."""
    return [(name, round(sec, 3)) for name, sec in graphs.captures[n0:]]


def phase_governed(cfg, sys_, frames):
    """The compact lowering under the QoS governor at RT-60 through
    ``AsyncStreamEngine`` (phase 9), fed live, twice: see
    :func:`_governed_run`. First under the RT-60 admission policy as
    served, shedding on: which windows it sheds depends on the host's
    timing (a window that waits for the engine lock past budget + margin
    is shed, and one slow step lifts the step EMA past that for every
    later window, since shed windows measure no step), so that run is
    replayed bit-equal and reported, and no plan is required of it. Then
    with shedding off (``allow_shed=False``: a late window is escalated,
    never dropped): every window is served, and the governor must latch a
    reduced plan for a served step, since a compact step of 16 streams
    (16 ms on the card before its host work) exceeds level 0's usable
    slack (the budget less the governor's 25 % margin, 12.5 ms)."""
    from repro_torch.perf.profile_step import encode_step

    R = torch.as_tensor(sys_.R).cuda()
    words = [encode_step(frames, t, R) for t in range(len(frames[0]))]
    _governed_run(cfg, sys_, frames, words, allow_shed=True)
    levels = _governed_run(cfg, sys_, frames, words, allow_shed=False)
    if not any(levels):
        raise AssertionError("governed, shedding off: the governor latched "
                             "no reduced plan for a served step")


def _governed_run(cfg, sys_, frames, words, allow_shed):
    """One governed run: a ``DeadlineTracker`` (RT-60, shedding as
    ``allow_shed`` says), a ``Governor``, the reuse windows fed live to
    the running engine, window t of every stream
    submitted at frame time t (frames one RT-60 budget apart) and stamped
    with it; the dispatcher gates each head window and latches the
    governor's plan each step, the collector feeds the measured step back
    to the tracker and each window's modeled energy to the governor. Each
    dispatched step's windows and queue-depth lanes are recorded. Then the
    run replayed on a fresh sync prefix engine: before each step the
    windows it served are submitted, behind the windows of their streams
    shed before them (the replay's gate sheds those again), the step's
    recorded queue depths replace the replay's, and the governor's log
    gives its plan; every served window and the final caches bit-equal.
    With shedding off every window must be served. Returns the plan level
    of each served step."""
    from repro_torch.configs.torr_edge import rt_budget_s
    from repro_torch.control import Governor, build_ladder, policy_for
    from repro_torch.kernels import build
    from repro_torch.obs import FlightRecorder, Tracer
    from repro_torch.serving import deadline
    from repro_torch.serving.async_engine import AsyncStreamEngine
    from repro_torch.serving.stream_engine import (GATE_ADMIT, GATE_SHED,
                                                   StreamEngine)

    S, T, n = len(frames), len(frames[0]), cfg.N_max
    budget = rt_budget_s(GOVERNED_RT)
    clock = FrameClock()
    tracker = deadline.DeadlineTracker(
        deadline.policy_for(GOVERNED_RT, allow_shed=allow_shed), clock=clock)
    label = "shedding on" if allow_shed else "shedding off"
    gov = Governor(cfg, policy_for(GOVERNED_RT))
    tracer, flight = Tracer(), FlightRecorder()
    batches = []     # each dispatched step's (window seqs, queue depths)

    class Recorded(AsyncStreamEngine):
        def _dispatch(self, q, v, b, qd):
            batches.append(([c.seq for c in self._step_ctxs],
                            qd.numpy().copy()))
            return super()._dispatch(q, v, b, qd)

    def window(s, t):
        return (f"cam{s}", words[t][s * n:(s + 1) * n], frames[s][t].valid,
                frames[s][t].boxes)

    eng = Recorded(cfg, sys_.im, n_slots=S, fused="compact", tracker=tracker,
                   governor=gov, paused=True, tracer=tracer, flight=flight)
    try:
        t_warm = time.perf_counter()
        eng.warmup()     # every ladder level's first key
        warm_s = time.perf_counter() - t_warm
        n_warm = len(eng.graphs.captures)
        _admit_all(eng, sys_, S)
        futs = {f"cam{s}": [] for s in range(S)}
        build.reset_launches()
        eng.start()
        t0 = time.monotonic()
        for t in range(T):   # the camera: frame t leaves at t0 + t * budget
            at = t0 + t * budget
            time.sleep(max(0.0, at - time.monotonic()))
            clock.pin(at)
            for s in range(S):
                futs[f"cam{s}"].append(eng.submit(*window(s, t)))
            clock.pin(None)
        eng.flush(timeout=600)
        wall = time.monotonic() - t0
        launches = dict(build.LAUNCHES)
        res, shed = {sid: [] for sid in futs}, 0
        for sid, fs in futs.items():
            for f in fs:
                try:
                    res[sid].append(f.result(timeout=60))
                except deadline.WindowShed:
                    shed += 1
        cache = eng.state.cache
    finally:
        eng.close()
    summ = tracker.summary()
    steps = eng.stats.steps
    levels = [level for _b, _p, level in gov.plan_log]
    # the engine lock is held through both dispatcher spans of a step: the
    # assembly and gate (host_decide), then the copies in, the decide
    # graph, the host read of the full-path count and the finish graph
    # (dispatch_enqueue); every window of a step carries the same spans
    held = {phase: statistics.median(
        e["dur_us"] / 1e3 for ctx in tracer.completed() for e in ctx.events
        if e["phase"] == phase) if steps else float("nan")
        for phase in ("host_decide", "dispatch_enqueue")}
    step_ms = [round(1e3 * r["step_latency_s"], 2) for r in flight.records()]
    log(f"[governed, {label}] AsyncStreamEngine, compact, {GOVERNED_RT} "
        f"({1e3 * budget:.2f} ms), {S} streams x {T} windows fed live at "
        f"frame times: {eng.stats.windows} served, {shed} shed in {steps} "
        f"steps (windows a step {[len(w) for w, _ in batches]}, step "
        f"latency ms {step_ms}), wall "
        f"{wall:.3f} s; deadline p99 {summ['p99_ms']:.2f} ms, miss_rate "
        f"{summ['miss_rate']:.3f}, shed {summ['shed']}, escalated "
        f"{summ['escalated']}, step EMA {summ['step_ema_ms']:.2f} ms; "
        f"engine lock held a step (median ms): host_decide "
        f"{held['host_decide']:.3f}, dispatch_enqueue "
        f"{held['dispatch_enqueue']:.3f}; "
        f"plan_log {gov.plan_log}; governor {gov.summary()}; warm-up "
        f"{warm_s:.3f} s ({n_warm} captures, every ladder level); captures "
        f"after warm-up {_captures_after(eng.graphs, n_warm)}; launches "
        f"{launches}")
    if eng.stats.windows + shed != S * T:
        raise AssertionError("governed: windows neither served nor shed")
    if not allow_shed and shed:
        raise AssertionError(f"governed, {label}: {shed} windows shed")
    if len(batches) != steps or len(levels) != steps:
        raise AssertionError(f"governed: {steps} steps, {len(batches)} "
                             f"recorded, {len(levels)} plans logged")
    _require_launched("governed", launches,
                      ("packed_hamming_batched", "bank_prefix_hamming"))

    # window seq k is stream k % S's window k // S (one submitting thread)
    ctxs = sorted(tracer.completed(), key=lambda c: c.seq)
    if [c.stream_id for c in ctxs] != [f"cam{k % S}" for k in range(S * T)]:
        raise AssertionError("governed: traced windows out of order")
    shed_seqs = {c.seq for c in ctxs if c.decision == "shed"}

    class Replay(StreamEngine):
        qd_next = None

        def _assemble(self, gate=None):
            # a slot's queue holds its shed windows, then the served one
            q, v, b, qd, served = super()._assemble(
                lambda _sid, backlog, _extra:
                    GATE_SHED if backlog else GATE_ADMIT)
            qd.copy_(torch.from_numpy(self.qd_next))
            return q, v, b, qd, served

    replay = Replay(cfg, sys_.im, n_slots=S)
    _admit_all(replay, sys_, S)
    ladder = build_ladder(cfg)
    fed, got = [0] * S, {sid: [] for sid in res}
    for (seqs, qd), level in zip(batches, levels):
        for seq in seqs:
            s, t = seq % S, seq // S
            if any(u * S + s not in shed_seqs for u in range(fed[s], t)):
                raise AssertionError(f"governed: cam{s} window {t} served "
                                     f"past an unshed window")
            for u in range(fed[s], t + 1):
                replay.submit(*window(s, u))
            fed[s] = t + 1
        replay.qd_next = qd
        replay.set_plan(ladder[level])
        out = replay.step()
        if sorted(out) != sorted(f"cam{seq % S}" for seq in seqs):
            raise AssertionError("governed replay: another batch assembled")
        for sid, r in out.items():
            got[sid].append(r)
    replay.sync()
    for sid in res:
        if len(got[sid]) != len(res[sid]):
            raise AssertionError(f"governed replay {sid}: {len(got[sid])} "
                                 f"windows, {len(res[sid])} served")
    _assert_results_equal("governed replay", res, got, skip=LOWERING_FIELDS)
    _assert_caches_equal("governed replay", cache, replay.state.cache)
    log(f"[governed, {label}] replayed on a fresh sync prefix engine, "
        f"each step's windows, queue depths and plan (levels {levels}) as "
        f"served: every "
        f"served window and the final caches bit-equal")
    return levels


def _drain_timed(run, profile):
    """``run`` on the host clock; with ``profile`` under torch.profiler,
    its wall time still taken around ``run`` alone inside the profiled
    region (the profiler's start and the processing of its trace left
    out), beside the device busy ms of that same run. Returns (seconds,
    busy ms or None)."""
    wall = []

    def timed():
        t0 = time.perf_counter()
        run()
        wall.append(time.perf_counter() - t0)

    busy = _device_busy_ms(timed) if profile else timed()
    return wall[0], busy


def _sync_pass(eng, sys_, frames, words, T, profile=False):
    """Every window queued first, then ``step`` until drained and one
    sync, on the host clock (or, with ``profile``, under torch.profiler:
    the device busy ms); the streams retired after. Returns the results,
    the final cache, the seconds and the device busy ms (None)."""
    from repro_torch.perf.profile_step import submit_step

    S = len(frames)
    _admit_all(eng, sys_, S)
    for t in range(T):
        submit_step(eng, frames, t, words[t])
    res = {f"cam{s}": [] for s in range(S)}

    def run():
        while eng.busy:
            for sid, r in eng.step().items():
                res[sid].append(r)
        eng.sync()

    wall, busy = _drain_timed(run, profile)
    cache = eng.state.cache
    for s in range(S):
        eng.retire(f"cam{s}")
    return res, cache, wall, busy


def _async_pass(cfg, sys_, frames, words, T, profile=False, **kw):
    """A paused ``AsyncStreamEngine`` (warmed up, its workers started after
    every window is queued) over the same windows: from ``start`` to the
    end of ``flush`` on the host clock (or under torch.profiler). Returns
    the host results, the final cache, the seconds, the device busy ms,
    the launches, the engine and its captures after the warm-up."""
    from repro_torch.kernels import build
    from repro_torch.serving.async_engine import AsyncStreamEngine

    S = len(frames)
    eng = AsyncStreamEngine(cfg, sys_.im, n_slots=S, paused=True, **kw)
    try:
        eng.warmup()
        n_warm = len(eng.graphs.captures)
        _admit_all(eng, sys_, S)
        futs = _submit_futures(eng, frames, words, T)
        build.reset_launches()

        def run():
            eng.start()
            eng.flush(timeout=600)
            torch.cuda.synchronize()

        wall, busy = _drain_timed(run, profile)
        launches = dict(build.LAUNCHES)
        res = {sid: [f.result(timeout=60) for f in fs]
               for sid, fs in futs.items()}
        cache = eng.state.cache
    finally:
        eng.close()
    return (res, cache, wall, busy, launches, eng,
            _captures_after(eng.graphs, n_warm))


def phase_async(cfg, sys_, cases, runs):
    """Async == sync (phase 9a): ``AsyncStreamEngine(paused=True,
    tracker=None)`` on the prefix and compact lowerings over both traffics'
    packed words of phases 3 and 4, and the serial switch engine over the
    served traffic's first window a stream (its profiled step alone takes
    some 15 s): every output, telemetry field and final cache bit-equal to
    that lowering's captured sync run of phases 3-5 (serial switch: to a
    captured sync engine's drain of the same windows). Each
    engine's ms/step and windows/s (every window queued first: the drain
    to its sync, the workers' start to the end of ``flush``), then the
    same run again under torch.profiler: its device busy ms and, against
    its own wall time, the idle share (1 - busy / wall); one summary
    line."""
    from repro_torch.kernels import build
    from repro_torch.serving.stream_engine import StreamEngine

    by_label = {r["label"]: r for r in runs}
    rows = []
    for label, frames, words, T, ref_label, kernels, kw in cases:
        t_case = time.perf_counter()
        S = len(frames)
        sync = StreamEngine(cfg, sys_.im, n_slots=S, **kw)
        sync.warmup()
        build.reset_launches()
        res_s, cache_s, wall_s, _ = _sync_pass(sync, sys_, frames, words, T)
        _require_launched(f"{label} sync", dict(build.LAUNCHES), kernels)
        _, _, pwall_s, busy_s = _sync_pass(sync, sys_, frames, words, T,
                                           profile=True)
        res_a, cache_a, wall_a, _, launches, eng, captured = _async_pass(
            cfg, sys_, frames, words, T, **kw)
        _require_launched(f"{label} async", launches, kernels)
        # the lowering's captured sync run of phases 3-5 where there is
        # one (the same windows queued the same way), else this drain
        what, other, other_cache = (
            ("the sync drain", res_s, cache_s) if ref_label is None else
            (f"the captured sync run '{ref_label}'",
             by_label[ref_label]["res"], by_label[ref_label]["cache"]))
        _assert_results_equal(f"{label} async vs {what}", res_a, other)
        _assert_caches_equal(f"{label} async vs {what}", cache_a,
                             other_cache)
        _, _, pwall_a, busy_a, *_ = _async_pass(cfg, sys_, frames, words, T,
                                                profile=True, **kw)
        steps = eng.stats.steps
        row = dict(label=label, steps=steps, windows=eng.stats.windows,
                   sync_ms_per_step=1e3 * wall_s / steps,
                   async_ms_per_step=1e3 * wall_a / steps,
                   sync_windows_per_s=eng.stats.windows / wall_s,
                   async_windows_per_s=eng.stats.windows / wall_a,
                   sync_busy_ms=busy_s, async_busy_ms=busy_a,
                   sync_profiled_ms=1e3 * pwall_s,
                   async_profiled_ms=1e3 * pwall_a,
                   sync_idle=1.0 - busy_s / (1e3 * pwall_s),
                   async_idle=1.0 - busy_a / (1e3 * pwall_a),
                   captures_after_warmup=captured)
        rows.append(row)
        log(f"[async == sync] {label}: outputs, telemetry and final caches "
            f"bit-equal to {what}; "
            f"{steps} steps, ms/step sync {row['sync_ms_per_step']:.2f} / "
            f"async {row['async_ms_per_step']:.2f}, windows/s "
            f"{row['sync_windows_per_s']:.1f} / "
            f"{row['async_windows_per_s']:.1f}; profiled run: device busy "
            f"ms {busy_s:.2f} / {busy_a:.2f} of wall ms "
            f"{row['sync_profiled_ms']:.2f} / {row['async_profiled_ms']:.2f}"
            f", idle share "
            f"{row['sync_idle']:.4f} / {row['async_idle']:.4f}; captures "
            f"after the async warm-up {captured}; launches {launches}; "
            f"{time.perf_counter() - t_case:.1f} s")
    log("[async vs sync] ms/step sync / async: " + "; ".join(
        f"{r['label']} {r['sync_ms_per_step']:.2f} / "
        f"{r['async_ms_per_step']:.2f}" for r in rows))
    return rows


def phase_launcher():
    """The port's launcher once (phase 9b): ``run_torr_streams(16, 4,
    rt="RT-60", governor=True)`` with the three artifacts into a temporary
    directory; every submitted window served or shed, at least one served,
    all three artifacts parse, and the launches counted after the engine's
    warm-up (which captures and replays every ladder level) show the
    encode once a stream and ``bank_prefix_hamming`` once a served step."""
    import tempfile

    from repro_torch.launch.serve import run_torr_streams
    from repro_torch.obs import load_jsonl

    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: str(Path(tmp) / name) for k, name in (
            ("metrics_json", "metrics.json"), ("flight_jsonl", "flight.jsonl"),
            ("trace_json", "trace.json"))}
        t0 = time.perf_counter()
        res = run_torr_streams(STREAMS, WINDOWS, rt=GOVERNED_RT,
                               governor=True, **paths)
        wall = time.perf_counter() - t0
        launches = res["launches"]
        snap = json.loads(Path(paths["metrics_json"]).read_text())
        recs = load_jsonl(paths["flight_jsonl"])
        doc = json.loads(Path(paths["trace_json"]).read_text())
    if res["lost"] or res["served"] + res["shed"] != res["submitted"] \
            or res["submitted"] != STREAMS * WINDOWS or not res["served"]:
        raise AssertionError(f"launcher: {res['submitted']} submitted, "
                             f"{res['served']} served, {res['shed']} shed")
    # the prefix lowering's graph holds one bank_prefix_hamming node
    if launches["sign_project_pack"] < STREAMS or res["steps"] < 1 or \
            launches["bank_prefix_hamming"] < res["steps"]:
        raise AssertionError(f"launcher: {res['steps']} steps served, "
                             f"launches after the warm-up {launches}")
    steps = [r for r in recs if "n_windows" in r]
    if sum(r["n_windows"] for r in steps) != res["served"] or \
            not doc["traceEvents"] or \
            snap["metrics"]["torr_windows_total"]["series"][0]["value"] \
            != res["served"]:
        raise AssertionError("launcher: artifacts disagree with the run")
    log(f"[launcher] run_torr_streams({STREAMS}, {WINDOWS}, rt="
        f"{GOVERNED_RT}, governor=True) on the card: {res['submitted']} "
        f"submitted, {res['served']} served, {res['shed']} shed, 0 lost; "
        f"{len(steps)} flight records, {len(doc['traceEvents'])} trace "
        f"events, {len(snap['metrics'])} metric families; {wall:.2f} s "
        f"with the build of its system; {res['steps']} steps; launches "
        f"after the warm-up {launches}")


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
    rates = Rates()
    im_cuda = sys_.im.to("cuda")
    report = phase_kernels(cfg, im_cuda, rates)
    done("kernels")

    served = edge_windows(world, cfg, STREAMS, WINDOWS, cfg.N_max)
    reuse = edge_windows(world, cfg, STREAMS, REUSE_WINDOWS, cfg.K)
    runs = []            # the captured runs phase_eager repeats eagerly
    base = phase_serving(cfg, sys_, served, report, "serve", CPU_WINDOWS,
                         runs)
    base_reuse = phase_serving(cfg, sys_, reuse, report,
                               f"reuse, windows cut to K={cfg.K} proposals",
                               CPU_WINDOWS, runs)
    mix = _path_mix(reuse, base_reuse[0])
    if mix["bypass"] <= 0 or mix["delta"] <= 0:
        raise AssertionError("reuse traffic: no bypass or no delta after "
                             "the first windows")
    done("serving (prefix, with its two CPU references)")

    switch = (FUSED_SWITCH, DECIDE_NONE, 0)
    compact = (FUSED_COMPACT, DECIDE_BATCHED, None)
    prefix = (FUSED_PREFIX, DECIDE_NONE, 0)
    _, res = phase_lowering(
        cfg, sys_, served, report, "serial switch, served", base,
        ("fused_scores", "delta_update"), (switch,), runs,
        n_windows=SERIAL_WINDOWS, serial=True)
    _delta_median(cfg, im_cuda.dmajor, _delta_fill_counts(cfg, served, res),
                  report, rates)
    phase_lowering(cfg, sys_, reuse, report, "serial switch, reuse",
                   base_reuse, ("fused_scores", "delta_update"), (switch,),
                   runs, n_windows=SERIAL_WINDOWS, serial=True)
    full_tier = (FUSED_COMPACT, DECIDE_BATCHED, STREAMS * cfg.N_max)
    scan_tier = (FUSED_COMPACT, DECIDE_SCAN, STREAMS * cfg.N_max)
    compact_kernels = ("packed_hamming_batched", "bank_prefix_hamming")
    tiers = set()
    for traffic, b, frames in (("served", base, served),
                               ("reuse", base_reuse, reuse)):
        seen, _ = phase_lowering(cfg, sys_, frames, report,
                                 f"compact, {traffic}", b, compact_kernels,
                                 (full_tier,), runs, fused="compact")
        tiers.update(e[2] for e in seen if e[0] == FUSED_COMPACT)
        phase_lowering(cfg, sys_, frames, report, f"compact scan, {traffic}",
                       b, ("bank_prefix_hamming", "delta_update"),
                       (scan_tier,), runs, fused="compact", decide="scan")
        seen, _ = phase_lowering(
            cfg, sys_, frames, report, f"auto, {traffic}", b,
            ("bank_prefix_hamming",), (prefix, compact), runs, fused="auto")
        tiers.update(e[2] for e in seen if e[0] == FUSED_COMPACT)
        if traffic == "reuse" and not any(e[0] == FUSED_COMPACT
                                          for e in seen):
            raise AssertionError("auto never reached the compact lowering "
                                 "on the reuse traffic")
    _prefix_tiers(cfg, im_cuda.packed, tiers, report, rates)
    done("lowerings (serial switch, compact, compact scan, auto)")
    phase_evaluate(cfg, world, sys_)
    done("evaluate")
    phase_sign_project(sys_, served, report)
    rows = phase_plans(cfg, sys_, served, reuse, runs)
    done("plan ladder")
    phase_governed(cfg, sys_, reuse)
    done("governed (async)")
    async_rows = phase_async(cfg, sys_, (
        ("prefix, served", served, base[2], WINDOWS, "serve",
         ("bank_prefix_hamming",), {}),
        ("prefix, reuse", reuse, base_reuse[2], REUSE_WINDOWS,
         f"reuse, windows cut to K={cfg.K} proposals",
         ("bank_prefix_hamming",), {}),
        ("compact, served", served, base[2], WINDOWS, "compact, served",
         compact_kernels, dict(fused="compact")),
        ("compact, reuse", reuse, base_reuse[2], REUSE_WINDOWS,
         "compact, reuse", compact_kernels, dict(fused="compact")),
        ("serial switch, served", served, base[2], 1, None,
         ("fused_scores", "delta_update"), dict(serial=True))), runs)
    done("async == sync")
    phase_launcher()
    done("launcher")
    phase_eager(runs)
    done("eager == captured")
    phase_plan_idle(cfg, sys_, served, rows)
    done("plan ladder idle share")
    missing = [n for n, r in report.items() if "launches" not in r]
    if missing:
        raise AssertionError(f"never launched on a path: {missing}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"plan_ladder": rows}))
    print(json.dumps({"async_vs_sync": async_rows}))
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
