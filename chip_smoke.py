"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero without
printing its result line):

  1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
     and the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, all at once);
  2. every kernel against its plain PyTorch version on the card, at the
     serving path's shapes (bit-equal; ``sign_project_pack`` under its
     agreement rule), timed with CUDA events (median of 20 after warm-up)
     beside the plain version, a PyTorch library call where one exists, and
     the least time the card could take (``bound_ms``);
  3. serving at the edge config (``torr_edge()``): 16 streams in 16 slots,
     4 windows each of the traffic ``launch/serve.py`` serves
     (``simulate_sequence`` with up to N_max proposals), features ->
     ``ops.encode_packed`` on the card -> ``StreamEngine.submit`` ->
     ``drain`` -> ``sync``, with every kernel's launch count read around
     that run and the proposals' path mix printed; the outputs, telemetry
     and final caches must be bit-equal to the same engine run on the CPU
     (the plain versions) on the same packed queries;
  4. a reuse check on the same streams cut to K proposals per window (K is
     the cache depth): bypass and delta must both occur after each stream's
     first window, and the card must again equal the CPU engine.

The line before the last is the per-kernel JSON report; the last line is
``{"ok": true, "device": {...}}``.
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
# 32-bit integer adds or bitwise ops, 16 population counts
INT32_PER_CLK, POPC_PER_CLK = 64, 16
REPS = 20


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


def phase_kernels(cfg, im_cuda):
    """Every kernel vs its plain version on the card, then timed."""
    from repro_torch.core import aligner
    from repro_torch.device import smi
    from repro_torch.kernels import fused_window as fw
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(11)
    report = {}

    def words(n, w):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n, w), generator=gen,
                             dtype=torch.int32).to(dev)

    # bank_prefix_hamming: the hoisted S x N_max batch at full precision,
    # a reduced plan (planes=2, cap=4) through the column selection, and a
    # ragged shape
    S = 16
    N, W = S * cfg.N_max, cfg.words
    q = words(N, W)
    im_w = im_cuda.packed
    for label, (qq, hh, cap) in {
        "main": (q, im_w, cfg.B),
        "plan(planes=2,cap=4)": aligner._plan_columns_bank_major(
            q, im_cuda, 4, 2, cfg) + (4,),
        "ragged(N=37,M=1000)": (words(37, W), im_w[:1000], cfg.B),
    }.items():
        qq, hh = qq.contiguous(), hh.contiguous()
        got = fw.bank_prefix_hamming(qq, hh, cap=cap)
        want = ref.bank_prefix_hamming_ref(qq, hh, cap=cap)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want).abs().max())
        log(f"[kernel] bank_prefix_hamming {label}: q {tuple(qq.shape)} "
            f"im {tuple(hh.shape)} cap {cap} max_abs_err {err}")
        if not bits_equal(got, want):
            raise AssertionError(f"bank_prefix_hamming {label} != plain")
        if label == "main":
            main_err = err
    M = im_w.shape[0]
    ms = cuda_ms(lambda: fw.bank_prefix_hamming(q, im_w, cap=cfg.B))
    plain_ms = cuda_ms(lambda: ref.bank_prefix_hamming_ref(q, im_w,
                                                           cap=cfg.B))
    # each input read once, the [N, M, cap] counts written once; every one
    # of the N*M*W word pairs takes a xor, a popcount and an add, issued on
    # this card's SMs at its highest SM clock; the slower of the popcount
    # and the integer pipe bounds it
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clk = float(smi("clocks.max.sm").split()[0]) * 1e6     # "1980 MHz"
    pairs = N * M * W
    t_ops = max(pairs / (sms * POPC_PER_CLK * clk),
                2 * pairs / (sms * INT32_PER_CLK * clk))
    log(f"[bound] bank_prefix_hamming: {sms} SMs at {clk / 1e6:.0f} MHz, "
        f"{pairs} word pairs: popcount {1e3 * t_ops:.4f} ms")
    b_ms, b_by = bound(4 * (N * W + M * W + N * M * cfg.B), t_ops)
    report["bank_prefix_hamming"] = dict(
        name="bank_prefix_hamming", route="cuda",
        source="src/repro_torch/kernels/csrc/bank_prefix_hamming.cu",
        replaces="src/repro/kernels/fused_window.py:253",
        max_abs_err=main_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)

    # sign_project_pack: one step's worth of proposals (S x N_max rows)
    d, D = cfg.feat_dim, cfg.D
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
    from repro_torch.core import hdc
    code_err = int((hdc.unpack_bits(got, D).to(torch.int32)
                    - hdc.unpack_bits(want, D).to(torch.int32)).abs().max())
    ms = cuda_ms(lambda: fw.sign_project_pack(z, R))
    plain_ms = cuda_ms(lambda: ref.sign_project_pack_ref(z, R))
    # the one library call: the float32 product alone (cuBLAS, TF32 off);
    # no PyTorch call computes the signs and packs them
    library_ms = cuda_ms(lambda: torch.matmul(z, R.T))
    b_ms, b_by = bound(4 * (N * d + D * d + N * D // 32),
                       2 * N * D * d / PEAK_FP32_S)
    report["sign_project_pack"] = dict(
        name="sign_project_pack", route="cuda",
        source="src/repro_torch/kernels/csrc/sign_project_pack.cu",
        replaces="src/repro/kernels/fused_window.py:382",
        max_abs_err=code_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=library_ms)
    for r in report.values():
        log(f"[time] {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return report


def _serve_card(cfg, sys_, frames):
    """Serve ``frames`` (S streams in S slots) through the card's engine:
    features -> ``encode_packed`` -> ``submit`` -> ``drain`` -> ``sync``.
    Returns the engine, its per-stream results, each step's packed words
    and the wall seconds (encode included)."""
    from repro_torch.perf.profile_step import encode_step, submit_step
    from repro_torch.serving.stream_engine import StreamEngine

    S = len(frames)
    R = torch.as_tensor(sys_.R).cuda()
    eng = StreamEngine(cfg, sys_.im, n_slots=S)
    eng.warmup()
    eng.sync()
    t0 = time.perf_counter()
    for s in range(S):
        eng.admit(f"cam{s}", sys_.task_w[s % sys_.task_w.shape[0]])
    words = []
    for t in range(len(frames[0])):    # one encode call per step
        words.append(encode_step(frames, t, R))
        submit_step(eng, frames, t, words[-1])
    res = eng.drain()
    eng.sync()
    return eng, res, words, time.perf_counter() - t0


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


def _equal_to_cpu(cfg, sys_, frames, eng, res, words, label):
    """The same engine on the CPU (plain versions), fed the card's packed
    words, must give bit-equal outputs, telemetry and final caches."""
    from repro_torch.perf.profile_step import submit_step
    from repro_torch.serving.stream_engine import StreamEngine

    t0 = time.perf_counter()
    S = len(frames)
    cpu = StreamEngine(cfg, sys_.im, n_slots=S, device="cpu")
    for s in range(S):
        cpu.admit(f"cam{s}", sys_.task_w[s % sys_.task_w.shape[0]])
    for t, w in enumerate(words):
        submit_step(cpu, frames, t, w.cpu())
    res_cpu = cpu.drain()
    log(f"[{label}] cpu reference engine: {time.perf_counter() - t0:.1f} s")
    for s in range(S):
        if len(res[f"cam{s}"]) != len(words):
            raise AssertionError(f"{label} cam{s}: {len(res[f'cam{s}'])} "
                                 f"windows")
        for t, ((o, tel), (oc, telc)) in enumerate(zip(res[f"cam{s}"],
                                                       res_cpu[f"cam{s}"])):
            for obj, objc in ((o, oc), (tel, telc)):
                for f in dataclasses.fields(obj):
                    if not bits_equal(getattr(obj, f.name),
                                      getattr(objc, f.name)):
                        raise AssertionError(
                            f"{label} cam{s} window {t}: "
                            f"{type(obj).__name__}.{f.name} differs between "
                            f"the card and the CPU")
    for f in dataclasses.fields(eng.state.cache):
        if not bits_equal(getattr(eng.state.cache, f.name),
                          getattr(cpu.state.cache, f.name)):
            raise AssertionError(f"{label} final cache.{f.name} differs")
    log(f"[{label}] card engine == CPU engine: outputs, telemetry and final "
        f"caches bit-equal")


def phase_serving(cfg, sys_, world, report):
    """The main path: 16 streams x 4 windows of the traffic
    ``launch/serve.py`` serves (``simulate_sequence`` with up to N_max
    proposals), on the card, timed, with every kernel's launches counted,
    then checked bit-equal to the CPU engine."""
    from repro_torch.kernels import fused_window as fw
    from repro_torch.perf.profile_step import edge_windows

    S, T = 16, 4
    frames = edge_windows(world, cfg, S, T, cfg.N_max)
    fw.reset_launches()
    eng, res, words, wall = _serve_card(cfg, sys_, frames)
    launches = dict(fw.LAUNCHES)
    log(f"[serve] launches on the main path: {launches}")
    for name, r in report.items():
        r["launches"] = launches[name]
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    n_valid = [int(f.valid.sum()) for fr in frames for f in fr]
    log(f"[serve] valid proposals per window {min(n_valid)}-{max(n_valid)} "
        f"(cache depth K={cfg.K}); after each stream's first window, by "
        f"path: {_path_mix(frames, res)}")
    for s in range(S):
        for out, _ in res[f"cam{s}"]:
            if out.scores.shape != (cfg.N_max, cfg.M) or \
                    not bool(torch.isfinite(out.scores).all()):
                raise AssertionError(f"cam{s}: bad scores")
    log(f"[serve] {torch.cuda.get_device_name(0)}: {eng.stats.windows} "
        f"windows in {wall:.3f} s = {eng.stats.windows / wall:.1f} "
        f"windows/s, {1e3 * wall / eng.stats.steps:.1f} ms/step "
        f"(encode included)")
    _equal_to_cpu(cfg, sys_, frames, eng, res, words, "serve")


def phase_reuse(cfg, sys_, world):
    """Reuse check, on traffic cut to K proposals per window: with more
    valid proposals than the K cache entries, a window evicts its own
    entries before the next window can match them, so the main path's
    traffic may reuse nothing. Here bypass and delta must both occur after
    each stream's first window, and the card must equal the CPU engine on
    those paths too."""
    from repro_torch.perf.profile_step import edge_windows

    frames = edge_windows(world, cfg, 16, 4, cfg.K)
    eng, res, words, _ = _serve_card(cfg, sys_, frames)
    mix = _path_mix(frames, res)
    log(f"[reuse, windows cut to K={cfg.K} proposals] after each stream's "
        f"first window, by path: {mix}")
    if mix["bypass"] <= 0 or mix["delta"] <= 0:
        raise AssertionError("no bypass or no delta after the first windows")
    _equal_to_cpu(cfg, sys_, frames, eng, res, words, "reuse")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.torr_edge import torr_edge
    from repro_torch.data import tood_synth as ts
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
    phase_serving(cfg, sys_, world, report)
    phase_reuse(cfg, sys_, world)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
