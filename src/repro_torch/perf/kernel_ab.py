"""Same-call A/B of the port's hamming and switch kernels across checkouts.

    python -m repro_torch.perf.kernel_ab --trees parent=.archive/parent,change=.
    python -m repro_torch.perf.kernel_ab --trees ... --kernels bank_prefix_hamming

Loads the port's package from each checkout's ``src/`` under its own
modules (each builds its kernels from its own ``csrc/`` into its own
``_build/``), holds every checkout's ``delta_update``, ``fused_scores``,
``bank_prefix_hamming`` and ``packed_hamming_batched`` bit-equal to the
plain version of its own checkout at the shapes below and at their edge
cases, then times each timed shape with the checkouts in turns:

* ``call_ms``: one wrapper call between CUDA events, the checkouts
  alternating call by call (REPS calls each; median, p10, p90);
* ``host_us``: the host time of 100 wrapper calls issued back to back,
  per call (alternating rounds; median);
* ``device_ms``: 20 calls captured in one CUDA graph, replayed (alternating
  rounds; median per call).

Prints the card's name and power limit, one JSON object per timed shape,
and a last line ``{"ok": true}``. Needs a GPU.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from ..device import smi

PKG = "repro_torch"
D, M, W, BUDGET, N_MAX, STREAMS = 8192, 1024, 256, 2048, 128, 16
CACHE_K, BANKS = 8, 8
REPS = 300
KERNELS = ("delta_update", "fused_scores", "bank_prefix_hamming",
           "packed_hamming_batched")
# the compact bucket tiers (rows) that chip_smoke.py's compact and auto
# runs launch, as their bucket_tier telemetry shows them; 2048 is also
# the prefix step's launch and the compact step's on overflow
TIERS = (1024, 2048)


def load_tree(path: Path):
    """(delta_update, fused_window, ref, xnor_popcount_sim) modules of the
    checkout at ``path``, imported apart from every other checkout's."""
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k == PKG or k.startswith(PKG + ".")}
    sys.path.insert(0, str(path.resolve() / "src"))
    try:
        mods = tuple(importlib.import_module(f"{PKG}.kernels.{m}")
                     for m in ("delta_update", "fused_window", "ref",
                               "xnor_popcount_sim"))
        build = importlib.import_module(f"{PKG}.kernels.build")
        build.build_all()
    finally:
        sys.path.pop(0)
        for k in [k for k in sys.modules
                  if k == PKG or k.startswith(PKG + ".")]:
            del sys.modules[k]
        sys.modules.update(saved)
    return mods


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def call_times(fns: dict, reps: int) -> dict:
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    names = list(fns)
    for r in range(reps):
        for k in names[r % len(names):] + names[:r % len(names)]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[k]()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return {k: dict(call_ms=statistics.median(v), call_p10=_pct(v, 0.1),
                    call_p90=_pct(v, 0.9)) for k, v in times.items()}


def host_times(fns: dict, rounds=20, calls=100) -> dict:
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[k].append(1e6 * (time.perf_counter() - t0) / calls)
            torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}


def device_times(fns: dict, rounds=10, calls=20) -> dict:
    graphs = {}
    for k, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        g.replay()
        graphs[k] = g
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, g in graphs.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / calls)
    return {k: statistics.median(v) for k, v in times.items()}


def delta_inputs(gen, L, fills, K=BUDGET, m=M):
    """acc, dmajor, idx, w as ``aligner.delta_indices`` lays rows out: the
    first ``fills[l]`` entries of row l weighted at ascending dims."""
    idx = torch.zeros((L, K), dtype=torch.int32)
    w = torch.zeros((L, K), dtype=torch.int32)
    for r, n in enumerate(fills):
        idx[r, :n] = torch.randperm(D, generator=gen)[:n].sort().values
        w[r, :n] = torch.randint(0, 2, (n,), generator=gen) * 4 - 2
    acc = torch.randint(-4000, 4000, (L, m), generator=gen, dtype=torch.int32)
    return acc, idx, w


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", required=True,
                    help="name=path,... of checkouts to compare")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma list of the kernels to check and time")
    args = ap.parse_args(argv)
    kernels = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a GPU")
    print(smi("name,power.limit"), flush=True)
    trees = {}
    for item in args.trees.split(","):
        name, path = item.split("=", 1)
        trees[name] = load_tree(Path(path))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(15)
    dmajor = (torch.randint(0, 2, (D, M), generator=gen, dtype=torch.int8)
              * 2 - 1).to(dev)
    imw = torch.randint(-2 ** 31, 2 ** 31 - 1, (M, W), generator=gen,
                        dtype=torch.int32).to(dev)

    def dcase(L, fills, K=BUDGET, m=M):
        acc, idx, w = delta_inputs(gen, L, fills, K, m)
        dm = dmajor if m == M else dmajor[:, :m].contiguous()
        return acc.to(dev), dm, idx.to(dev), w.to(dev)

    half = dcase(STREAMS, [0 if r % 5 == 0 else BUDGET // 2
                           for r in range(STREAMS)])
    timed_delta = {
        "L=1,nnz=2048": dcase(1, [BUDGET]),
        "L=1,nnz=1": dcase(1, [1]),
        "L=16,nnz=2048": dcase(STREAMS, [BUDGET] * STREAMS),
        "L=16,nnz=1, last row padding": dcase(STREAMS, [1] * 15 + [0]),
        "main(L=16,budget=2048)": half,
    }
    oor = dcase(2, [40, BUDGET])
    oor[2][0, :3] = torch.tensor([-5, D + 100, 2 ** 31 - 1], device=dev)
    oor[3][0, :3] = torch.tensor([2, -2, 2], device=dev)
    neg = dcase(2, [40, BUDGET])
    neg[2][0, :5] = torch.tensor([-1, -5, -D, -D - 3, D + 6], device=dev)
    neg[3][0, :5] = torch.tensor([2, -2, 2, -2, 2], device=dev)
    check_delta = dict(timed_delta, **{
        "ragged(M=1001)": dcase(STREAMS, [BUDGET // 2] * STREAMS, m=1001),
        "indices out of range, weighted": oor,
        "negative indices -1, -5, -D, -D-3 and D+6, weighted": neg,
        "K=1": dcase(STREAMS, [1] * STREAMS, K=1),
        "K=1001": dcase(STREAMS, [1001, 500] * (STREAMS // 2), K=1001),
        "L=1, all padding": dcase(1, [0]),
    })
    qs = {n: torch.randint(-2 ** 31, 2 ** 31 - 1, (n, W), generator=gen,
                           dtype=torch.int32).to(dev)
          for n in (N_MAX, STREAMS * N_MAX, 37)}
    timed_fused = {f"N={n}": (qs[n], imw, 32 * W)
                   for n in (N_MAX, STREAMS * N_MAX)}
    check_fused = dict(timed_fused, **{
        "ragged(N=37,M=1000,W=96)": (qs[37][:, :96].contiguous(),
                                     imw[:1000, :96].contiguous(), 3072),
        "ragged(N=128,M=1001,W=37)": (qs[N_MAX][:, :37].contiguous(),
                                      imw[:1001, :37].contiguous(), 1184),
        "M=1": (qs[N_MAX], imw[:1].contiguous(), 32 * W),
        "tied(a copy in every 128-class tile)": (
            qs[N_MAX], imw[:128].repeat(M // 128, 1).contiguous(), 32 * W),
        "tied(adjacent copies)": (
            qs[N_MAX], imw[:M // 2].repeat_interleave(2, 0).contiguous(),
            32 * W),
    })

    words = lambda *shape: torch.randint(   # noqa: E731
        -2 ** 31, 2 ** 31 - 1, shape, generator=gen, dtype=torch.int32
    ).to(dev)
    qp = words(STREAMS * N_MAX, W)
    timed_prefix = {f"N={n},W={W},cap={BANKS}": (qp[:n], imw, BANKS)
                    for n in sorted({STREAMS * N_MAX, *TIERS})}
    timed_prefix.update({
        f"N={STREAMS * N_MAX},W=64,cap=8 (plan (8,1))": (
            qp[:, :64].contiguous(), imw[:, :64].contiguous(), 8),
        f"N={STREAMS * N_MAX},W=8,cap=1 (plan (1,1))": (
            qp[:, :8].contiguous(), imw[:, :8].contiguous(), 1)})
    ones = torch.full((45, 40), -1, dtype=torch.int32, device=dev)
    zmask = torch.arange(40, device=dev) % 3 == 1
    q40, h40 = words(45, 40), words(77, 40)
    check_prefix = dict(timed_prefix)
    for cap in (1, 5, 8):
        check_prefix.update({
            f"ragged(N=37,M=1001,W=40,cap={cap})": (
                words(37, 40), words(1001, 40), cap),
            f"all ones x all zeros, cap={cap}": (
                ones, torch.zeros_like(h40), cap),
            f"equal rows, cap={cap}": (q40, q40.repeat(2, 1)[:77], cap),
            f"masked words zeroed on both sides, cap={cap}": (
                torch.where(zmask, 0, q40), torch.where(zmask, 0, h40), cap)})
    qb, eb = words(STREAMS, N_MAX, W), words(STREAMS, CACHE_K, W)
    timed_batched = {
        f"snapshot([{STREAMS},{N_MAX}]x[{STREAMS},{CACHE_K}])": (qb, eb),
        f"proposals([{STREAMS},{N_MAX}]x[{STREAMS},{N_MAX}])": (qb, qb)}
    check_batched = dict(timed_batched, **{
        "ragged([3,37]x[3,5],W=40)": (words(3, 37, 40), words(3, 5, 40)),
        "ragged([3,37]x[3,1],W=40)": (words(3, 37, 40), words(3, 1, 40)),
        "ragged([2,37]x[2,8],W=8)": (words(2, 37, 8), words(2, 8, 8)),
        "2-D [37,40]x[77,40]": (words(37, 40), words(77, 40)),
        "all ones x all zeros": (ones[None, :37], torch.zeros_like(
            h40[None, :8])),
        "masked words zeroed on both sides": (
            torch.where(zmask, 0, q40)[None], torch.where(zmask, 0, h40)[None]),
    })

    for name, (du, fw, ref, xps) in trees.items():
        checked = []
        if "delta_update" in kernels:
            for label, a in check_delta.items():
                if not torch.equal(du.delta_update(*a),
                                   ref.delta_update_ref(*a)):
                    raise AssertionError(f"{name} delta_update {label} "
                                         "!= plain")
            checked.append(f"delta_update at {len(check_delta)}")
        if "fused_scores" in kernels:
            for label, (q, h, de) in check_fused.items():
                got = fw.fused_scores(q, h, d_eff=de)
                want = ref.fused_scores_ref(q, h, d_eff=de)
                if not all(torch.equal(g, x) for g, x in zip(got, want)):
                    raise AssertionError(f"{name} fused_scores {label} "
                                         "!= plain")
            checked.append(f"fused_scores at {len(check_fused)}")
        if "bank_prefix_hamming" in kernels:
            for label, (q, h, cap) in check_prefix.items():
                q, h = q.contiguous(), h.contiguous()
                if not torch.equal(fw.bank_prefix_hamming(q, h, cap=cap),
                                   ref.bank_prefix_hamming_ref(q, h,
                                                               cap=cap)):
                    raise AssertionError(f"{name} bank_prefix_hamming "
                                         f"{label} != plain")
            checked.append(f"bank_prefix_hamming at {len(check_prefix)}")
        if "packed_hamming_batched" in kernels:
            for label, (q, h) in check_batched.items():
                q, h = q.contiguous(), h.contiguous()
                if not torch.equal(xps.packed_hamming_batched(q, h),
                                   ref.packed_hamming_ref(q, h)):
                    raise AssertionError(f"{name} packed_hamming_batched "
                                         f"{label} != plain")
            checked.append(f"packed_hamming_batched at {len(check_batched)}")
        print(f"[check] {name}: {', '.join(checked)} inputs == plain",
              flush=True)

    rows = []
    if "delta_update" in kernels:
        rows += [("delta_update", k,
                  {n: (lambda m=t[0], a=a: m.delta_update(*a))
                   for n, t in trees.items()})
                 for k, a in timed_delta.items()]
    if "fused_scores" in kernels:
        rows += [("fused_scores", k,
                  {n: (lambda m=t[1], c=c: m.fused_scores(c[0], c[1],
                                                          d_eff=c[2]))
                   for n, t in trees.items()})
                 for k, c in timed_fused.items()]
    if "bank_prefix_hamming" in kernels:
        rows += [("bank_prefix_hamming", k,
                  {n: (lambda m=t[1], c=c: m.bank_prefix_hamming(
                      c[0], c[1], cap=c[2])) for n, t in trees.items()})
                 for k, c in timed_prefix.items()]
    if "packed_hamming_batched" in kernels:
        rows += [("packed_hamming_batched", k,
                  {n: (lambda m=t[3], c=c: m.packed_hamming_batched(*c))
                   for n, t in trees.items()})
                 for k, c in timed_batched.items()]
    for kernel, label, fns in rows:
        res = call_times(fns, REPS)
        for k, v in host_times(fns).items():
            res[k]["host_us"] = v
        for k, v in device_times(fns).items():
            res[k]["device_ms"] = v
        print(json.dumps({"kernel": kernel, "shape": label, "trees": res}),
              flush=True)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
