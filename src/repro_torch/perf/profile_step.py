"""Where a serving step's time goes on one GPU (the port's counterpart of
``repro.perf.profile_cell``).

    PYTHONPATH=src python -m repro_torch.perf.profile_step \
        [--lowering prefix,serial,compact] [--traffic served,reuse] \
        [--jit eager,captured]

Serves the edge config's multi-stream workload (the one ``chip_smoke.py``
drives: 16 streams in 16 slots) through ``StreamEngine`` on each named
lowering — ``prefix`` (the batched step's default), ``serial`` (the serial
switch engine) and ``compact`` (the compact dispatch, batched decide) —
traffic — ``served``, windows from ``simulate_sequence`` as
``launch/serve.py`` makes them, or ``reuse``, the same streams cut to K
proposals per window — and step mode: ``eager`` (``jit=False``) or
``captured`` (``jit=True``, the step's segments replayed from CUDA
graphs). Each triple runs 2 untimed warm-up steps (a captured engine
captures its keys there), 3 steps timed on the host clock around
``sync()``, then one more step under ``torch.profiler``, and prints one
JSON object: the wall time per step, windows/s, the device busy time and
idle share of the profiled step, the kernels the device ran in it, the
CUDA runtime calls the host made (``host_launches``: kernel and graph
launches and copies), the graphs replayed and their kernel nodes (counted
at capture), the kernels that take the most device time, and the launches
and device time of each of the port's hand-written kernels, after the
card's name and power limit. The profile is read from the raw trace
events, so a serial step's half million launches take seconds, not
minutes. Needs a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..configs.torr_edge import torr_edge
from ..data import tood_synth as ts
from ..device import smi
from ..kernels import ops
from ..serving import tood_pipelines as tp
from ..serving.stream_engine import StreamEngine

STREAMS, WARMUP, STEPS, TOP = 16, 2, 3, 12
MODES = {"eager": False, "captured": True}
# the CUDA runtime calls that put work on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync")
# kernel (or kernels) -> the names of its device functions in csrc/
PORT_KERNELS = {
    name: (f"{name}_kernel",) for name in (
        "bank_prefix_hamming", "packed_hamming_batched", "fused_scores",
        "delta_update")}
PORT_KERNELS["sign_project_pack, sign_project"] = ("sign_wgmma_kernel",
                                                   "sign_mma_kernel")
LOWERINGS = {"prefix": {}, "serial": dict(serial=True),
             "compact": dict(fused="compact")}


def edge_windows(world, cfg, n_streams: int, n_windows: int, n_max: int):
    """Each stream's windows from ``simulate_sequence`` with at most
    ``n_max`` proposals, padded to ``cfg.N_max``. ``n_max=cfg.N_max`` is the
    traffic ``launch/serve.py`` serves; a smaller ``n_max`` cuts windows
    down (``chip_smoke.py``'s labelled reuse check keeps K)."""
    out = []
    pad = cfg.N_max - n_max
    for s in range(n_streams):
        frames = ts.simulate_sequence(world, s % world.relevance.shape[0],
                                      n_windows, seed=100 + s, n_max=n_max)
        out.append([dataclasses.replace(
            f, feats=np.pad(f.feats, ((0, pad), (0, 0))),
            boxes=np.pad(f.boxes, ((0, pad), (0, 0))),
            classes=np.pad(f.classes, (0, pad), constant_values=-1),
            valid=np.pad(f.valid, (0, pad))) for f in frames])
    return out


def encode_step(frames, t, R) -> torch.Tensor:
    """Step ``t``'s proposals of every stream in one encode call:
    [S * N_max, D/32] packed words on ``R``'s device."""
    feats = np.stack([fr[t].feats for fr in frames])
    return ops.encode_packed(feats.reshape(-1, feats.shape[-1]), R,
                             device=R.device)


def submit_step(eng, frames, t, words) -> None:
    """Submit each stream ``cam<s>`` its N_max rows of step ``t``'s words."""
    n = eng.cfg.N_max
    for s, fr in enumerate(frames):
        eng.submit(f"cam{s}", words[s * n:(s + 1) * n], fr[t].valid,
                   fr[t].boxes)


def profile(cfg, sys_, world, lowering: str, traffic: str,
            mode: str) -> dict:
    """One (lowering, traffic, mode): warm-up, timed steps, a profiled
    step."""
    T = WARMUP + STEPS + 1
    frames = edge_windows(world, cfg, STREAMS, T,
                          cfg.N_max if traffic == "served" else cfg.K)
    R = torch.as_tensor(sys_.R).cuda()
    eng = StreamEngine(cfg, sys_.im, n_slots=STREAMS, jit=MODES[mode],
                       **LOWERINGS[lowering])
    for s in range(STREAMS):
        eng.admit(f"cam{s}", sys_.task_w[s % sys_.task_w.shape[0]])

    def one(t):
        submit_step(eng, frames, t, encode_step(frames, t, R))
        eng.step()
        eng.sync()

    for t in range(WARMUP):
        one(t)
    walls = []
    for t in range(WARMUP, WARMUP + STEPS):
        t0 = time.perf_counter()
        one(t)
        walls.append(1e3 * (time.perf_counter() - t0))
    graphs = eng.graphs
    replays0, nodes0 = ((graphs.replays, graphs.nodes_replayed) if graphs
                        else (0, 0))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        one(T - 1)
        prof_wall = 1e3 * (time.perf_counter() - t0)
    kernels, calls = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name(), [0, 0])
            k[0] += 1
            k[1] += e.duration_ns()
        elif e.name().startswith("cuda"):
            calls[e.name()] = calls.get(e.name(), 0) + 1
    busy_ms = sum(ns for _, ns in kernels.values()) / 1e6
    if busy_ms <= 0:
        raise SystemExit("the profiler recorded no device time")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    wall = float(np.median(walls))
    return {
        "device": torch.cuda.get_device_name(0),
        "lowering": lowering, "traffic": traffic, "mode": mode,
        "streams": STREAMS, "windows_per_step": STREAMS,
        "wall_ms_per_step": walls,
        "windows_per_s": 1e3 * STREAMS / wall,
        "profiled_wall_ms": prof_wall,
        "device_busy_ms": busy_ms,
        # against the untraced steps' median wall: the profiler slows the
        # host, not the kernels
        "idle_share": 1.0 - busy_ms / wall,
        "device_ops": sum(n for n, _ in kernels.values()),
        "host_launches": sum(calls.get(c, 0) for c in LAUNCH_CALLS),
        "runtime_calls": calls,
        "graphs": len(graphs) if graphs else 0,
        "graph_replays": graphs.replays - replays0 if graphs else 0,
        "graph_kernel_nodes_replayed": (graphs.nodes_replayed - nodes0
                                        if graphs else 0),
        "top_kernels": [
            {"name": name[:80], "count": n, "ms": ns / 1e6}
            for name, (n, ns) in top[:TOP]],
        # launches and device ms in the step of the port's hand-written
        # kernels, found by their device functions' names
        "port_kernels": {
            name: {"count": sum(n for n, _ in mine),
                   "ms": sum(ns for _, ns in mine) / 1e6}
            for name, fns in PORT_KERNELS.items()
            for mine in [[v for k, v in kernels.items()
                          if any(f in k for f in fns)]]},
        "cuda_memory_reserved_bytes": torch.cuda.memory_reserved(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lowering", default="prefix",
                    help=f"comma list of {sorted(LOWERINGS)}")
    ap.add_argument("--traffic", default="served",
                    help="comma list of served, reuse")
    ap.add_argument("--jit", default="eager,captured",
                    help=f"comma list of {sorted(MODES)}")
    args = ap.parse_args(argv)
    lowerings = args.lowering.split(",")
    traffics = args.traffic.split(",")
    modes = args.jit.split(",")
    for name in modes:
        if name not in MODES:
            ap.error(f"unknown step mode {name!r}")
    for name in lowerings:
        if name not in LOWERINGS:
            ap.error(f"unknown lowering {name!r}")
    for name in traffics:
        if name not in ("served", "reuse"):
            ap.error(f"unknown traffic {name!r}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a GPU")
    cfg = torr_edge()
    world = ts.make_world(0, M=cfg.M, d=cfg.feat_dim, n_tasks=5)
    sys_ = tp.build_system(world, cfg, torch.Generator().manual_seed(0))
    print(smi("name,power.limit"))
    for lowering in lowerings:
        for traffic in traffics:
            for mode in modes:
                print(json.dumps(profile(cfg, sys_, world, lowering, traffic,
                                         mode), indent=1), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
