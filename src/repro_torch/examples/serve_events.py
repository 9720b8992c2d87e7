"""End-to-end TorR serving driver (the paper's deployment scenario).

Synthesizes a stream for a task prompt, encodes its proposals, runs the
cache-gated associative pipeline, evaluates AP@0.5 online, and reports the
cycle-model latency/energy the trace would cost on the 28 nm accelerator
at RT-60 — the Fig. 3 loop, input to output. The latency and energy are the
accelerator model's (``perf.cycle_model``), not the card's.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_events
      [--frames 40] [--task 3] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.types import TorrConfig
from ..data import tood_synth as ts
from ..perf.cycle_model import window_cost
from ..serving.tood_pipelines import build_system, run_torr


def main(argv=None) -> dict:
    """Serve, print the reference's report, raise unless the p95 modelled
    window latency meets the RT-60 budget. Returns ``ap50``, the path mix
    and the latency percentiles."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--task", type=int, default=3)  # have breakfast
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    world = ts.make_world(0, M=64, d=512, n_tasks=5)
    cfg = TorrConfig(D=8192, B=8, M=64, K=24, N_max=16, delta_budget=2048,
                     feat_dim=512)
    system = build_system(world, cfg, torch.Generator().manual_seed(0))

    frames = ts.simulate_sequence(world, args.task, args.frames, seed=1,
                                  difficulty=1.2, n_max=cfg.N_max)
    scores, telems = run_torr(system, frames, args.task, device=args.device)

    ap50 = ts.average_precision(scores, [f.boxes for f in frames],
                                [f.gt_boxes for f in frames])

    lat, energy, power = [], [], []
    budget = 1.0 / 60.0
    for tel in telems:
        wc = window_cost(tel.path.numpy(), tel.delta_count.numpy(),
                         int(tel.banks), tel.reasoner_active.numpy(),
                         int(tel.n_valid), cfg, budget)
        lat.append(wc.total_cycles / cfg.clock_hz * 1e3)
        energy.append(wc.energy_j * 1e3)
        power.append(wc.power_w)

    paths = np.concatenate([t.path[: int(t.n_valid)].numpy()
                            for t in telems])
    mix = {name: float(np.mean(paths == i))
           for i, name in enumerate(("bypass", "delta", "full"))}
    print(f"task: {ts.TASKS[args.task]!r}  frames: {args.frames}")
    print(f"AP@0.5: {100*ap50:.1f}")
    print(f"path mix: bypass={mix['bypass']:.2f} delta={mix['delta']:.2f} "
          f"full={mix['full']:.2f}")
    print(f"accelerator (RT-60): median {np.median(lat):.2f} ms/window, "
          f"p95 {np.percentile(lat, 95):.2f} ms, {np.mean(power):.2f} W, "
          f"{np.mean(energy):.1f} mJ/frame")
    if not np.percentile(lat, 95) < budget * 1e3:
        raise AssertionError("missed the RT-60 deadline")
    print("RT-60 deadline met ✓")
    return {"ap50": float(ap50), "path_mix": mix,
            "median_ms": float(np.median(lat)),
            "p95_ms": float(np.percentile(lat, 95))}


if __name__ == "__main__":
    main()
