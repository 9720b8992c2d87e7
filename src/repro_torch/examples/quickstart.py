"""Quickstart: TorR's cache-gated HDC pipeline in ~60 lines.

Builds an item memory, streams temporally-coherent queries through the
similarity-gated window step, and shows the controller switching between
full / delta / bypass as scene dynamics change — the paper's core loop.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import capture, hdc, pipeline
from ..core.item_memory import random_item_memory
from ..core.types import PATH_NAMES, TorrConfig, map_tensors
from ..device import resolve_device
from ..kernels import ops


def main(argv=None) -> list:
    """Print one line a window; returns the per-window telemetry (on the
    CPU)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = TorrConfig(D=4096, B=8, M=128, K=8, N_max=8, delta_budget=1024,
                     feat_dim=256)
    gen = torch.Generator().manual_seed(0)
    im = random_item_memory(gen, cfg)

    # precomputed reasoner weights for one task (paper: w_j = cos(g_P, h_j))
    g_P = hdc.random_hv(gen, (cfg.D,))
    task_w = 1.0 + hdc.dot_bipolar(im.bipolar, g_P).float() / cfg.D

    im = im.to(dev)
    state = pipeline.init_state(cfg, task_w, dev)
    graphs = capture.GraphFamily() if dev.type == "cuda" else None

    # a "scene": 4 objects whose queries drift slowly, then a scene cut
    rng = np.random.default_rng(0)
    z = rng.standard_normal((4, cfg.feat_dim))
    R = torch.from_numpy((rng.standard_normal((cfg.D, cfg.feat_dim))
                          / np.sqrt(cfg.feat_dim)).astype(np.float32)).to(dev)
    boxes = torch.zeros((cfg.N_max, 4), device=dev)
    valid = torch.tensor([True] * 4 + [False] * 4, device=dev)
    pad = torch.zeros((4, cfg.words), dtype=torch.int32, device=dev)

    print(f"{'win':>4} {'paths':24s} {'|Delta|':18s} {'banks':>5} "
          f"{'rho':>24}")
    telems = []
    for w in range(12):
        if w == 8:
            z = rng.standard_normal((4, cfg.feat_dim))   # scene cut!
        else:
            z = z + 0.02 * rng.standard_normal(z.shape)   # gentle drift
        # fused encode front-end: projection + sign + bit-pack in one kernel
        qp = torch.cat([ops.encode_packed(z, R, device=dev), pad])
        queue = torch.tensor(6 if 4 <= w < 6 else 0, dtype=torch.int32,
                             device=dev)                  # load spike
        state, _out, tel = pipeline.torr_window_step(
            state, im, qp, valid, boxes, queue, cfg, graphs=graphs)
        tel = map_tensors(lambda x: x.cpu(), tel)
        telems.append(tel)
        paths = ",".join(PATH_NAMES[int(p)] for p in tel.path[:4])
        deltas = ",".join(str(int(d)) for d in tel.delta_count[:4])
        rhos = ",".join(f"{float(r):+.2f}" for r in tel.rho[:4])
        note = ("  <- scene cut" if w == 8 else
                "  <- high load" if 4 <= w < 6 else "")
        print(f"{w:>4} {paths:24s} {deltas:18s} {int(tel.banks):>5} "
              f"{rhos}{note}")

    print("\nwindow 0: full scans (cold cache); drift: exact delta updates; "
          "load spike: bypass; scene cut: full refresh.")
    return telems


if __name__ == "__main__":
    main()
