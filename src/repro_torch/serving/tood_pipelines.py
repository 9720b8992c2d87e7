"""TOOD system construction and the cache-gated TorR pipeline (port of
``repro.serving.tood_pipelines``; so far ``build_system`` and ``run_torr``
on the prefix lowering).

Item-memory construction mirrors how task knowledge is distilled into HDC:
each concept code bundles its projected visual prototype with the task
hypervectors of the tasks it serves, weighted by relevance, so the reasoner
weights w_j = cos(g_P, h_j) retrieve the task-class affinity.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import pipeline, reasoner
from ..core.item_memory import ItemMemory, build_item_memory
from ..core.types import TorrConfig
from ..data import tood_synth as ts
from ..device import resolve_device
from ..kernels import ops


@dataclasses.dataclass
class TorrSystem:
    cfg: TorrConfig
    R: np.ndarray             # f32 [D, d] projection
    im: ItemMemory
    task_w: np.ndarray        # f32 [T, M] reasoner weights (precomputed)
    graph: reasoner.TaskGraph


def build_system(world: ts.World, cfg: TorrConfig,
                 generator: torch.Generator | None = None, *, R=None,
                 codes=None, graph: reasoner.TaskGraph | None = None
                 ) -> TorrSystem:
    """Projection, task graph, item memory and task weights for a world.

    Supplied arrays win over the generator: ``R`` [D, d], ``codes`` int8
    [M, D] (the bipolar concept codes) and ``graph`` — so a caller can hand
    in another implementation's arrays and get the same system. The
    generator draws whatever is not supplied (torch's stream, not JAX's).
    Built on the CPU; ``ItemMemory.to`` moves it."""
    if generator is None and (R is None or graph is None):
        raise ValueError("a torch.Generator is required unless R and graph "
                         "are supplied")
    M, d = world.prototypes.shape
    T = world.relevance.shape[0]
    if R is None:
        R = (torch.randn((cfg.D, d), generator=generator)
             / np.sqrt(d)).numpy()
    R = np.asarray(R, np.float32)
    if graph is None:
        graph = reasoner.init_task_graph(generator, cfg, n_tasks=T)
    # g_P per task from its relation path (Hadamard chain)
    g = np.stack([reasoner.compose_path(graph, t, world.task_paths[t]).numpy()
                  for t in range(T)])
    if codes is None:
        # concept codes: bundle projected prototype + relevance-weighted task
        # hypervectors (1.5 : 1 keeps ~0.7 prototype and ~0.25 task
        # correlation under sign() bundling)
        proj = np.sign(world.prototypes @ R.T)
        proj[proj == 0] = 1
        acc = 1.5 * proj + (world.relevance.T @ g)
        codes = np.where(acc >= 0, 1, -1).astype(np.int8)
    im = build_item_memory(torch.from_numpy(np.array(codes, np.int8)),
                           plane_total=cfg.bit_planes)
    task_w = np.stack([
        reasoner.task_weights(torch.from_numpy(g[t]), im, cfg, cfg.B).numpy()
        for t in range(T)])
    return TorrSystem(cfg, R, im, task_w, graph)


def run_torr(sys: TorrSystem, frames, task_id: int, queue_depth: int = 0,
             *, device=None):
    """The cache-gated pipeline over one stream's frames on the prefix
    lowering; returns (per-frame max scores with -1e9 on padding, telemetry
    list). Runs on ``cuda`` unless ``device="cpu"``."""
    dev = resolve_device(device)
    cfg = sys.cfg
    im = sys.im.to(dev)
    state = pipeline.init_state(cfg, sys.task_w[task_id], dev)
    R = torch.from_numpy(np.array(sys.R, np.float32)).to(dev)
    out, telems = [], []
    for f in frames:
        # fused encode front-end: projection + sign + bit-pack in one kernel
        q = ops.encode_packed(f.feats, R, device=dev)
        state, res, tel = pipeline.torr_window_step(
            state, im, q, torch.as_tensor(f.valid, device=dev),
            torch.as_tensor(f.boxes, device=dev),
            torch.tensor(queue_depth, dtype=torch.int32, device=dev), cfg,
            fused="prefix")
        score = torch.amax(res.scores, dim=1).cpu().numpy().copy()
        score[~f.valid] = -1e9
        out.append(score)
        telems.append(tel)
    return out, telems
