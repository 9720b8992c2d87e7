"""TOOD evaluation pipelines (port of ``repro.serving.tood_pipelines``):
dense CLIP-proxy vs naive HDC vs TorR over the same synthetic world.

  * ``dense`` — float cosine against class prototypes, task-weighted by the
    ground-truth relevance table (the upper baseline; numpy, as in
    ``repro``);
  * ``hdc`` — sign-projected queries, a full scan every window, reasoner
    weights always on (the paper's "SNN + naive HDC" baseline; numpy);
  * ``torr`` — the cache-gated pipeline (``core.pipeline``) with query
    cache, delta updates, aggressive bypass and D' gating, on the card.

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
from ..core.types import TorrConfig, map_tensors
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


def run_dense(world: ts.World, frames, task_id: int):
    """Float cosine x GT relevance (oracle baseline)."""
    protos = world.prototypes
    rel = world.relevance[task_id]
    out = []
    for f in frames:
        z = f.feats / (np.linalg.norm(f.feats, axis=1, keepdims=True) + 1e-9)
        s = z @ protos.T                          # [N, M]
        score = np.max(s * rel[None, :], axis=1)
        score[~f.valid] = -1e9
        out.append(score)
    return out


def run_naive_hdc(sys: TorrSystem, frames, task_id: int):
    """Full scan every window, reasoner always on, no reuse."""
    w = sys.task_w[task_id]
    codes = sys.im.bipolar.cpu().numpy().astype(np.float32)   # [M, D]
    out = []
    for f in frames:
        q = np.sign(f.feats @ sys.R.T)
        q[q == 0] = 1
        s = (q @ codes.T) / sys.cfg.D                # [N, M]
        score = np.max(s * w[None, :], axis=1)
        score[~f.valid] = -1e9
        out.append(score)
    return out


def run_torr(sys: TorrSystem, frames, task_id: int, queue_depth: int = 0,
             *, device=None, words=None):
    """The cache-gated pipeline over one stream's frames on the
    single-window step's default (switch) lowering; returns (per-frame max
    scores with -1e9 on padding, telemetry list on the CPU). Runs on
    ``cuda`` unless ``device="cpu"``. ``words``, if given, holds each
    frame's packed queries (int32 [N_max, D/32]) in place of the encode,
    e.g. another device's, so that the rest of the pipeline can be held to
    that device's run bit for bit."""
    dev = resolve_device(device)
    cfg = sys.cfg
    im = sys.im.to(dev)
    state = pipeline.init_state(cfg, sys.task_w[task_id], dev)
    R = torch.from_numpy(np.array(sys.R, np.float32)).to(dev)
    out, telems = [], []
    for t, f in enumerate(frames):
        # fused encode front-end: projection + sign + bit-pack in one kernel
        q = (ops.encode_packed(f.feats, R, device=dev) if words is None
             else torch.as_tensor(words[t], device=dev))
        state, res, tel = pipeline.torr_window_step(
            state, im, q, torch.as_tensor(f.valid, device=dev),
            torch.as_tensor(f.boxes, device=dev),
            torch.tensor(queue_depth, dtype=torch.int32, device=dev), cfg)
        score = torch.amax(res.scores, dim=1).cpu().numpy().copy()
        score[~f.valid] = -1e9
        out.append(score)
        telems.append(map_tensors(lambda x: x.cpu(), tel))
    return out, telems


def evaluate_task(world, sys: TorrSystem, task_id: int, n_frames: int = 120,
                  seed: int = 0, difficulty: float = 0.55,
                  queue_depth: int = 0, *, device=None) -> dict:
    """AP@0.5 of the three pipelines on one task's simulated sequence, and
    TorR's path mix (padding proposals count as bypass, as in ``repro``).
    TorR runs on ``cuda`` unless ``device="cpu"``."""
    frames = ts.simulate_sequence(world, task_id, n_frames, seed,
                                  difficulty=difficulty,
                                  n_max=sys.cfg.N_max)
    boxes = [f.boxes for f in frames]
    gts = [f.gt_boxes for f in frames]

    dense = ts.average_precision(run_dense(world, frames, task_id), boxes, gts)
    naive = ts.average_precision(run_naive_hdc(sys, frames, task_id), boxes,
                                 gts)
    torr_scores, telems = run_torr(sys, frames, task_id, queue_depth,
                                   device=device)
    torr = ts.average_precision(torr_scores, boxes, gts)
    paths = np.concatenate([t.path.numpy() for t in telems])
    return {
        "task": ts.TASKS[task_id],
        "ap_dense": 100 * dense,
        "ap_naive_hdc": 100 * naive,
        "ap_torr": 100 * torr,
        "path_mix": {
            "bypass": float(np.mean(paths == 0)),
            "delta": float(np.mean(paths == 1)),
            "full": float(np.mean(paths == 2)),
        },
        "telemetry": telems,
        "scores": torr_scores,
    }
