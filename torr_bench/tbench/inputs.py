"""Every input of a run, made from ``--seed``: the world, the projection R,
the relation graph, the concept codes, the task weights and each camera
stream's windows.

Both sides get these same inputs: the program (through
``AsyncStreamEngine.admit`` and ``submit``) and the plain reference. The
construction follows the port's ``serving/tood_pipelines.py::build_system``
(concept codes bundle the projected prototype with the relevance-weighted
task hypervectors, 1.5 : 1; task weights w_j = cos(g_P, h_j) at full D),
written here in plain torch so that the program derives none of them. The
large arrays are drawn on the device from a ``torch.Generator`` there, in
a few calls; the scenes are numpy (``world.py``). No program module is
imported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import world as wd


@dataclasses.dataclass
class Inputs:
    R: torch.Tensor          # f32 [D, d] projection, on the device
    codes: torch.Tensor      # int8 [M, D] bipolar concept codes
    task_w: torch.Tensor     # f32 [S, M] each stream's reasoner weights
    feats: torch.Tensor      # f32 [S, Wn, N_max, d] window features
    valid: np.ndarray        # bool [S, Wn, N_max]
    boxes: np.ndarray        # f32 [S, Wn, N_max, 4]
    tasks: np.ndarray        # int [S] each stream's task
    n_valid: np.ndarray      # int [S, Wn] valid rows, which lead a window


def torch_seed(seed: int) -> int:
    """A torch generator seed from any whole number (torch takes 64 bits)."""
    return int(seed) % (2 ** 63)


def make_inputs(tcfg: dict, n_streams: int, n_windows: int, n_max: int,
                seed: int, device) -> Inputs:
    """Inputs of a run at the TorR sizes ``tcfg`` (the configuration file's
    ``torr`` group): ``n_streams`` camera streams of ``n_windows`` windows
    each, at most ``n_max`` proposals a window, padded to N_max rows.
    Stream s runs task s mod T on scene seed (seed, s)."""
    D, M, d = tcfg["D"], tcfg["M"], tcfg["feat_dim"]
    T = tcfg["n_tasks"]
    world = wd.make_world(seed % 2 ** 32, M=M, d=d, n_tasks=T,
                          n_relations=tcfg["n_relations"],
                          max_hops=tcfg["max_hops"])
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        R = torch.randn((D, d), generator=gen, device=device) / np.sqrt(d)
        bits = torch.randint(0, 2, (tcfg["n_relations"] + T, D),
                             generator=gen, device=device)
        hv = (2 * bits - 1).to(torch.int32)
        relations, text = hv[:tcfg["n_relations"]], hv[tcfg["n_relations"]:]
        # g_P = t (*) r_l1 (*) ... per task (Hadamard chain)
        g = text.clone()
        for t in range(T):
            for r in world.task_paths[t]:
                if r >= 0:
                    g[t] *= relations[int(r)]
        protos = torch.as_tensor(world.prototypes, dtype=torch.float32,
                                 device=device)
        proj = torch.where(protos @ R.T >= 0, 1.0, -1.0)
        rel = torch.as_tensor(world.relevance, dtype=torch.float32,
                              device=device)
        acc = 1.5 * proj + rel.T @ g.to(torch.float32)
        codes = torch.where(acc >= 0, 1, -1).to(torch.int8)
        # w_j = <g_P, h_j> / D: integer sums, exact in float32
        w = (g.to(torch.float32) @ codes.to(torch.float32).T) / D
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    tasks = np.arange(n_streams) % T
    N_max = tcfg["N_max"]
    feats = np.zeros((n_streams, n_windows, N_max, d), np.float32)
    valid = np.zeros((n_streams, n_windows, N_max), bool)
    boxes = np.zeros((n_streams, n_windows, N_max, 4), np.float32)
    for s in range(n_streams):
        frames = wd.edge_windows(world, int(tasks[s]), n_windows,
                                 seed=int(seed) * 4096 + s, n_max=n_max,
                                 N_max=N_max)
        for j, f in enumerate(frames):
            feats[s, j], valid[s, j], boxes[s, j] = f.feats, f.valid, f.boxes
    n_valid = valid.sum(-1)
    if not np.array_equal(valid, np.arange(N_max) < n_valid[..., None]):
        raise ValueError("a window's valid proposals must lead its rows")
    return Inputs(R=R, codes=codes, task_w=w[torch.as_tensor(tasks)],
                  feats=torch.as_tensor(feats, device=device), valid=valid,
                  boxes=boxes, tasks=tasks, n_valid=n_valid)
