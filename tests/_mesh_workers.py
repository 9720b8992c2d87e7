"""Rank processes of the port's mesh tests (``tests/test_torch_mesh_run.py``,
``tests/test_torch_pipeline_parallel.py``).

Each test file starts its ranks once (``spawn``): gloo processes on the
CPU, one torch thread each, joined over ``tcp://localhost``. A worker
imports torch and the port only (no JAX), runs every check of its file and
leaves its measurements in a pickle that rank 0 writes; the test process
compares them with the reference, which it computes with JAX itself.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn, nprocs: int, inputs: dict, meanwhile=None) -> dict:
    """Run ``fn(rank, nprocs, port, inputs, out_path)`` in ``nprocs``
    spawned processes; returns what rank 0 pickled to ``out_path``, and
    the dict ``meanwhile()`` returns, computed here while the ranks run,
    merged into it."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.pkl")
        ctx = mp.spawn(fn, args=(nprocs, free_port(), inputs, out),
                       nprocs=nprocs, join=False)
        extra = meanwhile() if meanwhile is not None else {}
        while not ctx.join():
            pass
        with open(out, "rb") as f:
            return pickle.load(f) | extra


def _start(rank: int, world: int, port: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)


def _finish(rank: int, res: dict, out_path: str) -> None:
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _np(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach()
    # a copy: the steps write their caches in place afterwards
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_tree_np(v) for v in tree]
    return _np(tree)


# ---------------------------------------------------------------------------
# test_torch_mesh_run.py: 8 ranks
# ---------------------------------------------------------------------------

# a first AdamW step that moves every weight by about lr (warm-up over
# one step), well above a float32 or bfloat16 ulp of the weights
OCFG = dict(lr=1e-2, warmup_steps=1)


def _train_pair(cfg, params, batch, mesh):
    """The plain step's and the mesh step's outputs as numpy, from the
    same flat parameters and a fresh AdamW state: each (params, mu, nu,
    metrics), then (the initial params, the decayed keys, each
    parameter's dtype)."""
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps

    ocfg = adamw.OptimConfig(**OCFG)
    opt = adamw.init_opt_state(params)
    plain = steps.make_train_step(cfg, ocfg, device="cpu")(params, opt,
                                                           batch)
    placed = shd.distribute(params, shd.params_sharding(params, mesh))
    on_mesh = steps.make_train_step(cfg, ocfg, mesh=mesh)(placed, opt, batch)
    return [(_tree_np(p), _tree_np(o["mu"]), _tree_np(o["nu"]), _tree_np(m))
            for p, o, m in (plain, on_mesh)] + [
        (_tree_np(params), sorted(steps.decayed(params)),
         {k: str(v.dtype).removeprefix("torch.") for k, v in params.items()})]


def _serve_pair(cfg, params, prompt, mesh):
    """Prefill (capacity S + 8) and one decode step, plain and on the
    mesh: (logits, cache) of each as numpy."""
    from repro_torch.runtime import steps

    S = prompt["tokens"].shape[1]
    out = {}
    for label, m in (("plain", None), ("mesh", mesh)):
        cache, logits = steps.make_prefill(cfg, s_max=S + 8, mesh=m)(
            params, prompt)
        out[f"prefill_{label}"] = (_np(logits), _tree_np(cache))
        tokens = prompt["tokens"][:, -1]
        cache, logits = steps.make_decode_step(cfg, mesh=m)(params, cache,
                                                            tokens)
        out[f"decode_{label}"] = (_np(logits), _tree_np(cache))
    return out


def _int8_pair(cfg, params, prompt, mesh):
    """One ``serve_quant="int8"`` decode step from a zero int8 cache
    (the reference's int8 dicts), plain and on the mesh; and the types of
    the operands of every ``int8_dot.rows`` / ``cols`` call the mesh step
    made (``"int8 operands"``)."""
    from repro_torch.kernels import int8_dot
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import steps

    cfg = dataclasses.replace(cfg, serve_quant="int8")
    B, S = prompt["tokens"].shape[:2]
    out = {"int8 operands": []}
    wrappers = int8_dot.rows, int8_dot.cols

    def recorded(fn):
        def call(a, c, *rest):
            out["int8 operands"].append((type(a).__name__,
                                         type(c).__name__))
            return fn(a, c, *rest)
        return call

    for label, m in (("plain", None), ("mesh", mesh)):
        cache = tf.init_cache(cfg, B, S + 8, device="cpu")
        if m is not None:
            int8_dot.rows, int8_dot.cols = map(recorded, wrappers)
        try:
            cache, logits = steps.make_decode_step(cfg, mesh=m)(
                params, cache, prompt["tokens"][:, -1])
        finally:
            int8_dot.rows, int8_dot.cols = wrappers
        out[f"int8 decode_{label}"] = (_np(logits), _tree_np(cache))
    return out


def _dtensor_refused(mesh) -> str:
    """What ``int8_dot.rows`` raises when handed DTensors (a TypeError's
    message), or "" if it does not."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.kernels import int8_dot
    from repro_torch.runtime import sharding as shd

    a = torch.ones((4, 2, 1, 8), dtype=torch.int8)
    c = torch.ones((4, 3, 2, 8), dtype=torch.int8)
    spec = shd.placements(("data", None, None, None), mesh)
    try:
        int8_dot.rows(distribute_tensor(a, mesh, spec),
                      distribute_tensor(c, mesh, spec))
    except TypeError as e:
        return str(e)
    return ""


def _multipod() -> float:
    """The reference's multipod loop on a (2, 2, 2) ("pod", "data",
    "model") mesh of the 8 ranks: ``chip_smoke.py`` phase 20 (e)'s own
    loop, on the CPU."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    from repro_torch.launch.mesh import make_host_mesh

    return chip_smoke._multipod_loop(make_host_mesh(2, 2, pod=2,
                                                    device="cpu"), "cpu")


def _ep(mesh, inputs) -> dict:
    """moe_ffn_ep on the mesh at the reference test's config, its output
    and its gradients (of sum(y^2) + aux) beside the plain moe_ffn's."""
    from types import SimpleNamespace

    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import spmd

    cfg = ModelConfig(**inputs["ep_cfg"])
    p = {k: torch.from_numpy(v) for k, v in inputs["ep_params"].items()}
    x = torch.from_numpy(inputs["ep_x"])
    ref = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xr = x.clone().requires_grad_(True)
    y0, a0 = moe.moe_ffn(SimpleNamespace(**ref), xr,
                         dataclasses.replace(cfg, moe_groups=0))
    (y0.square().sum() + a0).backward()
    specs = {"router": (), "w_gate": ("model", None, None),
             "w_up": ("model", None, None), "w_down": ("model", None, None),
             "shared_gate": (None, "model"), "shared_up": (None, "model"),
             "shared_down": ("model", None)}
    dp = {k: distribute_tensor(v, mesh, shd.placements(specs[k], mesh))
          .requires_grad_(True) for k, v in p.items()}
    xs = distribute_tensor(x, mesh, shd.placements(("data", None, None),
                                                   mesh)).requires_grad_(True)
    with spmd.mesh_mode():
        y1, a1 = moe.moe_ffn(SimpleNamespace(**dp), xs, cfg, mesh=mesh)
        (y1.square().sum() + a1).backward()
    return {"y_ep": _np(y1), "aux_ep": float(_np(a1)), "y_plain": _np(y0),
            "aux_plain": float(a0.detach()),
            "grads_ep": {k: _np(v.grad) for k, v in dp.items()} |
            {"x": _np(xs.grad)},
            "grads_plain": {k: _np(v.grad) for k, v in ref.items()} |
            {"x": _np(xr.grad)}}


def _elastic(rank: int, inputs) -> dict | None:
    """Parameters saved from a 4x2 mesh, restored onto a 2x2 mesh of ranks
    0-3 (the ranks that remain 'after losing a pod')."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps

    cfg = get_smoke("gemma-7b")
    params = steps.init_train_state(cfg, seed=3, device="cpu")["params"]
    mesh_a = make_host_mesh(4, 2, device="cpu")
    placed = shd.distribute(params, shd.params_sharding(params, mesh_a))
    d = inputs["ckpt_dir"]
    cm = CheckpointManager(d)
    cm.save(7, placed)
    mesh_b = DeviceMesh("cpu", [[0, 1], [2, 3]],
                        mesh_dim_names=("data", "model"))
    if rank >= 4:
        return None
    template = shd.distribute(params, shd.params_sharding(params, mesh_b))
    got, step = cm.restore(template,
                           shardings=shd.params_sharding(params, mesh_b))
    ok = all(torch.equal(got[k].full_tensor(), params[k]) for k in params)
    placements_kept = all(got[k].placements == template[k].placements
                          for k in params)
    return {"step": step, "equal": ok, "placements": placements_kept}


def _compressed(rank: int, mesh) -> dict:
    """``compressed_psum`` over the mesh's data axis against the exact sum
    of the group's gradients."""
    from repro_torch.optim import grad_compress as gc

    g = torch.from_numpy(np.random.default_rng(rank).standard_normal(
        (16, 8)).astype(np.float32))
    group = mesh.get_group("data")
    summed, err = gc.compressed_psum(g, torch.zeros_like(g), group)
    exact = [torch.empty_like(g) for _ in range(dist.get_world_size(group))]
    dist.all_gather(exact, g, group=group)
    q, s, _ = gc.ef_compress(g, torch.zeros_like(g))
    scales = [torch.empty_like(s) for _ in exact]
    dist.all_gather(scales, s, group=group)
    return {"err": float((summed - sum(exact)).abs().max()),
            "bound": float(sum(scales) / 2 * 1.0001),
            "residual": float((err - (g - q.float() * s)).abs().max())}


def _one_by_one(rank: int, inputs) -> dict | None:
    """On a 1x1 mesh (rank 0 alone) xlstm-1.3b's train step (its gates'
    ``log_sigmoid_backward`` through ``spmd``'s pointwise handler), prefill
    and decode equal the plain ones bit for bit."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_params_from_numpy

    mesh = DeviceMesh("cpu", [[0]], mesh_dim_names=("data", "model"))
    if rank:
        return None
    cfg = get_smoke("xlstm-1.3b")
    params = dict(lm_params_from_numpy(cfg, inputs["xlstm_tree"])
                  .state_dict())
    batch = {k: torch.from_numpy(v) for k, v in inputs["xlstm_batch"].items()}
    plain, on_mesh, _ = _train_pair(cfg, params, batch, mesh)
    out = {"train": all(np.array_equal(a[k], b[k], equal_nan=True)
                        for a, b in zip(plain, on_mesh) for k in a)}
    srv = _serve_pair(cfg, params, {"tokens": batch["tokens"]}, mesh)
    for step in ("prefill", "decode"):
        (l0, c0), (l1, c1) = srv[f"{step}_plain"], srv[f"{step}_mesh"]
        out[step] = np.array_equal(l0, l1) and all(
            np.array_equal(a, b) for a, b in zip(_flat(c0), _flat(c1)))
    return out


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def mesh_run_worker(rank, world, port, inputs, out_path):
    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh

    _start(rank, world, port)
    mesh = make_host_mesh(2, 4, device="cpu")
    res = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        res.setdefault("seconds", {})[name] = now - clock[0]
        clock[0] = now

    # the reference test's cell: qwen3-14b smoke (bfloat16), seq 64,
    # batch 4, TokenStream batch 0, the reference's weights
    cfg = get_smoke("qwen3-14b")
    params = dict(lm_params_from_numpy(cfg, inputs["qwen_tree"])
                  .state_dict())
    batch = {k: torch.from_numpy(v) for k, v in inputs["qwen_batch"].items()}
    res["qwen"] = _train_pair(cfg, params, batch, mesh)
    lap("qwen")
    # every family in float32, the score products too (as
    # tests/_torch_train.py's f32_scores): train, prefill and decode
    from repro_torch.models import attention, mla
    attention.BF16 = mla.BF16 = torch.float32
    for arch in inputs["families"]:
        cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
        params = dict(lm_params_from_numpy(cfg, inputs["trees"][arch])
                      .state_dict())
        batch = {k: torch.from_numpy(v)
                 for k, v in inputs["batches"][arch].items()}
        prompt = {k: v for k, v in batch.items() if k in ("tokens", "vision")}
        res[arch] = {"train": _train_pair(cfg, params, batch, mesh)}
        lap(f"{arch} train")
        res[arch].update(_serve_pair(cfg, params, prompt, mesh))
        if cfg.family in ("dense", "moe"):
            res[arch].update(_int8_pair(cfg, params, prompt, mesh))
        lap(f"{arch} serve")
    res["int8_refused"] = _dtensor_refused(mesh)
    res["ep"] = _ep(mesh, inputs)
    res["compressed"] = _compressed(rank, mesh)
    res["multipod"] = _multipod()
    res["elastic"] = _elastic(rank, inputs)
    lap("ep, compressed, elastic")
    attention.BF16 = mla.BF16 = torch.bfloat16
    res["one_by_one"] = _one_by_one(rank, inputs)
    lap("1x1")
    _finish(rank, res, out_path)


# ---------------------------------------------------------------------------
# test_torch_pipeline_parallel.py: 2 ranks, a ("pod", "data", "model")
# mesh of 2 x 1 x 1
# ---------------------------------------------------------------------------

def pipeline_worker(rank, world, port, inputs, out_path):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.pipeline_parallel import (pipeline_apply,
                                                        split_stages)

    _start(rank, world, port)
    mesh = make_host_mesh(1, 1, pod=2, device="cpu")
    W = torch.from_numpy(inputs["W"]).requires_grad_(True)
    xs = torch.from_numpy(inputs["xs"])

    def stage_fn(params, x):
        for i in range(params.shape[0]):
            x = torch.tanh(x @ params[i])
        return x

    out = pipeline_apply(stage_fn, split_stages(W, 2), xs, mesh, "pod")
    torch.sum(out ** 2).backward()
    grad = W.grad.clone()
    dist.all_reduce(grad)          # each stage holds its layers' slice
    _finish(rank, {"out": _np(out), "grad": _np(grad)}, out_path)
