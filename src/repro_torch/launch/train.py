"""Training launcher: end-to-end driver with checkpoint/restart (port of
``repro.launch.train`` on one device).

Runs a real training loop on the card (``--device cpu`` for the CPU): the
functional train step of ``runtime/steps.py`` over ``TokenStream`` batches
under :class:`~repro_torch.runtime.fault.TrainSupervisor`, checkpoints by
:class:`~repro_torch.checkpoint.manager.CheckpointManager` (``--ckpt``,
default ``$TMPDIR/repro_torch_ckpt``), fault injection (``--fault-at``) and
``--resume``. With ``--data-axis`` x ``--model-axis`` above 1 every rank
runs this module (``torchrun --nproc-per-node N``, or any launcher that
sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``): the
ranks form a ("data", "model") mesh (NCCL on the card, gloo on the CPU),
the parameters and AdamW state are placed by ``runtime/sharding.py`` and
the step runs on DTensors.

Example (smoke-size, a few hundred steps):
    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
        --smoke --steps 300 --batch 8 --seq 128 --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import get, get_smoke
from ..data.tokens import TokenStream
from ..device import resolve_device
from ..optim import adamw
from ..runtime import sharding as shd
from ..runtime.fault import SupervisorConfig, TrainSupervisor
from ..runtime.steps import init_train_state, make_train_step
from .mesh import make_host_mesh


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fault-at", type=int, default=None)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def _mesh(data: int, model: int, device: torch.device):
    """A (data, model) mesh over the ranks the launcher started. On the
    card each rank takes its card (``LOCAL_RANK``) before it starts its
    NCCL group, so no communicator, and no barrier, binds to cuda:0."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise SystemExit(
                f"--data-axis {data} --model-axis {model}: start one process "
                f"a rank (torchrun --nproc-per-node {data * model}), which "
                "sets RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT")
        kw = {}
        if device.type == "cuda":
            card = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", os.environ["RANK"])))
            torch.cuda.set_device(card)
            kw["device_id"] = card
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="env://", **kw)
    elif device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 dist.get_rank())))
    return make_host_mesh(data, model, device=device.type)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    opt_cfg = adamw.OptimConfig(lr=args.lr,
                                warmup_steps=min(20, args.steps // 5),
                                total_steps=args.steps)

    mesh = None
    if args.data_axis * args.model_axis > 1:
        mesh = _mesh(args.data_axis, args.model_axis, device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    state = init_train_state(cfg, seed=0, device=device)
    if mesh is not None:
        state = {"params": shd.distribute(
                     state["params"],
                     shd.params_sharding(state["params"], mesh)),
                 "opt": shd.distribute(
                     state["opt"], shd.params_sharding(state["opt"], mesh))}
    stream = TokenStream(cfg, args.batch, args.seq)
    step = make_train_step(cfg, opt_cfg, device=device, mesh=mesh)

    ckpt = CheckpointManager(args.ckpt, keep_last=3)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state, start = ckpt.restore(state)
        print(f"[train] resumed from step {start}")

    losses = []

    def step_fn(state, batch):
        p, o, metrics = step(state["params"], state["opt"], batch)
        losses.append(float(metrics["loss"]))
        if args.log_every and len(losses) % args.log_every == 0:
            print(f"[train] step {int(o['step'])} loss {losses[-1]:.4f}",
                  flush=True)
        return {"params": p, "opt": o}

    sup = TrainSupervisor(step_fn, ckpt,
                          SupervisorConfig(ckpt_every=args.ckpt_every))
    t0 = time.time()
    state, end = sup.run(state, stream.stream, args.steps, start_step=start,
                         fault_at=args.fault_at, device=device)
    dt = time.time() - t0
    k = max(1, min(10, len(losses)))
    print(f"[train] arch={cfg.name} steps={end} restarts={sup.restarts} "
          f"loss_first10={np.mean(losses[:k]):.4f} "
          f"loss_last10={np.mean(losses[-k:]):.4f} "
          f"({dt:.1f}s, {dt / max(len(losses), 1) * 1e3:.0f} ms/step) "
          f"device={device.type}")
    if len(losses) > 20:
        assert np.mean(losses[-10:]) < np.mean(losses[:10]), \
            "loss did not improve"
        print("[train] loss improved ✓")


if __name__ == "__main__":
    main()
