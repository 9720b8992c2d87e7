"""Device meshes (port of ``repro.launch.mesh`` over ``torch.distributed``).

Functions, not module-level constants: importing this module touches no
device and no process group. A mesh spans the ranks of the current
(default) process group, which must hold exactly as many ranks as the mesh
has cells; the caller starts the group (``torch.distributed``'s
``init_process_group`` with an address, a world size and a rank: NCCL on
the card, gloo on the CPU). One rank a card, so one card is a 1x1 mesh;
the production meshes, (16, 16) over ("data", "model") and (2, 16, 16) over
("pod", "data", "model"), are built on a real cluster of that size, or
inside the dry-run's fake process group (``launch/dryrun.py``), where one
process stands for one rank of 256 or 512.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_MODEL = ("data", "model")
POD_DATA_MODEL = ("pod", "data", "model")


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(mesh shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), POD_DATA_MODEL
    return (16, 16), DATA_MODEL


def make_mesh(shape: tuple, axes: tuple, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    default process group, on ``device``'s type (the card unless the
    caller names another). Raises unless the group is started and holds
    exactly ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} "
                           "ranks; call torch.distributed.init_process_group "
                           "first")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process "
                         f"group holds {world}")
    dev = torch.device(device) if device is not None else resolve_device()
    if dev.type == "cuda":
        resolve_device(dev)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``."""
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, pod: int | None = None,
                   device=None):
    """A small mesh over the current group's ranks, for tests and one
    card: (data, model), or (pod, data, model) with ``pod``."""
    if pod is not None:
        return make_mesh((pod, data, model), POD_DATA_MODEL, device)
    return make_mesh((data, model), DATA_MODEL, device)
