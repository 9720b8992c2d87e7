"""Multi-pod dry-run: bind + analyze every (arch x shape x mesh) cell
(port of ``repro.launch.dryrun``).

One process stands for one rank of the production mesh: it starts a fake
process group of the mesh's world size (256, or 512 with ``--multi-pod``;
``torch.testing``'s ``FakeStore`` with backend "fake", whose collectives
move nothing), builds the ("data", "model") ``DeviceMesh`` on it (the
multi-pod mesh as its (32, 16) factorization, see :func:`mesh_for`),
places every cell's parameters, optimizer state,
batch and cache on ``meta`` by ``runtime/sharding.py`` and runs the cell's
step once under ``perf/op_analyze.py`` (``steps.lower_cell``). No tensor
holds data, so a 671B-parameter cell runs on a laptop's CPU. Writes one
JSON per cell under ``experiments/dryrun_torch/`` with the three roofline
terms (``perf/roofline.py``, H100 constants), the per-device memory and
the gathers the mesh layer made outside DTensor's own rules (``gathers``:
op, where, count, bytes; ``runtime/spmd.py``).

Usage:
    python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all    # sweep
    python -m repro_torch.launch.dryrun ... --multi-pod           # 2x16x16
    python -m repro_torch.launch.dryrun ... --set serve_quant=int8
    python -m repro_torch.launch.dryrun ... --save-ops   # + per-op rows
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys
import time
import traceback

from ..configs.registry import ARCHS, SHAPES, get, shape_for
from ..perf import op_analyze, roofline
from ..runtime import steps
from .mesh import make_mesh, production_shape

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"


def start_fake_group(world: int) -> None:
    """A process group of ``world`` ranks in which this process is rank 0
    and every collective is a no-op (torch's testing backend "fake")."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def mesh_for(mesh_shape: tuple, axes: tuple):
    """The cell's mesh in a fake group of its size. A ("pod", "data",
    "model") mesh is built as its (pod x data, model) factorization named
    ("data", "model"): every rule shards over 'pod' and 'data' together
    (``sharding.batch_axes``) or not at all at the registry's shapes
    (``run_cell`` checks the batch), so each rank holds the same shards,
    and its batch collectives are one over pod x data ranks where the 3-D
    mesh issues two (the flattening DTensor itself advises). On the 3-D
    mesh DTensor's redistribution planner searches a graph of placements
    for every op (views of a dim sharded over two axes give strided
    placements), which took over 15 minutes for one smoke cell."""
    start_fake_group(math.prod(mesh_shape))
    if axes[0] == "pod":
        mesh_shape = (mesh_shape[0] * mesh_shape[1], mesh_shape[2])
        axes = axes[1:]
    return make_mesh(mesh_shape, axes, device="cpu")


def _check_flattened(shape: dict, mesh_shape: tuple) -> None:
    """A multi-pod batch that the 3-D mesh would shard over 'data' alone
    (divisible by it, not by pod x data) has no flattened counterpart."""
    if len(mesh_shape) != 3:
        return
    B, data = shape["global_batch"], mesh_shape[1]
    if B % (mesh_shape[0] * data) and B % data == 0 and B >= data:
        raise ValueError(f"global batch {B} shards over 'data' alone on "
                         f"the {mesh_shape} mesh; the dry-run's flattened "
                         "mesh cannot hold that placement")


def _mesh_name(mesh_shape: tuple) -> str:
    return "pod" + "x".join(map(str, mesh_shape))


def run_cell(arch: str, shape_name: str, mesh_shape: tuple, axes: tuple,
             out_dir: pathlib.Path = OUT_DIR, variant: str = "baseline",
             cfg_override=None, save_ops: bool = False) -> dict:
    """One cell's record, written to ``out_dir/<cell>.json``; with
    ``save_ops`` its aggregated ops too, to ``<cell>.ops.json`` (the
    input of ``perf/profile_cell.py --analysis``)."""
    out_dir = pathlib.Path(out_dir)
    mesh_name = _mesh_name(mesh_shape)
    cell_id = f"{arch}__{shape_name}__{mesh_name}__{variant}"
    out_path = out_dir / f"{cell_id}.json"
    out_dir.mkdir(parents=True, exist_ok=True)

    shape = shape_for(arch, shape_name)
    if shape is None:
        rec = {"cell": cell_id, "status": "SKIP",
               "reason": "full-attention arch; long_500k requires "
                         "sub-quadratic attention (see DESIGN.md)"}
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    cfg = cfg_override or get(arch)
    _check_flattened(shape, mesh_shape)
    mesh = mesh_for(mesh_shape, axes)
    chips = math.prod(mesh_shape)

    t0 = time.time()
    try:
        lowered, meta = steps.lower_cell(cfg, shape, mesh)
        t_lower = time.time() - t0
        rl = roofline.analyze(
            lowered, arch=arch, shape=shape_name, mesh_name=mesh_name,
            chips=chips, model_flops=roofline.model_flops_for(cfg, shape))
        t_analyze = time.time() - t0 - t_lower
        if save_ops:
            (out_dir / f"{cell_id}.ops.json").write_text(json.dumps(
                op_analyze.aggregate(lowered.analysis.ops)))
        rec = {
            "cell": cell_id, "status": "OK", "mode": meta["mode"],
            "lower_s": round(t_lower, 1), "analyze_s": round(t_analyze, 1),
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            **rl.to_dict(),
            "gathers": lowered.analysis.gathers,
        }
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        rec = {"cell": cell_id, "status": "FAIL",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-4000:]}
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def _value(v: str):
    if v in ("True", "False"):
        return v == "True"
    return int(v) if v.lstrip("-").isdigit() else v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--save-ops", action="store_true",
                    help="also write each cell's aggregated ops "
                         "(<cell>.ops.json, for perf/profile_cell.py)")
    ap.add_argument("--set", action="append", default=[],
                    help="config overrides for §Perf variants, e.g. "
                         "--set serve_quant=int8 --set attn_remat=True")
    args = ap.parse_args(argv)

    mesh_shape, axes = production_shape(args.multi_pod)
    kv = dict(item.split("=", 1) for item in args.set)
    kv = {k: _value(v) for k, v in kv.items()}
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    rc = 0
    for a in archs:
        for s in shapes:
            rec = run_cell(a, s, mesh_shape, axes, pathlib.Path(args.out_dir),
                           args.variant,
                           cfg_override=dataclasses.replace(get(a), **kv)
                           if kv else None, save_ops=args.save_ops)
            status = rec["status"]
            extra = ""
            if status == "OK":
                extra = (f" bottleneck={rec['bottleneck']}"
                         f" gathers={len(rec['gathers'])}"
                         f" t=({rec['t_compute']:.3e},{rec['t_memory']:.3e},"
                         f"{rec['t_collective']:.3e})s"
                         f" analyze={rec['analyze_s']}s")
            elif status == "FAIL":
                extra = " " + rec["error"][:200]
                rc = 1
            print(f"[dryrun] {rec['cell']}: {status}{extra}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
