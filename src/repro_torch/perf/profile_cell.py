"""Dry-run profiler: per-op traffic/FLOPs attribution (port of
``repro.perf.profile_cell``).

The profile of the CPU-only workflow: with no trace of the production
mesh, optimization targets come from ranking one rank's ops by modeled HBM
traffic and by FLOPs (loop-scaled, ``perf/op_analyze.py``), each with its
op, output shape and the line of the port's code that issued it. Usage:

    python -m repro_torch.perf.profile_cell --arch deepseek-v3-671b \\
        --shape decode_32k --top 25      # binds and analyzes the cell
    python -m repro_torch.perf.profile_cell --analysis \\
        experiments/dryrun_torch/<cell>.ops.json --top 25

The saved analysis is a cell's aggregated ops, which ``launch/dryrun.py
--save-ops`` writes beside its record. The gathers the mesh layer made
outside DTensor's own rules (``runtime/spmd.py``) are listed after the
ops: from the cell's record beside a saved analysis, else from the run.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from . import op_analyze


def profile_rows(rows: list[dict], top: int = 25):
    """(top rows by bytes, top rows by FLOPs) of ``op_analyze.aggregate``
    rows."""
    return (sorted(rows, key=lambda r: -r["bytes"])[:top],
            sorted(rows, key=lambda r: -r["flops"])[:top])


def cell_rows(arch: str, shape: str,
              multi_pod: bool = False) -> tuple[list[dict], list[dict]]:
    """Bind one cell on the (fake) production mesh: (its aggregated ops,
    its gathers)."""
    from ..configs.registry import SHAPES, get
    from ..launch import dryrun
    from ..launch.mesh import production_shape
    from ..runtime import steps

    mesh = dryrun.mesh_for(*production_shape(multi_pod))
    lowered, _ = steps.lower_cell(get(arch), SHAPES[shape], mesh)
    an = lowered.analyze()
    return op_analyze.aggregate(an.ops), an.gathers


def format_rows(by_bytes: list[dict], by_flops: list[dict], top: int,
                gathers: list[dict] = ()) -> str:
    def shape(r):
        return ",".join("x".join(map(str, s)) for s in r["shapes"])[:40]

    out = [f"== top {top} by per-device HBM traffic =="]
    out += [f"{r['bytes'] / 1e9:10.3f} GB {r['op']:24s} {shape(r):40s} "
            f"x{r['count']:<8g} {r['where'][:70]}" for r in by_bytes]
    out += ["", f"== top {top} by per-device FLOPs =="]
    out += [f"{r['flops'] / 1e12:10.4f} TF {r['op']:24s} {shape(r):40s} "
            f"x{r['count']:<8g} {r['where'][:70]}" for r in by_flops]
    out += ["", f"== {len(gathers)} gathers outside DTensor's rules =="]
    out += [f"{g['bytes'] / 1e9:10.3f} GB {g['op'][:24]:24s} "
            f"x{g['count']:<8g} {g['where'][:70]}"
            for g in sorted(gathers, key=lambda g: -g["bytes"])]
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--analysis", help="a cell's ops saved by "
                    "launch/dryrun.py --save-ops")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    if args.analysis:
        with open(args.analysis) as f:
            rows = json.load(f)
        record = pathlib.Path(args.analysis.removesuffix(".ops.json") +
                              ".json")
        gathers = json.loads(record.read_text()).get("gathers", []) \
            if record.exists() else []
    elif args.arch and args.shape:
        rows, gathers = cell_rows(args.arch, args.shape, args.multi_pod)
    else:
        ap.error("give --analysis, or --arch and --shape")
    by_bytes, by_flops = profile_rows(rows, args.top)
    print(format_rows(by_bytes, by_flops, args.top, gathers))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
