"""The benchmark's manifest (``BENCHMARK.json`` at the checkout's root)
and the files it names: a cell's configuration and traffic files, and one
reader file per metric (``end_to_end/<name>.py``, ``metrics/<name>.py``),
each found by its name. Adding a cell, a configuration, a traffic mix or
a metric adds files and entries; no file here changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def cell(man: dict, name: str) -> dict:
    """The workload entry ``name``, with its configuration entry, the
    configuration file and the traffic file loaded."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the manifest has "
                         f"{sorted(cells)}")
    w = dict(cells[name])
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    with open(ROOT / conf["file"], encoding="utf-8") as f:
        w["config_file"] = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{w['traffic']}.json",
              encoding="utf-8") as f:
        w["traffic_file"] = json.load(f)
    return w


def metrics_of(man: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it under ``workloads``; a metric without that key, in every
    cell that reports the end-to-end metric it moves (an end-to-end metric
    without it, in every cell)."""
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell_name in m.get("workloads", ())
            or "workloads" not in m and m["moves"] in names]


def reader(kind: str, name: str):
    """The ``read(ctx)`` function of metric ``name`` (``kind`` is
    ``end_to_end`` or ``metrics``), loaded from its own file."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"torr_bench_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
