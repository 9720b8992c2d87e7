"""A tiny TorR configuration for the benchmark's own CPU tests: every cell
of the manifest at a size a test holds (D = 1024, M = 64, K = 4, N_max =
16, 4 streams a card), run on the CPU through the program's plain
versions."""
from __future__ import annotations

import contextlib
import copy
import time

from . import harness, manifest

TINY = {"D": 1024, "B": 8, "M": 64, "feat_dim": 32, "K": 4, "N_max": 16,
        "delta_budget": 256, "tau_byp": 0.95, "tau_q": 0.6, "N_hi": 4,
        "q_hi": 4, "n_relations": 16, "max_hops": 3, "top_k": 5,
        "margin_eps": 0.02, "W": 64, "clock_hz": 1e9, "accum_bits": 8,
        "bit_planes": 4, "fps_target": 60.0, "n_tasks": 5}


def tiny_cell(name: str) -> tuple[dict, dict]:
    """(manifest, workload entry) of cell ``name`` cut to the tiny size.
    N_hi = 4 keeps every window of both traffics at N >= N_hi, as the
    published sizes do."""
    man = manifest.load()
    w = copy.deepcopy(manifest.cell(man, name))
    w["config_file"]["torr"] = dict(TINY)
    w["config_file"]["deployment"]["slots_per_card"] = 4
    w["traffic_file"].update(streams_per_card=4, windows_per_stream=8,
                             warmup_s=0.2)
    return man, w


@contextlib.contextmanager
def forbidding_new_imports():
    """Inside, the harness's import check sees only the JAX modules loaded
    since entry: a test process (a pytest worker) may hold JAX already from
    other test files, where the benchmark's own process holds none."""
    before = set(harness.loaded_forbidden())
    orig = harness.loaded_forbidden
    harness.loaded_forbidden = lambda: sorted(set(orig()) - before)
    try:
        yield
    finally:
        harness.loaded_forbidden = orig


def run_tiny(name: str, seed: int = 7, seconds: float = 0.6,
             trace: bool = False):
    """One tiny run of cell ``name`` on the CPU: (exit code, result)."""
    man, w = tiny_cell(name)
    with forbidding_new_imports():
        return harness.run(name, seed, seconds, trace,
                           t_start=time.perf_counter(), device="cpu",
                           man=man, cell=w)
