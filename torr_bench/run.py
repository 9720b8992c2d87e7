"""TorR edge serving benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 torr_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` and ``device`` (and,
traced, ``breakdown``), the numbers compared beside their limits under
``check``; the same numbers are the last lines of standard error. Needs as
many CUDA cards as the cell asks for; run from the root of a checkout.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# a library the program uses must not load JAX by itself
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_ext"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(CACHE, "inductor"))
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]

from tbench import harness  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(harness.main(t_start=T_START))
