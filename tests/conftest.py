import os
import sys

# keep tests on 1 CPU device; multi-device tests spawn subprocesses
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# repo root, so tests can import the benchmarks package (e.g. table8's
# governor Pareto sim is acceptance-tested in test_control.py)
sys.path.insert(1, os.path.join(os.path.dirname(__file__), ".."))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (deselect with -m 'not slow' for tier-1 CI)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (skips without one; run them on the card "
        "with -m cuda)",
    )
