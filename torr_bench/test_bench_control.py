"""The control at a tiny size: the reference in the program's place with
its scores and margins in bfloat16 (one precision below the float32 the
configuration states) must not pass the check. On the card the control
also encodes in TF32 (``control.py``, run there at the cells' sizes)."""
import numpy as np
import pytest

import control
from tbench import check as chk, inputs
from tbench.testing import tiny_cell


@pytest.mark.parametrize("cell", ["edge-prefix-served", "edge-prefix-reuse"])
def test_control_is_caught(cell):
    _man, w = tiny_cell(cell)
    tc, t = w["config_file"]["torr"], w["traffic_file"]
    n_max = tc[t["n_max"]] if isinstance(t["n_max"], str) else t["n_max"]
    for seed in (1, 2, 3):
        inp = inputs.make_inputs(tc, 4, 8, n_max, seed, "cpu")
        windows, cache = control.control_outputs(inp, tc, 40, "cpu")
        numbers = chk.check(inp, windows, cache, tc, seed, "cpu")
        ok, shown = chk.verdict(numbers, w["config_file"]["limits"])
        assert not ok, shown
        assert numbers["mismatch"] > 0 and numbers["score_err"] > 0
        assert np.isfinite(numbers["score_err"])
