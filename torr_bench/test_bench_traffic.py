"""The traffic: the same seed gives the same inputs, another seed others,
and every window of both mixes has at least N_hi valid proposals, so Alg.
1's load gate H(N, q) is high whatever queue depth the engine sees."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tbench import inputs, world
from tbench.testing import TINY

ROOT = Path(__file__).resolve().parent


def test_same_seed_same_inputs_other_seed_other_inputs():
    a = inputs.make_inputs(TINY, 4, 6, 16, 2 ** 31 + 5, "cpu")
    b = inputs.make_inputs(TINY, 4, 6, 16, 2 ** 31 + 5, "cpu")
    c = inputs.make_inputs(TINY, 4, 6, 16, 2 ** 31 + 6, "cpu")
    for x, y in ((a.R, b.R), (a.codes, b.codes), (a.task_w, b.task_w),
                 (a.feats, b.feats)):
        assert torch.equal(x, y)
    assert np.array_equal(a.valid, b.valid)
    assert np.array_equal(a.boxes, b.boxes)
    assert not torch.equal(a.R, c.R)
    assert not torch.equal(a.feats, c.feats)


def test_task_weights_are_the_cosine_of_g_and_the_codes():
    inp = inputs.make_inputs(TINY, 5, 2, 16, 3, "cpu")
    w = inp.task_w
    assert w.shape == (5, TINY["M"])
    assert torch.all(w.abs() <= 1.0)
    # integer dots over D: every weight is a multiple of 1/D (exactly)
    assert torch.equal(torch.round(w * TINY["D"]), w * TINY["D"])


@pytest.mark.parametrize("traffic", ["served", "reuse"])
def test_every_window_holds_the_load_gate_high(traffic):
    t = json.loads((ROOT / "traffic" / f"{traffic}.json").read_text())
    tc = json.loads((ROOT / "configs" / "torr-edge-prefix.json").read_text())["torr"]
    n_max = tc[t["n_max"]] if isinstance(t["n_max"], str) else t["n_max"]
    wd = world.make_world(11, M=tc["M"], d=tc["feat_dim"])
    for seed in (1, 2 ** 31 + 3):
        for task in range(5):
            frames = world.edge_windows(wd, task, 12, seed * 4096 + task,
                                        n_max, tc["N_max"])
            nv = np.array([f.valid.sum() for f in frames])
            assert nv.min() >= tc["N_hi"]
            assert nv.max() <= n_max
