"""Port parity: ``repro_torch.data.tokens.TokenStream`` against
``repro.data.tokens.TokenStream``: every batch bit-equal (keys, dtypes,
shapes, values) for every family of the registry, including the audio
codebooks, the VLM's ``vision`` and MoE's ``tokens_next``/``labels_mtp``;
skip-ahead (``stream(start)`` from any step) equal to ``batch_at``; and
``to_device``'s tensors equal to the arrays."""
import itertools

import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_smoke as jget_smoke
from repro.data.tokens import TokenStream as JTokenStream
from repro_torch.configs import get_smoke
from repro_torch.data.tokens import TokenStream, to_device


def _assert_batches_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_batch_at_bit_equal(name):
    cfg, jcfg = get_smoke(name), jget_smoke(name)
    for (B, S), seed in itertools.product(((2, 64), (3, 17)), (0, 7)):
        port, ref = TokenStream(cfg, B, S, seed), JTokenStream(jcfg, B, S,
                                                               seed)
        np.testing.assert_array_equal(port.successor, ref.successor)
        for step in (0, 1, 1000):
            _assert_batches_equal(port.batch_at(step), ref.batch_at(step))


def test_skip_ahead():
    cfg = get_smoke("deepseek-v3-671b")
    ts = TokenStream(cfg, 2, 32, seed=3)
    ref = JTokenStream(jget_smoke("deepseek-v3-671b"), 2, 32, seed=3)
    for start in (0, 5, 123):
        for i, batch in zip(range(3), ts.stream(start)):
            _assert_batches_equal(batch, ts.batch_at(start + i))
            _assert_batches_equal(batch, ref.batch_at(start + i))


def test_to_device():
    batch = TokenStream(get_smoke("llama-3.2-vision-90b"), 2, 16).batch_at(4)
    out = to_device(batch, "cpu")
    assert list(out) == list(batch)
    for k, v in batch.items():
        assert isinstance(out[k], torch.Tensor)
        np.testing.assert_array_equal(out[k].numpy(), v)
