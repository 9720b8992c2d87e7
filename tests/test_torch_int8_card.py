"""``int8_dot`` (``kernels/csrc/int8_dot.cu``) on the card against its plain
version (float64 products there, exact below 2^53), bit for bit, at the
decode shapes and at ragged and extreme ones; then an int8 decode step of
a smoke config on the card against the same step on the CPU. Imports no
JAX, so the card's host runs it: ``PYTHONPATH=src python -m pytest -q -m
cuda tests/test_torch_int8_card.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels import build, int8_dot, ref
from repro_torch.models import transformer as tf


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: int8_dot has no CPU build")
    return torch.device("cuda")


def _codes(gen, shape, extreme, dev):
    if extreme:
        x = torch.randint(0, 2, shape, generator=gen) * 254 - 127
    else:
        x = torch.randint(-127, 128, shape, generator=gen)
    return x.to(torch.int8).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("shape", [
    (4, 8, 5, 160, 128, 128),   # qwen3-14b's GQA at S = 160
    (4, 1, 16, 77, 24, 24),     # MLA scores: one head group
    (2, 1, 16, 77, 16, 24),     # MLA values: the first r of r + dr
    (3, 2, 3, 1, 13, 17),       # ragged K and row length: byte loads
    (1, 2, 7, 4099, 64, 64),    # S not a multiple of any tile
])
def test_int8_dot_on_the_card_equals_the_plain_version(card, shape,
                                                       extreme):
    B, Hk, G, S, K, L = shape
    gen = torch.Generator().manual_seed(sum(shape))
    a = _codes(gen, (B, Hk, G, K), extreme, card)
    p = _codes(gen, (B, Hk, G, S), extreme, card)
    c = _codes(gen, (B, S, Hk, L), extreme, card)
    before = build.LAUNCHES["int8_dot"]
    rows = int8_dot.rows(a, c)
    cols = int8_dot.cols(p, c, K)
    torch.cuda.synchronize()
    assert build.LAUNCHES["int8_dot"] == before + 2
    assert torch.equal(rows, ref.int8_dot_rows_ref(a, c))
    assert torch.equal(cols, ref.int8_dot_cols_ref(p, c, K))
    assert torch.equal(rows.cpu(), ref.int8_dot_rows_ref(a.cpu(), c.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen3-14b", "deepseek-v2-236b"])
def test_int8_decode_on_the_card_is_close_to_the_cpu(card, name):
    cfg = dataclasses.replace(get_smoke(name), dtype="float32",
                              serve_quant="int8")
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(
        card)
    toks = torch.randint(0, cfg.vocab, (2, 6),
                         generator=torch.Generator().manual_seed(1))
    cc = tf.init_cache(cfg, 2, 8, device="cpu")
    cd = tf.init_cache(cfg, 2, 8, device=card)
    before = build.LAUNCHES["int8_dot"]
    for t in range(6):
        cc, lc = tf.decode_step(cpu, cc, toks[:, t], cfg)
        cd, ld = tf.decode_step(dev, cd, toks[:, t].to(card), cfg)
        scale = float(lc.abs().max())
        assert torch.allclose(ld.cpu(), lc, rtol=2e-2, atol=2e-2 * scale), t
    assert build.LAUNCHES["int8_dot"] - before == 6 * 2 * (
        cfg.n_layers)
