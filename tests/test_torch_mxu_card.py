"""``aligner.full_dot_mxu`` on the card: ``torch._int_mm`` there takes only
some shapes (more than 16 rows, multiples of 8), which the CPU does not
check. Held to the popcount dot on the CPU at row and class counts on both
sides of those limits. Imports no JAX, so the card's host runs it:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mxu_card.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import aligner, item_memory
from repro_torch.core.types import TorrConfig

from _torch_parity import SMALL, bipolar, pack_np


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch._int_mm's CUDA shapes")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [20, 1024])
@pytest.mark.parametrize("lead", [(), (3,), (2, 20)])
def test_full_dot_mxu_on_the_card_equals_the_popcount_dot(card, lead, M):
    cfg = TorrConfig(**dict(SMALL, M=M))
    rng = np.random.default_rng(11)
    codes = bipolar(rng, (M, cfg.D))
    im = item_memory.build_item_memory(torch.from_numpy(codes))
    q = bipolar(rng, lead + (cfg.D,))
    qp = torch.from_numpy(pack_np(q).view(np.int32))
    for banks in (2, 8):
        want = aligner.full_dot(qp, im, item_memory.word_mask(cfg, banks))
        got = aligner.full_dot_mxu(torch.from_numpy(q).to(card),
                                   im.to(card),
                                   item_memory.dim_mask(cfg, banks, card))
        assert got.dtype == torch.int32 and got.device.type == "cuda"
        assert torch.equal(got.cpu(), want), (lead, M, banks)
