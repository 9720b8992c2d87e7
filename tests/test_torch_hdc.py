"""Port parity: HDC primitives and the banked item memory
(``repro_torch.core.hdc`` / ``item_memory`` vs ``repro.core``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hdc as jhdc
from repro.core import item_memory as jim
from repro.core.types import TorrConfig as JCfg
from repro_torch import convert
from repro_torch.core import hdc, item_memory
from repro_torch.core.types import TorrConfig

from _torch_parity import SMALL, assert_same, bipolar, words

CFGS = [dict(SMALL), dict(D=2048, B=8, M=16, K=4, N_max=4, delta_budget=64),
        dict(D=4096, B=4, M=8, K=4, N_max=4, delta_budget=64, bit_planes=8)]


@pytest.mark.parametrize("shape", [(3, 1024), (2, 5, 64), (32,)])
def test_pack_unpack_match_jax(shape):
    rng = np.random.default_rng(0)
    bip = bipolar(rng, shape)
    got = hdc.pack_bits(torch.from_numpy(bip))
    want = jhdc.pack_bits(jnp.asarray(bip))
    assert_same(words(got), words(want))
    assert_same(hdc.unpack_bits(got, shape[-1]),
                jhdc.unpack_bits(want, shape[-1]))
    with pytest.raises(ValueError):
        hdc.pack_bits(torch.ones((2, 33), dtype=torch.int8))


def test_popcount_and_hamming_with_bit31_set():
    rng = np.random.default_rng(1)
    w = rng.integers(0, 2 ** 32, (64, 40), dtype=np.uint64).astype(np.uint32)
    w[:, 0] |= np.uint32(1 << 31)                 # sign bit of every row set
    w[0, :4] = [0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0]
    t = torch.from_numpy(w.view(np.int32).copy())
    want = np.array([[bin(int(x)).count("1") for x in row] for row in w])
    assert_same(hdc.popcount32(t), want.astype(np.int32))
    a, b = t[:32], t[32:]
    assert_same(hdc.hamming_packed(a, b),
                jhdc.hamming_packed(jnp.asarray(w[:32]), jnp.asarray(w[32:])))
    assert_same(hdc.dot_packed(a, b),
                jhdc.dot_packed(jnp.asarray(w[:32]), jnp.asarray(w[32:])))


def test_bind_bundle_permute_sign_project_match_jax():
    rng = np.random.default_rng(2)
    hv = bipolar(rng, (5, 256))
    t = torch.from_numpy(hv)
    assert_same(hdc.bind(t[0], t[1], t[2]),
                jhdc.bind(*(jnp.asarray(hv[i]) for i in range(3))))
    assert_same(hdc.bundle(t), jhdc.bundle(jnp.asarray(hv)))
    assert_same(hdc.bundle(t[:4]), jhdc.bundle(jnp.asarray(hv[:4])))
    assert_same(hdc.permute(t, 3), jhdc.permute(jnp.asarray(hv), 3))
    # small-integer features: every product and sum is exact in float32,
    # so the two sign projections must be bit-equal (zeros included)
    z = rng.integers(-3, 4, (6, 16)).astype(np.float32)
    R = rng.integers(-2, 3, (256, 16)).astype(np.float32)
    assert_same(hdc.sign_project(torch.from_numpy(z), torch.from_numpy(R)),
                jhdc.sign_project(jnp.asarray(z), jnp.asarray(R)))
    g = torch.Generator().manual_seed(0)
    r = hdc.random_hv(g, (4, 64))
    assert r.dtype == torch.int8 and set(r.unique().tolist()) == {-1, 1}


@pytest.mark.parametrize("kw", CFGS)
def test_item_memory_views_and_selectors(kw):
    tcfg, jcfg = TorrConfig(**kw), JCfg(**kw)
    rng = np.random.default_rng(3)
    bip = bipolar(rng, (tcfg.M, tcfg.D))
    im = item_memory.build_item_memory(torch.from_numpy(bip),
                                       plane_total=tcfg.bit_planes)
    jm = jim.build_item_memory(jnp.asarray(bip), plane_total=jcfg.bit_planes)
    assert_same(im.bipolar, jm.bipolar)
    assert_same(words(im.packed), words(jm.packed))
    assert_same(words(im.pmajor), words(jm.pmajor))
    assert_same(im.dmajor, jm.dmajor)
    assert_same(item_memory.plane_permutation(tcfg.words, tcfg.bit_planes),
                jim.plane_permutation(jcfg.words, jcfg.bit_planes))
    for banks in range(1, tcfg.B + 1):
        for planes in range(1, tcfg.bit_planes + 1):
            assert_same(item_memory.plane_sel(banks * tcfg.bank_words, planes,
                                              tcfg.bit_planes),
                        jim.plane_sel(banks * jcfg.bank_words, planes,
                                      jcfg.bit_planes))
            assert_same(item_memory.bank_plane_sel(tcfg, banks, planes),
                        jim.bank_plane_sel(jcfg, banks, planes))
            assert_same(
                words(item_memory.pmajor_bank_blocks(im.pmajor, tcfg, banks,
                                                     planes)),
                words(jim.pmajor_bank_blocks(jm.pmajor, jcfg, banks, planes)))
            assert_same(item_memory.plan_word_mask(tcfg, banks, planes),
                        jim.plan_word_mask(jcfg, banks, planes))
        assert_same(item_memory.word_mask(tcfg, banks),
                    jim.word_mask(jcfg, banks))
        assert_same(item_memory.dim_mask(tcfg, banks),
                    jim.dim_mask(jcfg, banks))
    # a leading stream axis of bank choices masks row by row
    banks = torch.arange(1, tcfg.B + 1)
    for s in range(tcfg.B):
        assert_same(item_memory.plan_word_mask(tcfg, banks, 2)[s],
                    jim.plan_word_mask(jcfg, s + 1, 2))
    with pytest.raises(ValueError):
        item_memory.build_item_memory(torch.from_numpy(bip[:, :96]),
                                      plane_total=4)


def test_item_memory_convert_round_trip():
    rng = np.random.default_rng(4)
    bip = bipolar(rng, (16, 1024))
    jm = jim.build_item_memory(jnp.asarray(bip))
    views = convert.item_memory_views_from_numpy(
        np.asarray(jm.packed), np.asarray(jm.dmajor), np.asarray(jm.pmajor),
        np.asarray(jm.bipolar))
    rebuilt = convert.item_memory_from_numpy(np.asarray(jm.bipolar))
    for im in (views, rebuilt):
        back = convert.to_numpy(im)
        assert back["packed"].dtype == np.uint32
        for name in ("bipolar", "packed", "dmajor", "pmajor"):
            assert_same(back[name], np.asarray(getattr(jm, name)), name)
