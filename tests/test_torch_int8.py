"""Port parity: the int8 decode cache (``serve_quant="int8"``) and the plain
versions of the ``int8_dot`` kernel, against ``repro`` on the CPU.

Integer results are held bit for bit: ``_quant_rows``' codes and scales on
equal inputs (against the reference run op by op, which rounds and divides
as the port does), and the plain int8 dots against the reference's int32
einsums. The model is held within tolerances, since the int8 operands come
from float products whose last bit can move a code by one near a half:
the reference's own criterion (max |softmax(bf16) - softmax(int8)| < 0.05,
``tests/test_beyond_paper.py``) and, against the reference's int8 decode
in float32, rtol = atol = 2e-2 of the logits' scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import mla as jmla
from repro_torch import convert
from repro_torch.core import capture
from repro_torch.kernels import build, int8_dot, ref
from repro_torch.models import attention as tattn
from repro_torch.models import mla as tmla
from repro_torch.models import transformer as tf

import _torch_lm as lm

B, T = 2, 10


def _rows_cases(rng):
    """float32 rows: random, with exact halves (x = scale * (k + 1/2)),
    all zero, a single nonzero, and large."""
    x = rng.standard_normal((3, 4, 16)).astype(np.float32)
    halves = np.float32(0.125) * (np.arange(-8, 8, dtype=np.float32) + 0.5)
    halves[-1] = np.float32(0.125) * 127       # max|x| / 127 = 0.125
    x[0, 0] = halves
    x[0, 1] = 0.0
    x[0, 2] = 0.0
    x[0, 2, 5] = -3.0
    x[1] *= 1e4
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_rows_bit_equal_to_the_reference(dtype):
    x = _rows_cases(np.random.default_rng(0))
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for jq_fn, tq_fn in ((jattn._quant_rows, tattn._quant_rows),
                         (jmla._quant_rows, tattn._quant_rows)):
        jq, js = jq_fn(jx)
        tq, ts = tq_fn(tx)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))
    # along another axis (the reference's mla helper takes one)
    jq, js = jmla._quant_rows(jx, axis=1)
    tq, ts = tattn._quant_rows(tx, dim=1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _codes(rng, shape, extreme=False):
    if extreme:
        return rng.choice(np.int8([-127, 127]), shape)
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 3, 5, 37, 16, 16),      # GQA: B, Hkv, G, S, K, row length
    (2, 1, 4, 9, 24, 24),       # MLA scores: one head group, K = r + dr
    (1, 2, 3, 1, 13, 17),       # ragged: K not a multiple of 4, L > K
])
def test_plain_int8_dots_bit_equal_to_the_reference_einsums(shape, extreme):
    Bq, Hk, G, S, K, L = shape
    rng = np.random.default_rng(sum(shape))
    a = _codes(rng, (Bq, Hk, G, K), extreme)
    p = _codes(rng, (Bq, Hk, G, S), extreme)
    c = _codes(rng, (Bq, S, Hk, L), extreme)
    want_rows = jnp.einsum("bhgd,bshd->bhgs", jnp.asarray(a, jnp.int32),
                           jnp.asarray(c[..., :K], jnp.int32))
    want_cols = jnp.einsum("bhgs,bshd->bhgd", jnp.asarray(p, jnp.int32),
                           jnp.asarray(c[..., :K], jnp.int32))
    before = build.LAUNCHES["int8_dot"]
    got_rows = int8_dot.rows(torch.from_numpy(a), torch.from_numpy(c))
    got_cols = int8_dot.cols(torch.from_numpy(p), torch.from_numpy(c), K)
    assert build.LAUNCHES["int8_dot"] == before       # the CPU: no launch
    assert got_rows.dtype == got_cols.dtype == torch.int32
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))
    np.testing.assert_array_equal(got_cols.numpy(), np.asarray(want_cols))
    # the MLA's shapes, as the reference writes them
    if Hk == 1:
        ws = jnp.einsum("bhr,bsr->bhs", jnp.asarray(a[:, 0], jnp.int32),
                        jnp.asarray(c[:, :, 0, :K], jnp.int32))
        np.testing.assert_array_equal(got_rows.numpy()[:, 0], np.asarray(ws))


def test_int8_dot_checks_its_operands():
    a = torch.zeros(1, 2, 3, 8, dtype=torch.int8)
    c = torch.zeros(1, 5, 2, 8, dtype=torch.int8)
    with pytest.raises(TypeError):
        int8_dot.rows(a.int(), c)
    with pytest.raises(ValueError):
        int8_dot.rows(a, c[:, :, :1])
    with pytest.raises(ValueError):
        int8_dot.cols(torch.zeros(1, 2, 3, 4, dtype=torch.int8), c)
    with pytest.raises(ValueError):
        int8_dot.cols(torch.zeros(1, 2, 3, 5, dtype=torch.int8), c, 9)
    assert torch.equal(ref.int8_dot_cols_ref(
        torch.zeros(1, 2, 3, 5, dtype=torch.int8), c, 4),
        torch.zeros(1, 2, 3, 4, dtype=torch.int32))


def _pair_decode(name, quant_dtype="bfloat16", **over):
    """(jcfg, jp, cfg, tp) and the int8 config of each package."""
    jcfg, jp, cfg, tp = lm.models(name, dtype=quant_dtype, **over)
    return (jcfg, jp, dataclasses.replace(jcfg, serve_quant="int8"),
            cfg, tp, dataclasses.replace(cfg, serve_quant="int8"))


def _softmax(x):
    return torch.softmax(x.float(), dim=-1)


@pytest.mark.parametrize("name", ["qwen3-14b", "deepseek-v2-236b"])
def test_int8_serving_decode_close_to_bf16(name):
    """The port's counterpart of the reference's test: T decode steps from
    ``init_cache`` with the bf16 cache and with the int8 one, the same
    tokens; max |softmax difference| < 0.05 at every step."""
    _, _, _, cfg, tp, cfgq = _pair_decode(name)
    toks = torch.from_numpy(lm.prompt(cfg, B, T)["tokens"])
    cb = tf.init_cache(cfg, B, 16, device="cpu")
    cq = tf.init_cache(cfgq, B, 16, device="cpu")
    assert isinstance(cq["kv" if "kv" in cq else "ckv"], dict)
    for t in range(T):
        cb, lb = tf.decode_step(tp, cb, toks[:, t], cfg)
        cq, lq = tf.decode_step(tp, cq, toks[:, t], cfgq)
        err = float((_softmax(lb) - _softmax(lq)).abs().max())
        assert err < 0.05, (t, err)


@pytest.mark.parametrize("name", ["qwen3-14b", "deepseek-v2-236b"])
def test_int8_decode_matches_the_reference(name):
    """T int8 decode steps from ``init_cache`` in both packages (float32
    model): logits within 2e-2 of their scale at every step, and the int8
    codes of the final cache equal but for codes moved by one."""
    jcfg, jp, jcfgq, cfg, tp, cfgq = _pair_decode(name, "float32")
    toks = lm.prompt(cfg, B, T)["tokens"]
    jc = lm.jtf.init_cache(jcfgq, B, 16)
    tc = tf.init_cache(cfgq, B, 16, device="cpu")
    for t in range(T):
        jc, jl = lm.ref_decode(jp, jc, jnp.asarray(toks[:, t]), jcfgq)
        tc, tl = tf.decode_step(tp, tc, torch.from_numpy(toks[:, t].copy()),
                                cfgq)
        want = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max(),
                                   err_msg=f"{name} step {t}")
    got = convert.lm_cache_to_numpy(tc)
    key = "kv" if "kv" in got else "ckv"
    for k, v in got[key].items():
        w = np.asarray(jc[key][k])
        assert v.dtype == w.dtype and v.shape == w.shape, k
        if v.dtype == np.int8:
            assert np.abs(v.astype(np.int32) - w).max() <= 1, k


def test_quant_cache_structure():
    """The reference's test on the port, and every int8 cache's leaves
    shaped and typed as the reference's ``init_cache`` makes them."""
    _, cfg = lm.configs("deepseek-v3-671b", serve_quant="int8")
    cache = tf.init_cache(cfg, 2, 32, device="cpu")
    assert cache["ckv"]["q"].dtype == torch.int8
    assert cache["ckv"]["s"].dtype == torch.float32
    assert cache["ckv_prefix"]["q"].dtype == torch.int8
    for name in ("qwen3-14b", "musicgen-large", "deepseek-v2-236b"):
        jcfg, cfg = lm.configs(name, serve_quant="int8")
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            lm.jtf.init_cache(jcfg, 2, 8))
        got = capture.tree_map(
            lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
            tf.init_cache(cfg, 2, 8, device="cpu"))
        got.pop("pos")
        want.pop("pos")
        assert got == want, name


@pytest.mark.parametrize("name", ["qwen3-14b", "deepseek-v2-236b"])
def test_prefill_under_int8_returns_the_reference_float_cache(name):
    """The reference's prefill replaces ``init_cache``'s int8 dicts with its
    float prefill state; the port returns the same float cache, and decode
    from it takes the float path."""
    jcfg, jp, jcfgq, cfg, tp, cfgq = _pair_decode(name, "float32")
    toks = lm.prompt(cfg, B, 16)["tokens"]
    jc, jl = lm.ref_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfgq)
    tc, tl = tf.prefill(tp, {"tokens": torch.from_numpy(toks)}, cfgq)
    assert not any(isinstance(v, dict) for v in jc.values())
    assert not any(isinstance(v, dict) for v in tc.values())
    got = convert.lm_cache_to_numpy(tc)
    assert set(got) == set(jc)
    for k in jc:
        for g, w in zip(jax.tree.leaves(got[k]), jax.tree.leaves(jc[k])):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3,
                                       atol=1e-3, err_msg=k)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=1e-3)
    _, tl2 = tf.decode_step(tp, tc, torch.from_numpy(toks[:, 0].copy()),
                            cfgq)
    _, jl2 = lm.ref_decode(jp, jc, jnp.asarray(toks[:, 0]), jcfgq)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-3,
                               atol=1e-3)


def test_tree_map_walks_nested_dicts():
    """``capture.tree_map`` / ``leaves`` reach the tensors of nested dicts
    (the int8 and recurrent caches) in key order, so a graph's copy in and
    clone out cover them."""
    t = [torch.full((2,), float(i)) for i in range(5)]
    tree = ({"rec": {"h": t[0], "conv": t[1]}, "kv": (t[2], t[3])},
            {"q": t[4]}, None, 3)
    assert [x.data_ptr() for x in capture.leaves(tree)] == \
        [x.data_ptr() for x in t]
    clone = capture.tree_map(torch.clone, tree)
    assert isinstance(clone[0]["rec"], dict) and clone[2] is None and \
        clone[3] == 3
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
        capture.leaves(clone), t))
    assert all(torch.equal(a, b) for a, b in zip(capture.leaves(clone), t))
