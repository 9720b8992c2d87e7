"""Port parity: the HDC reranker as an LM serving layer
(``repro_torch.serving.reranker`` vs ``repro.serving.reranker``).

Tolerances: fed the reference's packed queries, every integer and readout
(rho, bypassed, the state's words, cached scores and validity) is bit-equal,
and so are the logits with the identity concept map; with a concept map the
logits (a float product over M) are held to rtol 1e-5. The port's own encode
(``ops.encode_packed``) is held to the reference's by the agreement rule of
``kernels.ref.sign_pack_disagreement``, and where the two queries are equal
the step is bit-equal again.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hdc as jhdc
from repro.core import item_memory as jim
from repro.core.types import TorrConfig as JCfg
from repro.serving import reranker as jrr
from repro_torch import convert
from repro_torch.core import item_memory as tim
from repro_torch.core.types import TorrConfig
from repro_torch.kernels import ops, ref
from repro_torch.serving import reranker as trr

from _torch_parity import assert_same, bipolar, words

CFG_KW = dict(D=1024, B=8, M=64, K=8, N_max=4, feat_dim=32)
CFG, JCFG = TorrConfig(**CFG_KW), JCfg(**CFG_KW)
D_MODEL = 32
LOGIT_RTOL = 1e-5


def _setup(vocab, seed=0, alpha=0.5):
    """The same reranker in both packages from numpy draws: item memory,
    projection, task weights and (``vocab != M``) a sparse concept map."""
    rng = np.random.default_rng(seed)
    codes = bipolar(rng, (CFG.M, CFG.D))
    R = (rng.standard_normal((CFG.D, D_MODEL)) / np.sqrt(D_MODEL)
         ).astype(np.float32)
    g = bipolar(rng, (CFG.D,))
    task_w = (1.0 + (codes.astype(np.int32) @ g.astype(np.int32))
              .astype(np.float32) / CFG.D).astype(np.float32)
    cmap = None
    if vocab != CFG.M:
        cmap = np.where(rng.random((CFG.M, vocab)) < 0.02,
                        rng.standard_normal((CFG.M, vocab)), 0.0
                        ).astype(np.float32)
    jp = jrr.RerankerParams(jnp.asarray(R), jnp.asarray(task_w),
                            None if cmap is None else jnp.asarray(cmap),
                            jnp.float32(alpha))
    jmem = jim.build_item_memory(jnp.asarray(codes),
                                 plane_total=JCFG.bit_planes)
    tp = convert.reranker_params_from_numpy(R, task_w, cmap,
                                            np.float32(alpha))
    tmem = convert.item_memory_from_numpy(codes, CFG.bit_planes)
    return (jp, jmem), (tp, tmem)


def _hidden_walk(seed, steps, B, jumps=(3, 7)):
    """Hidden states that drift slowly and jump at ``jumps``: both bypass
    and full steps occur."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, D_MODEL))
    out = []
    for t in range(steps):
        h = (rng.standard_normal((B, D_MODEL)) if t in jumps
             else h + 0.05 * rng.standard_normal((B, D_MODEL)))
        out.append(h.astype(np.float32))
    return out


_ref_step = jax.jit(jrr.rerank_step, static_argnames=("cfg", "tau"))


@functools.partial(jax.jit, static_argnums=2)
def _ref_packed(hidden, R, D):
    return jhdc.pack_bits(jhdc.sign_project(hidden, R))


def _assert_step_equal(got, want, concept_map):
    (lg, st, tel), (lj, sj, telj) = got, want
    if concept_map:
        np.testing.assert_allclose(lg.numpy(), np.asarray(lj),
                                   rtol=LOGIT_RTOL, atol=1e-6)
    else:
        assert_same(lg, lj, "logits")
    assert_same(tel["rho"], telj["rho"], "rho")
    assert_same(tel["bypassed"], telj["bypassed"], "bypassed")
    assert_same(words(st.prev_q), words(sj.prev_q), "prev_q")
    assert_same(st.prev_s, sj.prev_s, "prev_s")
    assert_same(st.valid, sj.valid, "valid")


@pytest.mark.parametrize("vocab", [CFG.M, 300])
def test_rerank_from_packed_is_bit_equal(vocab):
    (jp, jmem), (tp, tmem) = _setup(vocab)
    B, steps = 3, 10
    sj, st = jrr.init_state(JCFG, B), trr.init_state(CFG, B, "cpu")
    rng = np.random.default_rng(1)
    bypassed = full = 0
    for h in _hidden_walk(2, steps, B):
        logits = rng.standard_normal((B, vocab)).astype(np.float32)
        want = _ref_step(jp, sj, jmem, jnp.asarray(h), jnp.asarray(logits),
                         JCFG)
        qp = convert.words_from_numpy(np.asarray(
            _ref_packed(jnp.asarray(h), jp.R, CFG.D)))
        got = trr._rerank_from_packed(tp, st, tmem, qp, torch.from_numpy(
            logits), CFG)
        _assert_step_equal(got, want, vocab != CFG.M)
        sj, st = want[1], got[1]
        bypassed += int(got[2]["bypassed"].sum())
        full += int((~got[2]["bypassed"]).sum())
    assert bypassed > 0 and full > B       # both paths after the cold step


def test_rerank_step_encode_agrees_then_bit_equal():
    """The port's whole step on the CPU: its encode by the agreement rule,
    the rest bit-equal wherever the queries are equal."""
    (jp, jmem), (tp, tmem) = _setup(CFG.M, seed=4, alpha=1.0)
    B = 4
    sj, st = jrr.init_state(JCFG, B), trr.init_state(CFG, B, "cpu")
    for h in _hidden_walk(5, 6, B, jumps=(2,)):
        qp = ops.encode_packed(h, tp.R, device="cpu")
        qj = np.asarray(_ref_packed(jnp.asarray(h), jp.R, CFG.D))
        rule = ref.sign_pack_disagreement(torch.from_numpy(h), tp.R, qp,
                                          convert.words_from_numpy(qj))
        assert rule["ok"], rule
        logits = np.zeros((B, CFG.M), np.float32)
        want = _ref_step(jp, sj, jmem, jnp.asarray(h), jnp.asarray(logits),
                         JCFG)
        got = trr.rerank_step(tp, st, tmem, torch.from_numpy(h),
                              torch.from_numpy(logits), CFG)
        if np.array_equal(words(qp), qj):
            _assert_step_equal(got, want, False)
        sj, st = want[1], got[1]


def test_cold_state_applies_the_bias_and_never_bypasses():
    params, im = trr.init_reranker(CFG, D_MODEL, 100, alpha=1.0,
                                   generator=torch.Generator().manual_seed(0))
    state = trr.init_state(CFG, 3, "cpu")
    hidden = torch.randn((3, D_MODEL),
                         generator=torch.Generator().manual_seed(1))
    out, state2, tel = trr.rerank_step(params, state, im, hidden,
                                       torch.zeros((3, 100)), CFG)
    assert out.shape == (3, 100)
    assert float(out.abs().max()) > 0
    assert bool(state2.valid.all())
    assert not bool(tel["bypassed"].any())
    assert bool((tel["rho"] == -1.0).all())


def test_identical_hidden_bypasses_and_reuses_scores():
    params, im = trr.init_reranker(CFG, D_MODEL, CFG.M, alpha=1.0,
                                   generator=torch.Generator().manual_seed(0))
    assert params.concept_map is None                   # identity map
    state = trr.init_state(CFG, 2, "cpu")
    hidden = torch.randn((2, D_MODEL),
                         generator=torch.Generator().manual_seed(1))
    logits = torch.zeros((2, CFG.M))
    out1, state, _ = trr.rerank_step(params, state, im, hidden, logits, CFG)
    out2, state, tel2 = trr.rerank_step(params, state, im, hidden, logits,
                                        CFG)
    assert bool(tel2["bypassed"].all())
    assert float(tel2["rho"].min()) == 1.0
    assert torch.equal(out1, out2)


def test_divergent_hidden_recomputes():
    params, im = trr.init_reranker(CFG, D_MODEL, CFG.M,
                                   generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    h1, h2 = torch.randn((2, D_MODEL), generator=gen), torch.randn(
        (2, D_MODEL), generator=gen)
    state = trr.init_state(CFG, 2, "cpu")
    logits = torch.zeros((2, CFG.M))
    _, state, _ = trr.rerank_step(params, state, im, h1, logits, CFG)
    _, state, tel = trr.rerank_step(params, state, im, h2, logits, CFG)
    assert not bool(tel["bypassed"].any())


def test_concept_map_has_the_reference_s_distribution():
    """One uniform u draws both the value sqrt(2) erfinv(2u - 1) and the
    mask u < 0.02, as the reference's one key does: every kept entry lies
    at or below sqrt(2) erfinv(-0.96) = -2.054, at about 2 % density, with
    the mean of a normal's lower 2 % tail (-phi(2.054) / 0.02 = -2.42)."""
    vocab = 5000
    params, im = trr.init_reranker(CFG, D_MODEL, vocab, alpha=0.5,
                                   generator=torch.Generator().manual_seed(3))
    cm = params.concept_map
    assert cm.shape == (CFG.M, vocab) and cm.dtype == torch.float32
    nz = cm[cm != 0]
    assert abs(nz.numel() / cm.numel() - 0.02) < 0.002
    assert float(nz.max()) <= -2.05
    assert abs(float(nz.mean()) + 2.42) < 0.03
    out, _, _ = trr.rerank_step(params, trr.init_state(CFG, 1, "cpu"), im,
                                torch.ones((1, D_MODEL)),
                                torch.zeros((1, vocab)), CFG)
    assert out.shape == (1, vocab)
    # the edge of the clamp: u = 0 maps to a finite value
    edge = trr.concept_map_from_uniform(torch.tensor([0.0, 0.0199, 0.02]))
    assert bool(torch.isfinite(edge).all()) and float(edge[2]) == 0.0


def test_task_weights_and_item_memory_are_the_reference_s_functions():
    """``init_reranker``'s task weights are 1 + <g, h_j> / D for a bipolar g,
    and ``random_item_memory`` is ``build_item_memory`` of random codes
    at the config's plane count (every view the reference's)."""
    params, im = trr.init_reranker(CFG, D_MODEL, CFG.M,
                                   generator=torch.Generator().manual_seed(9))
    steps = (params.task_w - 1.0) * CFG.D
    assert torch.equal(steps, torch.round(steps))
    assert bool((steps.abs() <= CFG.D).all()) and params.task_w.std() > 0
    assert params.R.shape == (CFG.D, D_MODEL)
    mem = tim.random_item_memory(torch.Generator().manual_seed(2), CFG)
    assert mem.bipolar.shape == (CFG.M, CFG.D)
    want = jim.build_item_memory(jnp.asarray(mem.bipolar.numpy()),
                                 plane_total=JCFG.bit_planes)
    for name in ("bipolar", "dmajor"):
        assert_same(getattr(mem, name), getattr(want, name), name)
    for name in ("packed", "pmajor"):
        assert_same(words(getattr(mem, name)), words(getattr(want, name)),
                    name)


def test_state_round_trips_through_numpy():
    (jp, jmem), (tp, tmem) = _setup(CFG.M)
    sj = jrr.init_state(JCFG, 2)
    h = _hidden_walk(0, 1, 2)[0]
    _, sj, _ = _ref_step(jp, sj, jmem, jnp.asarray(h),
                         jnp.zeros((2, CFG.M)), JCFG)
    st = convert.reranker_state_from_numpy(
        np.asarray(sj.prev_q), np.asarray(sj.prev_s), np.asarray(sj.valid))
    back = convert.to_numpy(st)
    assert back["prev_q"].dtype == np.uint32
    assert_same(back["prev_q"], np.asarray(sj.prev_q), "prev_q")
    assert_same(back["prev_s"], np.asarray(sj.prev_s), "prev_s")
    moved = tp.to("cpu")
    assert moved.concept_map is None and moved.alpha.dtype == torch.float32


def test_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trr.init_state(CFG, 2)
