"""Port parity: the LM's prefill and decode (``repro_torch.models.
transformer`` vs ``repro.models.transformer``) for the dense, audio, VLM and
MoE families at smoke widths, every leaf drawn with numpy.

Tolerances: float32 configs are held to rtol = atol = 1e-3 in the logits,
the hidden states and every cache leaf, after prefill and after each of 4
teacher-forced decode steps (both packages fed the same tokens). The score
products round q and k to bfloat16 in both packages, so the two can differ
by a bfloat16 ulp of a score where their float32 sums round apart; 1e-3
holds with that. One bfloat16 config is held to the reference test's own
2e-2 (``tests/test_models.py::test_decode_matches_prefill_continuation``),
taken of each tensor's scale: atol = 2e-2 max|want|, rtol 2e-2. Compiled,
the reference keeps parts of a bfloat16 model in float32 (XLA's excess
precision folds a bfloat16 add into the cast after it, ``models/mla.py``),
so eager bfloat16 lies a few ulps away: at qwen3-14b's smoke config the
logits differed by 0.022-0.054 at a logit scale of 3.1-3.4 over three
draws, above a flat 2e-2 at small logits.

The reference's prefill leaves the VLM's ``cache["cross_kv"]`` zero (its
``_rebuild_cache`` has no branch for the cross layer), so its decode
attends to zeros; the port stores ``cross_attn_kv`` there. The VLM's decode
is held to the reference's decode fed a cache whose cross KV is the
reference's own ``cross_attn_kv`` (ROADMAP Queue 3).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.models import transformer as tf

import _torch_lm as lm

TOL = dict(rtol=1e-3, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# 2e-2 of each tensor's scale (atol = 2e-2 max|want|): bfloat16 against
# the compiled reference, and MLA's decode against its prefill
SCALED = dict(rtol=2e-2, scaled=2e-2)
B, S, STEPS = 2, 16, 4
# gemma-7b: GeGLU, the embedding scale, tied embeddings; qwen3-14b: GQA
# 4:1 at smoke, qk_norm; musicgen: codebooks; the VLM: a cross layer with a
# nonzero gate; deepseek-v2: MLA with q_lora, the dense prefix, MoE
ARCHS = ("gemma-7b", "qwen3-14b", "musicgen-large", "llama-3.2-vision-90b",
         "deepseek-v2-236b")


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.float()
    return np.asarray(x, np.float32)


def _close(got, want, what, tol):
    got, want = _f32(got), _f32(want)
    if "scaled" in tol:
        tol = dict(rtol=tol["rtol"],
                   atol=tol["scaled"] * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _assert_cache_close(port_cache, ref_cache, what, tol):
    got = convert.lm_cache_to_numpy(port_cache)
    assert set(got) == set(ref_cache), (what, set(got), set(ref_cache))
    assert int(got["pos"]) == int(ref_cache["pos"]), what
    for k, v in ref_cache.items():
        if k == "pos":
            continue
        pairs = zip(got[k], v) if isinstance(v, tuple) else [(got[k], v)]
        for i, (a, b) in enumerate(pairs):
            assert a.shape == b.shape, (what, k, a.shape, b.shape)
            _close(a, b, f"{what}: cache {k}[{i}]", tol)


def _batches(cfg, dtype):
    """The same prompt for both packages (vision in the model's dtype)."""
    nb = lm.prompt(cfg, B, S + STEPS)
    jb = {"tokens": jnp.asarray(nb["tokens"][:, :S])}
    tb = {"tokens": torch.from_numpy(nb["tokens"][:, :S].copy())}
    if "vision" in nb:
        jb["vision"] = jnp.asarray(nb["vision"], jnp.dtype(dtype))
        tb["vision"] = torch.from_numpy(nb["vision"]).to(
            getattr(torch, dtype))
    return nb, jb, tb


def _run_both(name, dtype, tol, seed=0):
    jcfg, jp, cfg, tp = lm.models(name, seed=seed, dtype=dtype)
    nb, jb, tb = _batches(cfg, dtype)
    jcache, jlogits = lm.ref_prefill(jp, jb, jcfg)
    tcache, tlogits = tf.prefill(tp, tb, cfg)
    _close(tlogits, jlogits, f"{name}: prefill logits", tol)
    if cfg.family == "vlm":
        # the reference leaves the cross KV zero; the port stores it
        assert not np.any(np.asarray(jcache["cross_kv"][0], np.float32))
        want = lm.ref_cross_kv(jp, jb["vision"], jcfg)
        for i in range(2):
            _close(tcache["cross_kv"][i], want[i], f"{name}: cross_kv", tol)
        jcache = dict(jcache, cross_kv=tuple(want))
    _assert_cache_close(tcache, jax_np(jcache), f"{name}: prefill", tol)
    for t in range(STEPS):
        tok = nb["tokens"][:, S + t]
        jcache, jlogits, jh = lm.ref_decode(jp, jcache, jnp.asarray(tok),
                                            jcfg, return_hidden=True)
        tcache, tlogits, th = tf.decode_step(tp, tcache,
                                             torch.from_numpy(tok.copy()),
                                             cfg, return_hidden=True)
        what = f"{name}: decode step {t}"
        _close(tlogits, jlogits, f"{what} logits", tol)
        _close(th, jh, f"{what} hidden", tol)
        _assert_cache_close(tcache, jax_np(jcache), what, tol)
    return tlogits


def jax_np(cache):
    return {k: tuple(np.asarray(x, np.float32) for x in v)
            if isinstance(v, tuple) else np.asarray(v, np.float32)
            for k, v in cache.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_the_reference_float32(name):
    logits = _run_both(name, "float32", TOL)
    assert torch.isfinite(logits).all()


def test_prefill_and_decode_match_the_reference_bfloat16():
    _run_both("qwen3-14b", "bfloat16", SCALED)


@pytest.mark.parametrize("name,over", [
    ("deepseek-7b", {}), ("musicgen-large", {}),
    ("llama-3.2-vision-90b", {}),
    # capacity wide enough that neither run drops a choice: prefill's
    # capacity and token order differ with the prompt's length
    ("deepseek-v2-236b", dict(capacity_factor=8.0))])
def test_decode_matches_prefill_continuation(name, over):
    """The reference's own property on the port: prefill(t[:S]) then
    decode(t[S]) == prefill(t[:S+1]) logits (float32, 2e-2 as there).

    MLA is held to 2e-2 of the logits' scale: its absorbed decode rounds
    q_lat . c to bfloat16 where prefill rounds q_nope . (c W_UK), two
    roundings of one score (the reference's formulation). With the scores
    in float32 the two agree to 6.9e-6 at deepseek-v2's full MLA widths;
    with bfloat16 scores they differed by 2.07e-2 and 2.27e-2 at a logit
    scale of 5.1 and 4.8 (two draws, float32, 2 layers, 8 experts)."""
    jcfg, cfg = lm.configs(name, dtype="float32", **over)
    tp = convert.lm_params_from_numpy(cfg, lm.draw_tree(jcfg, 3))
    nb = lm.prompt(cfg, B, S + 1, seed=4)
    toks = torch.from_numpy(nb["tokens"])
    extra = ({"vision": torch.from_numpy(nb["vision"])}
             if "vision" in nb else {})
    cache, _ = tf.prefill(tp, {"tokens": toks[:, :S], **extra}, cfg)
    _, logits_dec = tf.decode_step(tp, cache, toks[:, S], cfg)
    _, logits_ref = tf.prefill(tp, {"tokens": toks, **extra}, cfg)
    _close(logits_dec, logits_ref, name,
           SCALED if cfg.attn_kind == "mla" else BF16_TOL)


def test_cache_capacity_and_position_after_prefill():
    """``s_max`` sizes the cache, S + 64 by default; ``pos`` = S; the slot
    stays at S_max - 1 once the cache is full (as the reference clamps)."""
    _, cfg = lm.configs("qwen3-14b", dtype="float32")
    tp = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(lm.prompt(cfg, B, S)["tokens"])
    cache, _ = tf.prefill(tp, {"tokens": toks}, cfg)
    assert cache["kv"][0].shape[2] == S + 64 and int(cache["pos"]) == S
    cache, _ = tf.prefill(tp, {"tokens": toks}, cfg, s_max=S)
    assert cache["kv"][0].shape[2] == S
    before = cache["kv"][0].clone()
    cache, _ = tf.decode_step(tp, cache, toks[:, 0], cfg)
    assert int(cache["pos"]) == S + 1
    assert torch.equal(cache["kv"][0][:, :, :S - 1], before[:, :, :S - 1])
    assert not torch.equal(cache["kv"][0][:, :, S - 1], before[:, :, S - 1])
    with pytest.raises(ValueError):
        tf.prefill(tp, {"tokens": toks}, cfg, s_max=S - 1)


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-1.3b"])
def test_recurrent_families_are_not_ported_yet(name):
    """Ported since: the recurrent families build their weights and caches
    (their parity is held in ``tests/test_torch_lm_recurrent.py``)."""
    _, cfg = lm.configs(name)
    tf.init_params(cfg, device="cpu")
    cache = tf.init_cache(cfg, 1, 8, device="cpu")
    assert set(cache) == ({"pos", "rec", "kv"} if cfg.family == "hybrid"
                          else {"pos", "mlstm", "slstm"})


def test_int8_cache_is_not_ported_yet():
    """Ported since: the int8 cache is the reference's dict, and one
    decode step writes its codes and scales at the token's slot (its parity
    is held in ``tests/test_torch_int8.py``)."""
    _, cfg = lm.configs("qwen3-14b", serve_quant="int8")
    cache = tf.init_cache(cfg, 1, 8, device="cpu")
    assert cache["kv"]["kq"].dtype == torch.int8
    from repro_torch.models import attention
    f32 = dataclasses.replace(cfg, dtype="float32")
    p = attention.init_attn_params(f32, torch.float32, device="cpu")
    layer = {k: v[0].float() if v.is_floating_point() else v[0]
             for k, v in cache["kv"].items()}
    o, out = attention.attn_decode(p, torch.ones(1, 1, cfg.d_model), layer,
                                   torch.zeros((), dtype=torch.int32), f32)
    assert out is layer and o.shape == (1, 1, cfg.d_model)
    assert layer["kq"][:, 0].abs().max() == 127
    assert bool((layer["ks"][:, 0] > 0).all())
