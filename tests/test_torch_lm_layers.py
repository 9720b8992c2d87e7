"""Port parity: the LM's layers (``repro_torch.models.{layers,attention,
mla,moe}`` vs ``repro.models.*``), float32, every weight drawn with numpy.

Tolerances: rtol = atol = 1e-5 for the elementwise layers (norm, RoPE,
gated MLPs, softcap, the loss); rtol = atol = 1e-4 for attention, MLA and
MoE outputs and caches (float32 products summed in another order; the
score products round to bfloat16 in both packages on the same inputs).
MoE routing is held exactly: expert ids, keep masks and dispatch slots are
equal, ties (lowest index first, as ``lax.top_k``) and capacity drops
included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import Params

import _torch_lm as lm

# the reference's layers compiled, as its serving path runs them (XLA
# rounds some bfloat16 sums otherwise than op by op: models/mla.py)
J = dict(
    attn_prefill=jax.jit(jattn.attn_prefill, static_argnums=2),
    attn_train=jax.jit(jattn.attn_train, static_argnums=(2, 3)),
    attn_decode=jax.jit(jattn.attn_decode, static_argnums=(4, 5)),
    cross_attn=jax.jit(jattn.cross_attn, static_argnums=3),
    cross_attn_kv=jax.jit(jattn.cross_attn_kv, static_argnums=2),
    cross_attn_decode=jax.jit(jattn.cross_attn_decode, static_argnums=3),
    mla_prefill=jax.jit(jmla.mla_prefill, static_argnums=2),
    mla_decode=jax.jit(jmla.mla_decode, static_argnums=4),
    moe_ffn=jax.jit(jmoe.moe_ffn, static_argnums=2),
)
ELEM = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, S_MAX = 2, 16, 24


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


def _pair(init, seed=0, scale_vec=0.3):
    """A layer's weights in both packages: the reference's ``init`` shapes
    (through eval_shape), numpy draws (matrices N(0, 1/fan_in), vectors
    N(0, scale_vec^2) so norm offsets are not zero)."""
    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, s in shapes.items():
        scale = 1.0 / np.sqrt(s.shape[-2]) if len(s.shape) >= 2 else scale_vec
        arrays[k] = (rng.standard_normal(s.shape) * scale).astype(np.float32)
    return ({k: jnp.asarray(a) for k, a in arrays.items()},
            Params(**{k: torch.from_numpy(a.copy())
                      for k, a in arrays.items()}))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# --- elementwise layers -----------------------------------------------------

def test_norm_rope_mlp_softcap_and_loss():
    x, sc = _x((3, 5, 16)), _x((16,), 2)
    _close(tlayers.rmsnorm(_t(x), _t(sc), 1e-6),
           jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(sc), 1e-6), "rmsnorm",
           ELEM)
    pos = np.arange(7) * 3
    cj, sj = jlayers.rope_freqs(16, 1e6, jnp.asarray(pos))
    ct, st = tlayers.rope_freqs(16, 1e6, torch.from_numpy(pos))
    _close(ct, cj, "cos", ELEM)
    _close(st, sj, "sin", ELEM)
    q = _x((2, 7, 4, 16), 3)
    _close(tlayers.apply_rope(_t(q), ct, st),
           jlayers.apply_rope(jnp.asarray(q), cj, sj), "rope", ELEM)
    wg, wu, wd = _x((16, 32), 4) / 4, _x((16, 32), 5) / 4, _x((32, 16), 6) / 6
    for act in ("swiglu", "geglu"):
        _close(tlayers.gated_mlp(_t(x), _t(wg), _t(wu), _t(wd), act),
               jlayers.gated_mlp(*map(jnp.asarray, (x, wg, wu, wd)), act),
               act, ELEM)
    s = _x((4, 9), 7) * 40
    _close(tlayers.softcap(_t(s), 30.0),
           jlayers.softcap(jnp.asarray(s), 30.0), "softcap", ELEM)
    labels = np.random.default_rng(8).integers(0, 9, (4,))
    mask = np.array([1, 0, 1, 1], np.float32)
    for m in (None, mask):
        _close(tlayers.cross_entropy(_t(s), torch.from_numpy(labels),
                                     None if m is None else _t(m)),
               jlayers.cross_entropy(jnp.asarray(s), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m)),
               "cross_entropy", ELEM)


def test_dense_init_scale_dtype_and_meta():
    g = torch.Generator().manual_seed(0)
    w = tlayers.dense_init((512, 256), torch.bfloat16, generator=g)
    assert w.dtype == torch.bfloat16 and w.shape == (512, 256)
    assert abs(float(w.float().std()) * np.sqrt(512) - 1.0) < 0.02
    w = tlayers.dense_init((64, 8, 32), torch.float32, fan_in=8, generator=g)
    assert abs(float(w.std()) * np.sqrt(8) - 1.0) < 0.02
    m = tlayers.dense_init((10 ** 6, 10 ** 5), torch.bfloat16, device="meta")
    assert m.is_meta and m.shape == (10 ** 6, 10 ** 5)


def test_embedding_scale_is_rounded_to_the_model_dtype():
    """gemma-7b in bfloat16 scales by sqrt(3072) rounded to bfloat16 (55.5,
    not 55.43), as the reference's asarray(sqrt(d), x.dtype) does."""
    jcfg, cfg = lm.configs("gemma-7b", d_model=3072)
    emb = _x((cfg.vocab, 3072), 9)
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (2, 5))
    want = jtf._embed_tokens({"embed": jnp.asarray(emb, jnp.bfloat16)},
                             {"tokens": jnp.asarray(toks)}, jcfg)
    got = ttf._embed_tokens(Params(embed=_t(emb).to(torch.bfloat16)),
                            {"tokens": torch.from_numpy(toks)}, cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    ratio = got.float() / _t(emb[toks]).to(torch.bfloat16).float()
    assert torch.allclose(ratio, torch.tensor(55.5), rtol=4e-3)


# --- attention ----------------------------------------------------------------

GQA_CASES = {
    "qk_norm": {},
    "window_softcap": dict(sliding_window=5, attn_logit_softcap=20.0),
}


def _gqa_cfgs(over):
    return lm.configs("qwen3-14b", dtype="float32", **over)


@pytest.mark.parametrize("case", sorted(GQA_CASES))
def test_gqa_prefill_and_decode(case):
    jcfg, cfg = _gqa_cfgs(GQA_CASES[case])
    assert cfg.qk_norm and cfg.n_heads == 4 * cfg.n_kv_heads
    jp, tp = _pair(lambda: jattn.init_attn_params(
        jax.random.PRNGKey(0), jcfg, jnp.float32))
    x = _x((B, S, cfg.d_model))
    oj, (kj, vj) = J["attn_prefill"](jp, jnp.asarray(x), jcfg)
    ot, (kt, vt) = tattn.attn_prefill(tp, _t(x), cfg)
    _close(ot, oj, "prefill out")
    _close(kt, kj, "prefill k")
    _close(vt, vj, "prefill v")
    _close(tattn.attn_train(tp, _t(x), cfg, pos0=3),
           J["attn_train"](jp, jnp.asarray(x), jcfg, pos0=3), "train")
    # decode at a filled position, at the last slot and past it (clamped),
    # and on a ring buffer
    kc = _x((B, S_MAX, cfg.n_kv_heads, cfg.head_dim), 2)
    vc = _x((B, S_MAX, cfg.n_kv_heads, cfg.head_dim), 3)
    xd = _x((B, 1, cfg.d_model), 4)
    for pos, ring in ((7, False), (S_MAX - 1, False), (S_MAX + 5, False),
                      (S_MAX + 5, True)):
        oj, (kj, vj) = J["attn_decode"](
            jp, jnp.asarray(xd), (jnp.asarray(kc), jnp.asarray(vc)),
            jnp.asarray(pos, jnp.int32), jcfg, ring=ring)
        cache = (_t(kc), _t(vc))
        ot, (kt, vt) = tattn.attn_decode(tp, _t(xd), cache,
                                         torch.tensor(pos, dtype=torch.int32),
                                         cfg, ring=ring)
        assert kt is cache[0] and vt is cache[1]      # written in place
        what = f"decode pos {pos} ring {ring}"
        _close(ot, oj, what)
        _close(kt, kj, what + " k")
        _close(vt, vj, what + " v")


def test_cross_attention_with_a_nonzero_gate():
    jcfg, cfg = lm.configs("llama-3.2-vision-90b", dtype="float32")
    jp, tp = _pair(lambda: jattn.init_attn_params(
        jax.random.PRNGKey(0), jcfg, jnp.float32, cross=True))
    assert float(np.abs(np.asarray(jp["kv_norm"])).max()) > 0
    x = _x((B, S, cfg.d_model))
    vis = _x((B, cfg.n_vision_tokens, cfg.vision_dim), 5)
    _close(tattn.cross_attn(tp, _t(x), _t(vis), cfg),
           J["cross_attn"](jp, jnp.asarray(x), jnp.asarray(vis), jcfg),
           "cross_attn")
    kvj = J["cross_attn_kv"](jp, jnp.asarray(vis), jcfg)
    kvt = tattn.cross_attn_kv(tp, _t(vis), cfg)
    for a, b in zip(kvt, kvj):
        _close(a, b, "cross_attn_kv")
    xd = _x((B, 1, cfg.d_model), 6)
    _close(tattn.cross_attn_decode(tp, _t(xd), kvt, cfg),
           J["cross_attn_decode"](jp, jnp.asarray(xd), kvj, jcfg),
           "cross_attn_decode")
    # bfloat16 vision embeddings against float32 weights (the launcher's
    # inputs): promoted as JAX promotes them
    vb = jnp.asarray(vis, jnp.bfloat16)
    _close(tattn.cross_attn(tp, _t(x), _t(vis).to(torch.bfloat16), cfg),
           J["cross_attn"](jp, jnp.asarray(x), vb, jcfg), "bf16 vision")


# --- MLA ----------------------------------------------------------------------

@pytest.mark.parametrize("q_lora", [32, 0], ids=["q_lora", "dense_q"])
def test_mla_prefill_and_absorbed_decode(q_lora):
    jcfg, cfg = lm.configs("deepseek-v2-236b", dtype="float32",
                           q_lora_rank=q_lora)
    jp, tp = _pair(lambda: jmla.init_mla_params(
        jax.random.PRNGKey(0), jcfg, jnp.float32))
    assert ("wq_a" in tp) == bool(q_lora)
    x = _x((B, S, cfg.d_model))
    oj, cj = J["mla_prefill"](jp, jnp.asarray(x), jcfg)
    ot, ct = tmla.mla_prefill(tp, _t(x), cfg)
    _close(ot, oj, "mla_prefill out")
    _close(ct, cj, "mla_prefill cache")
    cache = _x((B, S_MAX, cfg.mla_cache_dim), 7)
    xd = _x((B, 1, cfg.d_model), 8)
    for pos in (9, S_MAX + 2):
        oj, cj = J["mla_decode"](jp, jnp.asarray(xd), jnp.asarray(cache),
                                 jnp.asarray(pos, jnp.int32), jcfg)
        c = _t(cache)
        ot, ct = tmla.mla_decode(tp, _t(xd), c,
                                 torch.tensor(pos, dtype=torch.int32), cfg)
        assert ct is c
        _close(ot, oj, f"mla_decode pos {pos}")
        _close(ct, cj, f"mla_decode cache pos {pos}")


# --- MoE ----------------------------------------------------------------------

def _ref_route(p, xf, cfg):
    """The reference's routing and capacity lines (``repro/models/moe.py``
    moe_ffn, lines 134-152), which it computes inline."""
    T, E, k = xf.shape[0], cfg.n_experts, cfg.moe_top_k
    C = jmoe.capacity(T, cfg)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
    _, ids = jax.lax.top_k(probs, k)
    ids_flat = ids.reshape(T * k)
    onehot = jax.nn.one_hot(ids_flat, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    pos_flat = jnp.sum(pos * onehot, axis=-1)
    keep = pos_flat < C
    dest = jnp.where(keep, ids_flat * C + pos_flat, E * C)
    return ids, keep, dest, C


MOE_CASES = ("random", "tied_columns", "uniform_rows", "capacity_drops")


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_routing_ties_drops_and_output(case):
    jcfg, cfg = lm.configs("deepseek-v2-236b", dtype="float32")
    jp, tp = _pair(lambda: jmoe.init_moe_params(
        jax.random.PRNGKey(0), jcfg, jnp.float32))
    x = _x((B, S, cfg.d_model), 11)
    router = np.asarray(jp["router"]).copy()
    if case == "tied_columns":       # experts 2, 5 and 6 always tie
        router[:, 5] = router[:, 2]
        router[:, 6] = router[:, 2]
        router[:, 2] *= 3.0
        router[:, 5], router[:, 6] = router[:, 2], router[:, 2]
    elif case == "uniform_rows":     # zero tokens: every expert ties
        x[0, ::2] = 0.0
    elif case == "capacity_drops":   # every token prefers expert 3 and 1
        router[:, 3] = 0.0
        router[:, 1] = 0.0
        x[..., 0] = np.abs(x[..., 0]) + 4.0
        router[0, 3], router[0, 1] = 3.0, 2.0
    jp = dict(jp, router=jnp.asarray(router))
    tp.router.data.copy_(torch.from_numpy(router))
    xf = x.reshape(B * S, -1)
    ids, keep, dest, C = _ref_route(jp, jnp.asarray(xf), jcfg)
    rt = tmoe.moe_route(tp, _t(xf), cfg)
    assert rt["C"] == C
    np.testing.assert_array_equal(rt["ids"].numpy(), np.asarray(ids))
    np.testing.assert_array_equal(rt["keep"].numpy(), np.asarray(keep))
    np.testing.assert_array_equal(rt["dest"].numpy(), np.asarray(dest))
    if case == "capacity_drops":
        assert not bool(rt["keep"].all())
    if case in ("tied_columns", "uniform_rows"):
        probs = rt["probs"]
        top = torch.gather(probs, 1, rt["ids"])
        assert bool((top[:, 0] == top[:, 1]).any())    # a tie was taken
    yj, auxj = J["moe_ffn"](jp, jnp.asarray(x), jcfg)
    yt, auxt = tmoe.moe_ffn(tp, _t(x), cfg)
    _close(yt, yj, f"moe {case}")
    _close(auxt, auxj, f"aux {case}")


def test_moe_without_shared_experts_and_mesh_refused():
    jcfg, cfg = lm.configs("deepseek-v2-236b", dtype="float32",
                           n_shared_experts=0, moe_top_k=3)
    jp, tp = _pair(lambda: jmoe.init_moe_params(
        jax.random.PRNGKey(0), jcfg, jnp.float32))
    assert "shared_gate" not in tp
    x = _x((B, 3, cfg.d_model), 12)
    _close(tmoe.moe_ffn(tp, _t(x), cfg)[0],
           J["moe_ffn"](jp, jnp.asarray(x), jcfg)[0], "moe no shared")
    assert tmoe.capacity(16, dataclasses.replace(
        cfg, n_experts=4, moe_top_k=2, capacity_factor=1.5)) == 16
    # a mesh without moe_groups takes the global routing, as the
    # reference's moe_ffn does (moe_ffn_ep: tests/test_torch_mesh_run.py)
    assert cfg.moe_groups == 0
    torch.testing.assert_close(tmoe.moe_ffn(tp, _t(x), cfg, mesh=object()),
                               tmoe.moe_ffn(tp, _t(x), cfg), rtol=0, atol=0)


def test_params_round_trip_through_numpy():
    jcfg, cfg = lm.configs("llama-3.2-vision-90b")
    tree = lm.draw_tree(jcfg, 0)
    params = convert.lm_params_from_numpy(cfg, tree)
    back = convert.lm_params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        want = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
        np.testing.assert_array_equal(b, want, err_msg=str(path))


@pytest.mark.parametrize("name", ["qwen3-14b", "llama-3.2-vision-90b",
                                  "deepseek-v2-236b"])
def test_decode_from_the_reference_s_cache(name):
    """A decode cache drawn in the reference's layout crosses with
    ``lm_cache_from_numpy``; one decode step of each package from it gives
    the same logits and cache (``lm_cache_to_numpy``)."""
    jcfg, jp, cfg, tp = lm.models(name, dtype="float32")
    shapes = jax.eval_shape(lambda: jtf.init_cache(jcfg, B, S_MAX))
    rng = np.random.default_rng(13)
    cache = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    cache["pos"] = np.int32(S - 3)
    tok = rng.integers(0, cfg.vocab, (B,)).astype(np.int32)
    jc, jl = lm.ref_decode(jp, jax.tree.map(jnp.asarray, cache),
                           jnp.asarray(tok), jcfg)
    tc, tl = ttf.decode_step(tp, convert.lm_cache_from_numpy(cfg, cache),
                             torch.from_numpy(tok), cfg)
    tol = dict(rtol=1e-3, atol=1e-3)       # tests/test_torch_lm.py's rule
    _close(tl, jl, f"{name} logits", tol)
    got = convert.lm_cache_to_numpy(tc)
    for path, want in jax.tree_util.tree_leaves_with_path(jc):
        have = got
        for p in path:
            have = have[p.key if hasattr(p, "key") else p.idx]
        _close(have, want, f"{name} cache {path}", tol)
