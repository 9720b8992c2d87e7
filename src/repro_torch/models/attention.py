"""GQA/MQA/MHA attention with RoPE, qk-norm, sliding window and softcap (port
of ``repro.models.attention``).

Prefill uses *query-chunked exact attention*: a loop over query chunks of
``attn_chunk`` keeps the live score tensor at [B, H, chunk, S]. Decode
computes one token against the KV cache, whose row at the token's slot is
written in place (``index_copy_`` at a device index), so the step reads
nothing on the host and can be captured in a CUDA graph.

As in the reference, q and k are rounded to bfloat16 before the score
product even in a float32 model, and the product's result is bfloat16
(``torch.einsum`` on two bfloat16 tensors returns bfloat16, as
``jnp.einsum`` does) before it is cast to float32 and scaled; the
probabilities are cast to v's dtype before the value product.

The int8-quantized cache (``serve_quant="int8"``, a dict
``{"kq", "ks", "vq", "vs"}``: int8 codes with per-position-per-head float32
scales) is read as the reference reads it: q and the probabilities are
quantized by :func:`_quant_rows`, the products run on the codes in int32
(``kernels/int8_dot.py``: the ``int8_dot`` kernel on the card, an int32
einsum on the CPU) and the scales fold in after the product.
"""
from __future__ import annotations

import torch

from ..kernels import int8_dot
from ..runtime.spmd import gather_model, gathered_grad, per_head
from .config import ModelConfig
from .layers import Params, apply_rope, dense_init, recomputed, rmsnorm, \
    rope_freqs, softcap

NEG_INF = -2.0e38
BF16 = torch.bfloat16


def init_attn_params(cfg: ModelConfig, dtype, cross: bool = False,
                     generator: torch.Generator | None = None,
                     device=None) -> Params:
    d = cfg.d_model
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim
    kv_in = cfg.vision_dim if cross and cfg.vision_dim else d

    def w(shape):
        return dense_init(shape, dtype, generator=generator, device=device)

    p = dict(wq=w((d, hq)), wk=w((kv_in, hkv)), wv=w((kv_in, hkv)),
             wo=w((hq, d)))
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((cfg.head_dim,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((cfg.head_dim,), dtype=dtype, device=device)
    if cross:
        p["kv_norm"] = torch.zeros((kv_in,), dtype=dtype, device=device)
    return Params(**p)


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
         kv_src: torch.Tensor | None = None):
    """Project to per-head q, k, v. kv_src overrides the kv input (cross)."""
    kv_x = x if kv_src is None else kv_src
    q = _heads(x @ p.wq, cfg.n_heads, cfg)
    k = _heads(kv_x @ p.wk, cfg.n_kv_heads, cfg)
    v = _heads(kv_x @ p.wv, cfg.n_kv_heads, cfg)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.rmsnorm_eps)
        k = rmsnorm(k, p.k_norm, cfg.rmsnorm_eps)
    return q, k, v


def _heads(t: torch.Tensor, n: int, cfg: ModelConfig) -> torch.Tensor:
    """A projection [B, S, n*dh] as [B, S, n, dh] (over a mesh gathered
    over 'model' first where ``n`` does not divide that axis)."""
    return gather_model(t, n).reshape(t.shape[0], -1, n, cfg.head_dim)


def _grouped(q: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[B, S, H, dh] -> [B, S, Hkv, G, dh]."""
    B, S = q.shape[:2]
    g = cfg.n_heads // cfg.n_kv_heads
    return gather_model(q, cfg.n_kv_heads, g).reshape(
        B, S, cfg.n_kv_heads, g, cfg.head_dim)


def _merged(o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Grouped heads [B, S, Hkv, G, dh] as [B, S, H*dh] (over a mesh its
    gradient whole over 'model' where their split does not divide that
    axis)."""
    return gathered_grad(o.reshape(*o.shape[:2], -1), cfg.n_kv_heads,
                         cfg.n_heads // cfg.n_kv_heads)


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """The reference's explicit max / exp / sum, in float32; the max is a
    constant to autograd (the reference's ``stop_gradient``)."""
    m = torch.amax(s, dim=-1, keepdim=True).detach()
    e = torch.exp(s - m)
    return e / torch.sum(e, dim=-1, keepdim=True)


def _attend_chunk(q_c, k, v, mask, cfg: ModelConfig):
    """q_c [B,Cq,Hkv,G,dh] vs full k/v [B,S,Hkv,dh]; mask [Cq,S] bool(keep)."""
    scale = cfg.head_dim ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", q_c.to(BF16),
                     k.to(BF16)).float() * scale
    s = softcap(s, cfg.attn_logit_softcap)
    s = torch.where(mask[None, None, None, :, :], s, NEG_INF)
    pr = _softmax(s).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", pr, v)


def _causal_chunks(qg, k, v, cfg: ModelConfig) -> torch.Tensor:
    """Causal (and sliding-window) attention of grouped queries
    [B,S,Hkv,G,dh] over k/v, one query chunk of ``attn_chunk`` at a time
    (the reference's scan); [B, S, H*dh]. Over a mesh each rank attends
    with its own rows and heads (``spmd.per_head``): the KV heads sharded
    with their query groups, or a single KV head shared by query heads
    sharded within the group."""
    return _merged(_on_heads(_causal_core, qg, (k, v), cfg), cfg)


def _on_heads(core, qg, kv, cfg: ModelConfig, *whole):
    """``core(qg, *kv, *whole, cfg)`` through ``spmd.per_head``: grouped
    queries [B,(S,)Hkv,G,dh] against ``kv``, tensors [B,S,Hkv,...] (k and
    v, or an int8 cache's codes and scales), split by their KV heads, or
    with a single KV head by the query heads of its group (``kv`` then
    whole); ``whole`` (a mask) is every head's."""
    h = qg.ndim - 3
    if cfg.n_kv_heads == 1:
        heads = ((qg, h + 1),) + tuple((t, None) for t in kv)
    else:
        heads = ((qg, h),) + tuple((t, 2) for t in kv)
    return per_head(lambda *a: core(*a, cfg), *heads, *whole)


def _causal_core(qg, k, v, cfg: ModelConfig) -> torch.Tensor:
    """:func:`_causal_chunks` on whole tensors: [B,S,Hkv,G,dh]."""
    S = qg.shape[1]
    C = min(cfg.attn_chunk, S)
    if S % C:
        raise ValueError(f"prompt length {S} is not a multiple of the "
                         f"attention chunk {C}")
    key_pos = torch.arange(S, device=qg.device)
    # under attn_remat each chunk's scores are recomputed in the backward
    # (the reference's jax.checkpoint of its chunk body)
    attend = recomputed(_attend_chunk) if cfg.attn_remat else _attend_chunk
    outs = []
    for c0 in range(0, S, C):
        qpos = c0 + torch.arange(C, device=qg.device)
        keep = key_pos[None, :] <= qpos[:, None]
        if cfg.sliding_window is not None:
            keep &= key_pos[None, :] > qpos[:, None] - cfg.sliding_window
        outs.append(attend(qg[:, c0:c0 + C], k, v, keep, cfg))
    return torch.cat(outs, dim=1)


def attn_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
               pos0: int = 0) -> torch.Tensor:
    """Causal self-attention over the full sequence (chunked). x: [B,S,d]."""
    return _self_attention(p, x, cfg, pos0)[0]


def attn_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Like attn_train but also returns the (k, v) cache [B,S,Hkv,dh]."""
    return _self_attention(p, x, cfg, 0)


def _self_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, pos0: int):
    S = x.shape[1]
    q, k, v = _qkv(p, x, cfg)
    pos = pos0 + torch.arange(S, device=x.device)
    cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, pos)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = _causal_chunks(_grouped(q, cfg), k, v, cfg)
    return o @ p.wo, (k, v)


def _quant_rows(x: torch.Tensor, dim: int = -1):
    """Symmetric int8 quantization along ``dim`` with float32 scales:
    scale = max|x| / 127 + 1e-12, codes round(x / scale) (half to even, as
    ``jnp.round``) clipped to +-127. The 127 is a float32 tensor on x's
    device: CUDA computes a division by a Python float as a product by its
    reciprocal, which can round a scale an ulp away."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=dim, keepdim=True)
    scale = amax / torch.full((), 127.0, dtype=torch.float32,
                              device=x.device) + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(dim)


def attn_decode(p: Params, x: torch.Tensor, cache, pos: torch.Tensor,
                cfg: ModelConfig, ring: bool = False):
    """One-token decode. x: [B,1,d]; cache: (k, v) [B,Smax,Hkv,dh], or the
    int8 dict {"kq","ks","vq","vs"} ([B,Smax,Hkv,dh] codes, [B,Smax,Hkv]
    scales), written in place at the token's slot and returned; pos: int32
    [] on x's device.

    ``ring``: cache is a sliding-window ring buffer (local attention); the
    write index is pos % Smax and positions are reconstructed for masking.
    """
    B = x.shape[0]
    quant = isinstance(cache, dict)
    S_max = (cache["kq"] if quant else cache[0]).shape[1]
    q, k_new, v_new = _qkv(p, x, cfg)
    cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, pos[None])
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)
    slot = (torch.remainder(pos, S_max) if ring
            else torch.clamp(pos, max=S_max - 1))
    index = slot.reshape(1).long()

    qg = _grouped(q, cfg)[:, 0]                       # [B,Hkv,G,dh]
    kpos = torch.arange(S_max, device=x.device)
    if ring:
        # ring slot i holds absolute position pos - slot + i (i <= slot) or
        # pos - slot + i - S_max (i > slot)
        abs_pos = torch.where(kpos <= slot, pos - slot + kpos,
                              pos - slot + kpos - S_max)
        keep = (abs_pos >= 0) & (abs_pos <= pos)
        if cfg.sliding_window is not None:
            keep &= abs_pos > pos - cfg.sliding_window
    else:
        keep = kpos <= pos
        if cfg.sliding_window is not None:
            keep &= kpos > pos - cfg.sliding_window
    if quant:
        # the rows are written into the caller's cache tensors (over a
        # mesh each rank's own shard, ``spmd``'s index_copy_), then read
        # on each rank's own rows and heads
        for name, t in zip(("kq", "ks", "vq", "vs"),
                           (*_quant_rows(k_new), *_quant_rows(v_new))):
            cache[name].index_copy_(1, index, t)
        o = _on_heads(_int8_decode_core, qg, tuple(
            cache[n] for n in ("kq", "ks", "vq", "vs")), cfg, keep)
        o = o.to(x.dtype)
    else:
        k_cache, v_cache = cache
        k_cache.index_copy_(1, index, k_new.to(k_cache.dtype))
        v_cache.index_copy_(1, index, v_new.to(v_cache.dtype))
        o = _on_heads(_decode_core, qg, (k_cache, v_cache), cfg, keep)
    return _merged(o[:, None], cfg) @ p.wo, cache


def _int8_decode_core(qg, kq, ks, vq, vs, keep, cfg: ModelConfig):
    """One query token against the int8 cache, on whole (local) tensors:
    qg [B,Hkv,G,dh] quantized per row, the scores and values contracted
    on the codes (``int8_dot``) with kq/vq [B,S,Hkv,dh], the scales ks/vs
    [B,S,Hkv] folded in after each product; float32 [B,Hkv,G,dh]."""
    qq, qs = _quant_rows(qg)                          # [B,Hkv,G,dh],[B,Hkv,G]
    s = (int8_dot.rows(qq, kq).float() * qs[..., None]
         * ks.transpose(1, 2)[:, :, None, :]) * cfg.head_dim ** -0.5
    s = softcap(s, cfg.attn_logit_softcap)
    s = torch.where(keep[None, None, None, :], s, NEG_INF)
    pr = _softmax(s) * vs.transpose(1, 2)[:, :, None, :]
    pq, ps = _quant_rows(pr)                          # [B,Hkv,G,S]
    return int8_dot.cols(pq, vq).float() * ps[..., None]


def _decode_core(qg, k, v, keep, cfg: ModelConfig, cap=True):
    """One query token's attention, [B,Hkv,G,dh] over k/v [B,S,Hkv,dh]:
    the score product, the logit softcap (``cap``; cross attention has
    none), the mask ``keep`` [S] (None: none), the softmax and the value
    product."""
    s = torch.einsum("bhgd,bshd->bhgs", qg.to(BF16),
                     k.to(BF16)).float() * cfg.head_dim ** -0.5
    if cap:
        s = softcap(s, cfg.attn_logit_softcap)
    if keep is not None:
        s = torch.where(keep[None, None, None, :], s, NEG_INF)
    pr = _softmax(s).to(v.dtype)
    return torch.einsum("bhgs,bshd->bhgd", pr, v)


# ---------------------------------------------------------------------------
# Cross-attention (VLM): queries from text stream, kv from vision embeddings
# ---------------------------------------------------------------------------

def _vision_in(vis: torch.Tensor, p: Params) -> torch.Tensor:
    """The normalised vision embeddings in the type their product with wk
    takes (JAX promotes bfloat16 embeddings against float32 weights; torch
    multiplies only equal types)."""
    return vis.to(torch.promote_types(vis.dtype, p.wk.dtype))


def cross_attn(p: Params, x: torch.Tensor, vis: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: [B,S,d]; vis: [B,Nv,vision_dim]. No causal mask, no rope."""
    B, S, _ = x.shape
    vis = _vision_in(rmsnorm(vis, p.kv_norm, cfg.rmsnorm_eps), p)
    q, k, v = _qkv(p, x, cfg, kv_src=vis)
    o = _on_heads(_cross_core, _grouped(q, cfg), (k, v), cfg)
    return _merged(o, cfg) @ p.wo


def _cross_core(qg, k, v, cfg: ModelConfig):
    """Grouped queries [B,S,Hkv,G,dh] over every vision position of k/v
    [B,Nv,Hkv,dh]: no mask, no softcap."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(BF16),
                     k.to(BF16)).float() * cfg.head_dim ** -0.5
    pr = _softmax(s).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", pr, v)


def cross_attn_kv(p: Params, vis: torch.Tensor, cfg: ModelConfig):
    """Precompute cross KV from vision embeddings (cached for decode)."""
    vis = _vision_in(rmsnorm(vis, p.kv_norm, cfg.rmsnorm_eps), p)
    k = _heads(vis @ p.wk, cfg.n_kv_heads, cfg)
    v = _heads(vis @ p.wv, cfg.n_kv_heads, cfg)
    if cfg.qk_norm:
        k = rmsnorm(k, p.k_norm, cfg.rmsnorm_eps)
    return k, v


def cross_attn_decode(p: Params, x: torch.Tensor, kv: tuple,
                      cfg: ModelConfig) -> torch.Tensor:
    """Decode-time cross-attention against cached vision KV."""
    B = x.shape[0]
    k, v = kv
    q = _heads(x @ p.wq, cfg.n_heads, cfg)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.rmsnorm_eps)
    o = _on_heads(lambda qg, k, v, cfg: _decode_core(qg, k, v, None, cfg,
                                                    cap=False),
                  _grouped(q, cfg)[:, 0], (k, v), cfg)
    return _merged(o[:, None], cfg) @ p.wo
