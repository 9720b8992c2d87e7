"""Multi-head Latent Attention (DeepSeek V2/V3; port of ``repro.models.mla``).

KV activations are down-projected to a compact latent c_kv (kv_lora_rank)
plus a shared RoPE key slice; per-head keys/values are up-projected from the
latent. The KV cache stores only [B, S, kv_lora_rank + rope_head_dim].

Decode uses the absorbed formulation: W_UK is folded into the query
(q_lat = W_UK^T q_nope) and W_UV is applied after attending over latents, so
per-step FLOPs scale with kv_lora_rank instead of n_heads * head_dim and the
cache is read once. The new latent row is written in place at the token's
slot (``index_copy_`` at a device index).

Scores are bfloat16 products cast to float32, as in ``models.attention``;
the nope and rope products are each rounded to bfloat16 and then summed in
float32, as the reference computes ``(a + b).astype(f32)`` of two bfloat16
products once XLA has compiled it (the add is folded into the cast that
follows it, so the sum is not rounded to bfloat16).
The int8 latent cache (``serve_quant="int8"``: a dict ``{"q": int8
[B,S,r+dr], "s": float32 [B,S]}``) is read as the reference reads it: the
small side (the absorbed query, the scale-folded probabilities) is
quantized per row, the products run on the codes in int32 (the
``int8_dot`` kernel on the card: the scores as ``rows`` with one head
group, the values as ``cols`` over the first r codes of each row) and the
scales fold in after the product.
"""
from __future__ import annotations

import torch

from ..kernels import int8_dot
from ..runtime.spmd import gather_model, gathered_grad, per_head
from .attention import BF16, NEG_INF, _quant_rows, _softmax
from .config import ModelConfig
from .layers import Params, apply_rope, dense_init, recomputed, rmsnorm, \
    rope_freqs


def init_mla_params(cfg: ModelConfig, dtype,
                    generator: torch.Generator | None = None,
                    device=None) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    r = cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim

    def w(shape):
        return dense_init(shape, dtype, generator=generator, device=device)

    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = w((d, cfg.q_lora_rank))
        p["q_norm_lora"] = torch.zeros((cfg.q_lora_rank,), dtype=dtype,
                                       device=device)
        p["wq_b"] = w((cfg.q_lora_rank, H * (dn + dr)))
    else:
        p["wq"] = w((d, H * (dn + dr)))
    p["wkv_a"] = w((d, r + dr))                   # latent + rope key
    p["kv_norm_lora"] = torch.zeros((r,), dtype=dtype, device=device)
    p["wk_b"] = w((r, H * dn))                    # W_UK
    p["wv_b"] = w((r, H * dv))                    # W_UV
    p["wo"] = w((H * dv, d))
    return Params(**p)


def _queries(p: Params, x: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        q = rmsnorm(x @ p.wq_a, p.q_norm_lora, cfg.rmsnorm_eps) @ p.wq_b
    else:
        q = x @ p.wq
    q = gather_model(q, H).reshape(B, S, H, dn + dr)
    return q[..., :dn], q[..., dn:]                              # nope, rope


def _latent(p: Params, x: torch.Tensor, cfg: ModelConfig,
            pos: torch.Tensor):
    """c_kv (normalized latent) and rotated shared rope key."""
    B, S, _ = x.shape
    kv = x @ p.wkv_a
    c = rmsnorm(kv[..., :cfg.kv_lora_rank], p.kv_norm_lora, cfg.rmsnorm_eps)
    k_rope = kv[..., cfg.kv_lora_rank:].reshape(B, S, 1, cfg.rope_head_dim)
    cos, sin = rope_freqs(cfg.rope_head_dim, cfg.rope_theta, pos)
    k_rope = apply_rope(k_rope, cos, sin)[:, :, 0]               # [B,S,dr]
    return c, k_rope


def mla_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
              latent: tuple | None = None) -> torch.Tensor:
    """Full-sequence causal MLA (non-absorbed: materialize per-head k, v),
    one query chunk of ``attn_chunk`` at a time."""
    B, S, _ = x.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    pos = torch.arange(S, device=x.device)
    q_nope, q_rope = _queries(p, x, cfg)
    cos, sin = rope_freqs(dr, cfg.rope_theta, pos)
    q_rope = apply_rope(q_rope, cos, sin)
    c, k_rope = _latent(p, x, cfg, pos) if latent is None else latent
    k_nope = gather_model(c @ p.wk_b, H).reshape(B, S, H, dn)
    v = gather_model(c @ p.wv_b, H).reshape(B, S, H, dv)

    scale = (dn + dr) ** -0.5
    C = min(cfg.attn_chunk, S)
    if S % C:
        raise ValueError(f"prompt length {S} is not a multiple of the "
                         f"attention chunk {C}")

    def chunk(qn_c, qr_c, k_nope, k_rope, v, keep):
        s = (torch.einsum("bqhd,bkhd->bhqk", qn_c.to(BF16),
                          k_nope.to(BF16)).float()
             + torch.einsum("bqhd,bkd->bhqk", qr_c.to(BF16),
                            k_rope.to(BF16)).float()) * scale
        s = torch.where(keep[None, None, :, :], s, NEG_INF)
        pr = _softmax(s).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", pr, v)

    attend = recomputed(chunk) if cfg.attn_remat else chunk

    def core(q_nope, q_rope, k_nope, k_rope, v):
        key_pos = torch.arange(S, device=q_nope.device)
        outs = []
        for c0 in range(0, S, C):
            qpos = c0 + torch.arange(C, device=q_nope.device)
            keep = key_pos[None, :] <= qpos[:, None]
            outs.append(attend(q_nope[:, c0:c0 + C], q_rope[:, c0:c0 + C],
                               k_nope, k_rope, v, keep))
        return torch.cat(outs, dim=1)

    # over a mesh each rank attends with its own rows and heads
    o = per_head(core, (q_nope, 2), (q_rope, 2), (k_nope, 2),
                 (k_rope, None), (v, 2))
    o = gathered_grad(o.reshape(B, S, H * dv), H)
    return o @ p.wo


def mla_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Training-style attention + returns the latent cache [B,S,r+dr]."""
    pos = torch.arange(x.shape[1], device=x.device)
    c, k_rope = _latent(p, x, cfg, pos)
    out = mla_train(p, x, cfg, latent=(c, k_rope))
    return out, torch.cat([c, k_rope], dim=-1)


def _int8_dot(a_f: torch.Tensor, c_q: torch.Tensor, k: int | None = None):
    """Quantize the small side a_f [B, H, *] and contract it with the int8
    latent cache c_q [B, S, r+dr]: the scores ``bhr,bsr->bhs`` (``k``
    None) or the values ``bhs,bsr->bhr`` over the first ``k`` codes of each
    row. Returns (the int32 product, a_f's scales [B, H])."""
    a_q, a_s = _quant_rows(a_f)
    c4 = c_q[:, :, None]                                   # [B, S, 1, r+dr]
    out = (int8_dot.rows(a_q[:, None], c4) if k is None
           else int8_dot.cols(a_q[:, None], c4, k))
    return out[:, 0], a_s


def _int8_decode_core(q_full, c_q, c_s, keep, scale, r):
    """The absorbed query [B,H,r+dr] against the int8 latent cache (codes
    c_q [B,S,r+dr], scales c_s [B,S]) on whole (local) tensors: the
    attention over the latents, float32 [B,H,r]."""
    s_i32, q_s = _int8_dot(q_full, c_q)
    s = (s_i32.float() * q_s[..., None] * c_s[:, None, :]) * scale
    s = torch.where(keep[None, None, :], s, NEG_INF)
    pr = _softmax(s)                                       # f32 [B,H,S]
    pr_scaled = pr * c_s[:, None, :]                       # fold cache scales
    o_i32, p_s = _int8_dot(pr_scaled, c_q, r)
    return o_i32.float() * p_s[..., None]


def _decode_core(q_lat, q_rope, c, keep, scale, r):
    """The absorbed query (q_lat [B,H,r], q_rope [B,H,dr]) against the
    latent cache c [B,S,r+dr] on whole (local) tensors: the attention over
    the latents [B,H,r]."""
    c_all, k_rope_all = c[..., :r], c[..., r:]
    s = (torch.einsum("bhr,bsr->bhs", q_lat.to(BF16),
                      c_all.to(BF16)).float()
         + torch.einsum("bhd,bsd->bhs", q_rope.to(BF16),
                        k_rope_all.to(BF16)).float()) * scale
    s = torch.where(keep[None, None, :], s, NEG_INF)
    pr = _softmax(s).to(c_all.dtype)
    return torch.einsum("bhs,bsr->bhr", pr, c_all)    # attend over latents


def mla_decode(p: Params, x: torch.Tensor, cache, pos: torch.Tensor,
               cfg: ModelConfig):
    """Absorbed one-token decode against the latent cache [B, S_max, r+dr]
    (or its int8 dict), written in place at the token's slot and
    returned."""
    B = x.shape[0]
    H, dn, dr, dv, r = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                        cfg.v_head_dim, cfg.kv_lora_rank)
    q_nope, q_rope = _queries(p, x, cfg)                   # [B,1,H,*]
    cos, sin = rope_freqs(dr, cfg.rope_theta, pos[None])
    q_rope = apply_rope(q_rope, cos, sin)
    c_new, k_rope_new = _latent(p, x, cfg, pos[None])
    new_entry = torch.cat([c_new, k_rope_new.reshape(B, 1, dr)], dim=-1)
    quant = isinstance(cache, dict)
    S_max = (cache["q"] if quant else cache).shape[1]
    slot = torch.clamp(pos, max=S_max - 1).reshape(1).long()

    wk_b = p.wk_b.reshape(r, H, dn)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wk_b)   # absorb W_UK
    scale = (dn + dr) ** -0.5
    keep = torch.arange(S_max, device=x.device) <= pos

    # the new row is written into the caller's cache (over a mesh each
    # rank's own shard, ``spmd``'s index_copy_); then each rank attends
    # with its own rows and query heads over the whole latent cache (it
    # has no head axis)
    if quant:
        eq, es = _quant_rows(new_entry)                    # [B,1,*], [B,1]
        cache["q"].index_copy_(1, slot, eq)
        cache["s"].index_copy_(1, slot, es)
        q_full = torch.cat([q_lat, q_rope[:, 0]], dim=-1)  # [B,H,r+dr]
        o_lat = per_head(lambda q, c, cs, k: _int8_decode_core(
            q, c, cs, k, scale, r), (q_full, 1), (cache["q"], None),
            (cache["s"], None), keep)
    else:
        cache.index_copy_(1, slot, new_entry.to(cache.dtype))
        o_lat = per_head(lambda ql, qr, c, k: _decode_core(
            ql, qr, c, k, scale, r), (q_lat, 1), (q_rope[:, 0], 1),
            (cache, None), keep)

    wv_b = p.wv_b.reshape(r, H, dv)
    o = torch.einsum("bhr,rhd->bhd", o_lat.to(x.dtype), wv_b)  # absorb W_UV
    o = o.reshape(B, 1, H * dv)
    return o @ p.wo, cache
