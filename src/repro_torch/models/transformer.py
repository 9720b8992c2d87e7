"""Model assembly for the dense, audio, VLM and MoE families (port of the
serving half of ``repro.models.transformer``).

The reference stacks each pattern position's weights along a group axis and
applies the groups with ``lax.scan``; here every layer is a module of its
own (``params.groups[g][f"{kind}_{i}"]``, ``params.dense_prefix[j]``) and a
Python loop over them is the scan. The state dict's keys are the
reference's paths with the group index spliced in
(``groups.3.self_0.attn.wq`` is ``groups/self_0/attn/wq[3]``;
``convert.lm_params_from_numpy`` splits the axis). The decode cache keeps
the reference's stacked layout ([G, B, S, Hkv, dh] and so on), so it
compares leaf for leaf; each layer reads and writes its group's slice in
place.

Public API (``params`` is the :class:`~.layers.Params` tree that
:func:`init_params` returns):
    init_params(cfg, generator, device)              -> params
    init_cache(cfg, B, S_max, device)                -> decode cache
    prefill(params, batch, cfg, s_max)               -> (cache, last_logits)
    decode_step(params, cache, tokens, cfg,
                return_hidden)                       -> (cache, logits[, h])

``batch`` is a dict: tokens [B,S] (audio: [B,S,n_codebooks]); vlm adds
vision [B,Nv,vision_dim]. ``decode_step`` updates ``cache`` in place
(every leaf, ``pos`` included, stays at its address) and returns it; it
reads nothing on the host, so a CUDA graph can capture it.

Not ported yet (ROADMAP Queue 1): the hybrid and ssm families
(``models/recurrent.py``), the int8 cache (``serve_quant="int8"``),
``forward_train`` and its chunked loss (the training slice).
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from .config import ModelConfig
from .layers import Params, dense_init, gated_mlp, rmsnorm

PORTED_FAMILIES = ("dense", "audio", "vlm", "moe")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (models/recurrent.py) is "
            "not ported yet (ROADMAP Queue 1)")
    if cfg.serve_quant == "int8":
        raise NotImplementedError(
            f"{cfg.name}: the int8 cache (serve_quant='int8') is not ported "
            "yet (ROADMAP Queue 1)")


# ---------------------------------------------------------------------------
# Group structure
# ---------------------------------------------------------------------------

def group_layout(cfg: ModelConfig) -> tuple[int, tuple[str, ...]]:
    """(n_groups, pattern positions) of the reference's group axis."""
    if cfg.family in ("dense", "audio"):
        return cfg.n_layers, ("self",)
    if cfg.family == "moe":
        # dense prefix handled separately; groups cover the MoE layers
        return cfg.n_layers - cfg.first_k_dense, ("moe",)
    if cfg.family == "vlm":
        k = cfg.cross_attn_every
        if cfg.n_layers % k:
            raise ValueError((cfg.n_layers, k))
        return cfg.n_layers // k, tuple(["self"] * (k - 1) + ["cross"])
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        if cfg.n_layers % len(pat):
            raise ValueError((cfg.n_layers, pat))
        return cfg.n_layers // len(pat), pat
    if cfg.family == "ssm":
        k = cfg.slstm_every
        if cfg.n_layers % k:
            raise ValueError((cfg.n_layers, k))
        return cfg.n_layers // k, tuple(["mlstm"] * (k - 1) + ["slstm"])
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_mlp(cfg: ModelConfig, dt, gen, dev) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return Params(
        w_gate=dense_init((d, f), dt, generator=gen, device=dev),
        w_up=dense_init((d, f), dt, generator=gen, device=dev),
        w_down=dense_init((f, d), dt, fan_in=f, generator=gen, device=dev))


def _init_position(kind: str, cfg: ModelConfig, dt, gen, dev) -> Params:
    d = cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    if kind == "self":
        a = (mla_mod.init_mla_params(cfg, dt, gen, dev)
             if cfg.attn_kind == "mla"
             else attn.init_attn_params(cfg, dt, generator=gen, device=dev))
        return Params(ln1=zeros(d), attn=a, ln2=zeros(d),
                      mlp=_init_mlp(cfg, dt, gen, dev))
    if kind == "cross":
        return Params(
            ln1=zeros(d), attn=attn.init_attn_params(
                cfg, dt, cross=True, generator=gen, device=dev),
            gate=zeros(1),                   # llama-vision tanh gate
            ln2=zeros(d), mlp=_init_mlp(cfg, dt, gen, dev))
    if kind == "moe":
        return Params(ln1=zeros(d),
                      attn=mla_mod.init_mla_params(cfg, dt, gen, dev),
                      ln2=zeros(d),
                      moe=moe_mod.init_moe_params(cfg, dt, gen, dev))
    raise ValueError(kind)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> Params:
    """Random weights on ``device`` (the card unless the caller names
    another), drawn from ``generator`` (a generator of that device; torch's
    default one when None). Norm scales and the VLM gate start at zero, as
    in the reference. On ``meta`` every tensor has its shape and dtype and
    nothing is allocated, so a full config builds anywhere."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    n_groups, pattern = group_layout(cfg)
    d, V = cfg.d_model, cfg.vocab

    if cfg.family == "audio":
        embed = dense_init((cfg.n_codebooks, V, d), dt, fan_in=V,
                           generator=generator, device=dev)
    else:
        embed = dense_init((V, d), dt, generator=generator, device=dev)
    leaves = dict(embed=embed,
                  final_norm=torch.zeros((d,), dtype=dt, device=dev))
    if not cfg.tie_embeddings or cfg.family == "audio":
        leaves["unembed"] = dense_init((d, V * max(cfg.n_codebooks, 1)), dt,
                                       generator=generator, device=dev)
    leaves["groups"] = nn.ModuleList(
        nn.ModuleDict({f"{kind}_{i}": _init_position(kind, cfg, dt,
                                                     generator, dev)
                       for i, kind in enumerate(pattern)})
        for _ in range(n_groups))
    if cfg.family == "moe" and cfg.first_k_dense:
        leaves["dense_prefix"] = nn.ModuleList(
            _init_position("self", cfg, dt, generator, dev)
            for _ in range(cfg.first_k_dense))
    if cfg.family == "moe" and cfg.mtp_depth:
        # MTP: projection + one dense block + shared embed/unembed (trained
        # only; serving never reads it)
        leaves["mtp"] = Params(
            proj=dense_init((2 * d, d), dt, generator=generator, device=dev),
            block=_init_position("self", cfg, dt, generator, dev),
            ln=torch.zeros((d,), dtype=dt, device=dev))
    return Params(**leaves)


def _embed_tokens(params: Params, batch: dict, cfg: ModelConfig):
    tokens = batch["tokens"].long()
    if cfg.family == "audio":
        # sum of codebook embeddings; tokens [B, S, ncb]
        books = torch.arange(cfg.n_codebooks, device=tokens.device)
        x = params.embed[books, tokens].sum(dim=2)
    else:
        x = params.embed[tokens]
    if cfg.embed_scale:
        # sqrt(d_model) rounded to the model's dtype first, as the
        # reference's asarray(sqrt(d), x.dtype) is (55.5 at gemma-7b in bf16)
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    return x


def _logits(params: Params, h: torch.Tensor, cfg: ModelConfig):
    """(h @ unembed) in the model's dtype, then float32; the tied unembed
    is embed.T; audio [B, ncb, V]."""
    unembed = params.unembed if "unembed" in params else params.embed.T
    logits = (h @ unembed).float()
    if cfg.family == "audio":
        logits = logits.reshape(-1, cfg.n_codebooks, cfg.vocab)
    return logits


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, B: int, S_max: int, device=None) -> dict:
    """Per-group stacked decode state in the reference's layout."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    n_groups, pattern = group_layout(cfg)
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    cache: dict = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.family in ("dense", "audio"):
        cache["kv"] = (zeros(n_groups, B, S_max, Hkv, dh),
                       zeros(n_groups, B, S_max, Hkv, dh))
    elif cfg.family == "moe":
        cache["ckv"] = zeros(n_groups, B, S_max, cfg.mla_cache_dim)
        if cfg.first_k_dense:
            cache["ckv_prefix"] = zeros(cfg.first_k_dense, B, S_max,
                                        cfg.mla_cache_dim)
    elif cfg.family == "vlm":
        n_self = len(pattern) - 1
        cache["kv"] = (zeros(n_groups, n_self, B, S_max, Hkv, dh),
                       zeros(n_groups, n_self, B, S_max, Hkv, dh))
        Nv = cfg.n_vision_tokens
        cache["cross_kv"] = (zeros(n_groups, B, Nv, Hkv, dh),
                             zeros(n_groups, B, Nv, Hkv, dh))
    return cache


def _layer_cache(cache: dict, cfg: ModelConfig, g: int, i: int, kind: str):
    """The views of ``cache`` that layer (group g, position i) reads and
    writes."""
    if cfg.family in ("dense", "audio"):
        return cache["kv"][0][g], cache["kv"][1][g]
    if cfg.family == "moe":
        return cache["ckv"][g]
    if kind == "cross":
        return cache["cross_kv"][0][g], cache["cross_kv"][1][g]
    return cache["kv"][0][g, i], cache["kv"][1][g, i]


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def _apply_position_decode(p: Params, kind: str, x, pcache, pos,
                           cfg: ModelConfig):
    """x: [B,1,d]; the layer's cache is updated in place. Returns x'."""
    h = rmsnorm(x, p.ln1, cfg.rmsnorm_eps)
    if kind == "self":
        if cfg.attn_kind == "mla":
            o, _ = mla_mod.mla_decode(p.attn, h, pcache, pos, cfg)
        else:
            o, _ = attn.attn_decode(p.attn, h, pcache, pos, cfg)
        x = x + o
    elif kind == "cross":
        o = attn.cross_attn_decode(p.attn, h, pcache, cfg)
        x = x + torch.tanh(p.gate) * o
    elif kind == "moe":
        o, _ = mla_mod.mla_decode(p.attn, h, pcache, pos, cfg)
        x = x + o
        y, _ = moe_mod.moe_ffn(p.moe, rmsnorm(x, p.ln2, cfg.rmsnorm_eps),
                               cfg)
        return x + y
    else:
        raise ValueError(kind)
    h2 = rmsnorm(x, p.ln2, cfg.rmsnorm_eps)
    return x + gated_mlp(h2, p.mlp.w_gate, p.mlp.w_up, p.mlp.w_down,
                         cfg.activation)


@torch.no_grad()
def decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig, return_hidden: bool = False):
    """One decode step for a batch. tokens: [B] (audio [B, ncb]) on the
    cache's device. ``cache`` is updated in place and returned."""
    _check_ported(cfg)
    pos = cache["pos"]
    toks = tokens[:, None] if tokens.ndim == 1 else tokens[:, None, :]
    x = _embed_tokens(params, {"tokens": toks}, cfg)
    _, pattern = group_layout(cfg)

    for j, p in enumerate(params.dense_prefix
                          if "dense_prefix" in params else ()):
        x = _apply_position_decode(p, "self", x, cache["ckv_prefix"][j], pos,
                                   cfg)
    for g, group in enumerate(params.groups):
        for i, kind in enumerate(pattern):
            x = _apply_position_decode(group[f"{kind}_{i}"], kind, x,
                                       _layer_cache(cache, cfg, g, i, kind),
                                       pos, cfg)
    pos.add_(1)

    x = rmsnorm(x, params.final_norm, cfg.rmsnorm_eps)
    logits = _logits(params, x[:, 0], cfg)
    if return_hidden:
        return cache, logits, x[:, 0]
    return cache, logits


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def _apply_position_prefill(p: Params, kind: str, x, cfg: ModelConfig,
                            vision):
    """Returns (x', the layer's decode state)."""
    h = rmsnorm(x, p.ln1, cfg.rmsnorm_eps)
    if kind == "self":
        if cfg.attn_kind == "mla":
            o, new = mla_mod.mla_prefill(p.attn, h, cfg)
        else:
            o, new = attn.attn_prefill(p.attn, h, cfg)
        x = x + o
    elif kind == "cross":
        o = attn.cross_attn(p.attn, h, vision, cfg)
        x = x + torch.tanh(p.gate) * o
        new = attn.cross_attn_kv(p.attn, vision, cfg)
    elif kind == "moe":
        o, new = mla_mod.mla_prefill(p.attn, h, cfg)
        x = x + o
        y, _ = moe_mod.moe_ffn(p.moe, rmsnorm(x, p.ln2, cfg.rmsnorm_eps),
                               cfg)
        return x + y, new
    else:
        raise ValueError(kind)
    h2 = rmsnorm(x, p.ln2, cfg.rmsnorm_eps)
    return x + gated_mlp(h2, p.mlp.w_gate, p.mlp.w_up, p.mlp.w_down,
                         cfg.activation), new


def _store(dst, new, S: int, kind: str) -> None:
    """A layer's prefill state into its cache slice: the first S rows of a
    self-attention or latent cache, the whole cross KV."""
    if isinstance(dst, tuple):
        for d, n in zip(dst, new):
            _store(d, n, S, kind)
    elif kind == "cross":
        dst.copy_(new)
    else:
        dst[:, :S] = new


@torch.no_grad()
def prefill(params: Params, batch: dict, cfg: ModelConfig,
            s_max: int | None = None):
    """Process a full prompt; returns (cache, last-position logits).

    ``s_max``: decode-cache capacity (>= prompt length); defaults to the
    prompt length + 64 so generation can continue after prefill. The VLM's
    cross KV (``cross_attn_kv`` of the vision embeddings) is stored in
    ``cache["cross_kv"]`` for decode (the reference leaves it zero: ROADMAP
    Queue 3)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape[:2]
    x = _embed_tokens(params, batch, cfg)
    vision = batch.get("vision")
    _, pattern = group_layout(cfg)
    cache_S = s_max if s_max is not None else S + 64
    if cache_S < S:
        raise ValueError(f"s_max {cache_S} is below the prompt length {S}")
    cache = init_cache(cfg, B, cache_S, device=x.device)

    for j, p in enumerate(params.dense_prefix
                          if "dense_prefix" in params else ()):
        x, new = _apply_position_prefill(p, "self", x, cfg, vision)
        _store(cache["ckv_prefix"][j], new, S, "self")
    for g, group in enumerate(params.groups):
        for i, kind in enumerate(pattern):
            x, new = _apply_position_prefill(group[f"{kind}_{i}"], kind, x,
                                             cfg, vision)
            _store(_layer_cache(cache, cfg, g, i, kind), new, S, kind)
    cache["pos"].fill_(S)

    x = rmsnorm(x[:, -1:], params.final_norm, cfg.rmsnorm_eps)
    return cache, _logits(params, x[:, 0], cfg)
