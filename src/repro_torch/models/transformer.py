"""Model assembly for every family of the registry: dense, audio, VLM, MoE,
hybrid (RecurrentGemma) and ssm (xLSTM) (port of the serving half of
``repro.models.transformer``).

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
    forward_train(params, batch, cfg, mesh)          -> (loss, metrics)
    init_cache(cfg, B, S_max, device)                -> decode cache
    prefill(params, batch, cfg, s_max, mesh)         -> (cache, last_logits)
    decode_step(params, cache, tokens, cfg,
                return_hidden)                       -> (cache, logits[, h])

``batch`` is a dict: tokens [B,S] (audio: [B,S,n_codebooks]); vlm adds
vision [B,Nv,vision_dim]; training adds labels (and, for MTP,
tokens_next and labels_mtp). ``decode_step`` updates ``cache`` in place
(every leaf, ``pos`` included, stays at its address) and returns it; it
reads nothing on the host, so a CUDA graph can capture it.

The hybrid family's local attention keeps a ring cache of
``sliding_window`` slots (prefill writes the prompt's last rows into slot
pos % W, :func:`_to_ring`) and its RG-LRU layers ``cache["rec"]``; the ssm
family keeps ``cache["mlstm"]`` and ``cache["slstm"]`` (nested dicts of
stacked leaves, the recurrent states in float32). Under
``serve_quant="int8"`` :func:`init_cache` builds the reference's int8 KV
and latent caches (``{"kq", "ks", "vq", "vs"}``, ``{"q", "s"}``) and
decode contracts them with the ``int8_dot`` kernel
(``models/attention.py``, ``models/mla.py``); :func:`prefill` returns a
float cache there, as the reference's does (its ``_rebuild_cache``
replaces the int8 dicts), so int8 decode starts from :func:`init_cache`.

Training: :func:`forward_train` is the reference's next-token loss with
its MoE auxiliary term and DeepSeek-V3's multi-token-prediction head. Each
pattern group is one ``torch.utils.checkpoint`` region under
``cfg.remat_policy`` (:func:`_remat`: ``"nothing"`` keeps only a group's
input and recomputes the rest in the backward, ``"dots"`` keeps the
weight products, ``"full"`` keeps everything), and the loss over the
vocabulary is taken a chunk of 512 positions at a time, each chunk's
logits recomputed in the backward (:func:`_logits_chunked`), so the
[B, S, V] float32 logits never exist at once. It writes nothing in place,
so ``torch.func.functional_call`` can run it on a flat dict of tensors
(``runtime/steps.py``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..runtime.spmd import gather_model, lookup
from . import attention as attn
from . import mla as mla_mod
from . import moe as moe_mod
from . import recurrent as rec
from .config import ModelConfig
from .layers import Params, cross_entropy, dense_init, gated_mlp, \
    recomputed, rmsnorm

PORTED_FAMILIES = ("dense", "audio", "vlm", "moe", "hybrid", "ssm")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


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
    if kind == "local_attn":
        return Params(ln1=zeros(d), attn=attn.init_attn_params(
            cfg, dt, generator=gen, device=dev), ln2=zeros(d),
            mlp=_init_mlp(cfg, dt, gen, dev))
    if kind == "rglru":
        return Params(ln1=zeros(d),
                      rec=rec.init_rglru_params(cfg, dt, gen, dev),
                      ln2=zeros(d), mlp=_init_mlp(cfg, dt, gen, dev))
    if kind == "mlstm":
        return Params(ln1=zeros(d),
                      cell=rec.init_mlstm_params(cfg, dt, gen, dev))
    if kind == "slstm":
        return Params(ln1=zeros(d),
                      cell=rec.init_slstm_params(cfg, dt, gen, dev))
    raise ValueError(kind)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> Params:
    """Random weights on ``device`` (the card unless the caller names
    another), drawn from ``generator`` (a generator of that device; torch's
    default one when None). Norm scales and the VLM gate start at zero, as
    in the reference. On ``meta`` every tensor has its shape and dtype and
    nothing is allocated, so a full config builds anywhere."""
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
        x = lookup(params.embed, tokens, books)
    else:
        x = lookup(params.embed, tokens)
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
        logits = gather_model(logits, cfg.n_codebooks).reshape(
            -1, cfg.n_codebooks, cfg.vocab)
    return logits


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

# the products the "dots" policy keeps (the reference's
# checkpoint_dots_with_no_batch_dims): a [.., d] @ [d, f] weight product
# reaches the dispatcher as a 2-D mm; the attention and expert products are
# batched (bmm) and recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat_policy`` (the reference's ``jax.checkpoint``
    of a group): ``"full"`` keeps every activation for the backward (no
    checkpoint), ``"dots"`` keeps the 2-D weight products and recomputes
    the rest, ``"nothing"`` keeps only the inputs and recomputes the
    whole group. Without a gradient being recorded ``fn`` runs as is."""
    if cfg.remat_policy == "full":
        return fn
    if cfg.remat_policy == "dots":
        return recomputed(fn, _dots_context)
    if cfg.remat_policy != "nothing":
        raise ValueError(f"remat_policy {cfg.remat_policy!r}")
    return recomputed(fn)


def _mlp(p: Params, x, cfg: ModelConfig):
    h2 = rmsnorm(x, p.ln2, cfg.rmsnorm_eps)
    return x + gated_mlp(h2, p.mlp.w_gate, p.mlp.w_up, p.mlp.w_down,
                         cfg.activation)


def _apply_position_train(p: Params, kind: str, x, cfg: ModelConfig,
                          vision, mesh=None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer over the whole sequence; returns (x', aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(x, p.ln1, cfg.rmsnorm_eps)
    if kind in ("self", "local_attn"):
        o = (mla_mod.mla_train(p.attn, h, cfg) if cfg.attn_kind == "mla"
             else attn.attn_train(p.attn, h, cfg))
        x = _mlp(p, x + o, cfg)
    elif kind == "cross":
        o = attn.cross_attn(p.attn, h, vision, cfg)
        x = _mlp(p, x + torch.tanh(p.gate) * o, cfg)
    elif kind == "moe":
        x = x + mla_mod.mla_train(p.attn, h, cfg)
        y, aux = moe_mod.moe_ffn(p.moe, rmsnorm(x, p.ln2, cfg.rmsnorm_eps),
                                 cfg, mesh=mesh)
        x = x + y
    elif kind == "rglru":
        x = _mlp(p, x + rec.rglru_train(p.rec, h, cfg), cfg)
    elif kind == "mlstm":
        x = x + rec.mlstm_train(p.cell, h, cfg)
    elif kind == "slstm":
        x = x + rec.slstm_train(p.cell, h, cfg)
    else:
        raise ValueError(kind)
    return x, aux


LOSS_CHUNK = 512


def _chunk_ce(xc, unembed, lc, cfg: ModelConfig):
    logits = xc @ unembed
    if cfg.family == "audio":      # over a mesh the split gathered first
        logits = gather_model(logits, cfg.n_codebooks).reshape(
            *xc.shape[:2], cfg.n_codebooks, cfg.vocab)
    return cross_entropy(logits, lc)


def _logits_chunked(params: Params, x, cfg: ModelConfig, labels):
    """Mean CE over the vocabulary without the [B, S, V] float32 logits:
    C = min(512, S) positions at a time, the chunks' CE summed in order
    with weight 1/(S/C), as the reference's scan sums them; under autograd
    each chunk's logits are recomputed in the backward. S must be a
    multiple of C (the reference's reshape requires it)."""
    S = x.shape[1]
    unembed = params.unembed if "unembed" in params else params.embed.T
    C = min(LOSS_CHUNK, S)
    if S % C:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"loss chunk {C}")
    nc = S // C
    ce = recomputed(_chunk_ce)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, C):
        tot = tot + ce(x[:, c0:c0 + C], unembed, labels[:, c0:c0 + C],
                       cfg) * (1.0 / nc)
    return tot


def forward_train(params: Params, batch: dict, cfg: ModelConfig,
                  mesh=None):
    """Next-token LM loss (audio: per-codebook CE; vlm: text CE); returns
    (loss, metrics) with ``lm_loss``, ``aux_loss`` (the MoE load-balance
    term, summed over the MoE layers), ``mtp_loss`` (MTP only) and
    ``loss`` = lm_loss (+ 0.001 aux_loss for MoE, + 0.3 mtp_loss with
    MTP), every value a float32 tensor on the batch's device.

    ``batch`` holds tensors on the parameters' device. ``vision`` is cast
    to the model's dtype first: the reference's trainer feeds it float32
    (``data/tokens.py``), which promotes its residual stream and breaks
    its bfloat16 scan (ROADMAP Queue 3). With ``mesh`` (the parameters
    and batch DTensors on it) an MoE layer of a config with ``moe_groups``
    runs expert-parallel (``moe.moe_ffn_ep``), as the reference's does."""
    x = _embed_tokens(params, batch, cfg)
    vision = batch.get("vision")
    if vision is not None:
        vision = vision.to(_dtype(cfg))
    _, pattern = group_layout(cfg)

    def prefix_body(h, p):
        return _apply_position_train(p, "self", h, cfg, vision)[0]

    def group_body(h, aux_sum, group):
        for i, kind in enumerate(pattern):
            h, aux = _apply_position_train(group[f"{kind}_{i}"], kind, h,
                                           cfg, vision, mesh)
            aux_sum = aux_sum + aux
        return h, aux_sum

    if "dense_prefix" in params:
        prefix_fn = _remat(prefix_body, cfg)
        for p in params.dense_prefix:
            x = prefix_fn(x, p)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    group_fn = _remat(group_body, cfg)
    for group in params.groups:
        x, aux_total = group_fn(x, aux_total, group)

    x = rmsnorm(x, params.final_norm, cfg.rmsnorm_eps)
    loss = _logits_chunked(params, x, cfg, batch["labels"])
    metrics = {"lm_loss": loss, "aux_loss": aux_total}
    if cfg.family == "moe":
        loss = loss + 0.001 * aux_total
    if cfg.family == "moe" and cfg.mtp_depth and "labels_mtp" in batch:
        # MTP: predict t+2 from [h_t ; emb(t_{t+1})]
        mtp = params.mtp
        emb_next = lookup(params.embed, batch["tokens_next"].long())
        h_in = torch.cat([x, emb_next.to(x.dtype)], dim=-1) @ mtp.proj
        h_mtp, _ = _apply_position_train(mtp.block, "self", h_in, cfg,
                                         vision)
        h_mtp = rmsnorm(h_mtp, mtp.ln, cfg.rmsnorm_eps)
        mtp_loss = _logits_chunked(params, h_mtp, cfg, batch["labels_mtp"])
        metrics["mtp_loss"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, B: int, S_max: int, device=None) -> dict:
    """Per-group stacked decode state in the reference's layout; under
    ``serve_quant="int8"`` the dense, audio and MoE caches are the int8
    dicts."""
    return _init_cache(cfg, B, S_max, resolve_device(device),
                       cfg.serve_quant == "int8")


def _init_cache(cfg: ModelConfig, B: int, S_max: int, dev,
                quant: bool) -> dict:
    dt = _dtype(cfg)
    n_groups, pattern = group_layout(cfg)
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv(G):
        S = S_max
        if quant:
            return {"kq": zeros(G, B, S, Hkv, dh, dtype=torch.int8),
                    "ks": zeros(G, B, S, Hkv, dtype=torch.float32),
                    "vq": zeros(G, B, S, Hkv, dh, dtype=torch.int8),
                    "vs": zeros(G, B, S, Hkv, dtype=torch.float32)}
        return zeros(G, B, S, Hkv, dh), zeros(G, B, S, Hkv, dh)

    def ckv(G):
        if quant:
            return {"q": zeros(G, B, S_max, cfg.mla_cache_dim,
                               dtype=torch.int8),
                    "s": zeros(G, B, S_max, dtype=torch.float32)}
        return zeros(G, B, S_max, cfg.mla_cache_dim)

    cache: dict = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.family in ("dense", "audio"):
        cache["kv"] = kv(n_groups)
    elif cfg.family == "moe":
        cache["ckv"] = ckv(n_groups)
        if cfg.first_k_dense:
            cache["ckv_prefix"] = ckv(cfg.first_k_dense)
    elif cfg.family == "vlm":
        n_self = len(pattern) - 1
        cache["kv"] = (zeros(n_groups, n_self, B, S_max, Hkv, dh),
                       zeros(n_groups, n_self, B, S_max, Hkv, dh))
        Nv = cfg.n_vision_tokens
        cache["cross_kv"] = (zeros(n_groups, B, Nv, Hkv, dh),
                             zeros(n_groups, B, Nv, Hkv, dh))
    elif cfg.family == "hybrid":
        W = min(cfg.sliding_window or S_max, S_max)
        n_rec = pattern.count("rglru")
        w = cfg.lru_width
        cache["rec"] = {
            "h": zeros(n_groups, n_rec, B, w, dtype=torch.float32),
            "conv": zeros(n_groups, n_rec, B, cfg.conv_width - 1, w)}
        cache["kv"] = (zeros(n_groups, B, W, Hkv, dh),
                       zeros(n_groups, B, W, Hkv, dh))
    elif cfg.family == "ssm":
        din = int(cfg.d_model * cfg.mlstm_proj_factor)
        H = cfg.n_heads
        n_m = len(pattern) - 1
        f32 = torch.float32
        cache["mlstm"] = {
            "C": zeros(n_groups, n_m, B, H, din // H, din // H, dtype=f32),
            "n": zeros(n_groups, n_m, B, H, din // H, dtype=f32),
            "m": torch.full((n_groups, n_m, B, H), -1e30, dtype=f32,
                            device=dev),
            "conv": zeros(n_groups, n_m, B, cfg.conv_width - 1, din)}
        d = cfg.d_model
        cache["slstm"] = {
            "c": zeros(n_groups, B, d, dtype=f32),
            "n": zeros(n_groups, B, d, dtype=f32),
            "h": zeros(n_groups, B, d, dtype=f32),
            "m": torch.full((n_groups, B, H), -1e30, dtype=f32, device=dev)}
    return cache


def _index(tree, *idx):
    """The views ``t[idx]`` of every tensor of a tuple or dict of them (a
    layer's slice of a stacked cache)."""
    if isinstance(tree, dict):
        return {k: t[idx] for k, t in tree.items()}
    if isinstance(tree, tuple):
        return tuple(t[idx] for t in tree)
    return tree[idx]


def _layer_cache(cache: dict, cfg: ModelConfig, g: int, i: int, kind: str):
    """The views of ``cache`` that layer (group g, position i) reads and
    writes."""
    if cfg.family in ("dense", "audio"):
        return _index(cache["kv"], g)
    if cfg.family == "moe":
        return _index(cache["ckv"], g)
    if cfg.family == "hybrid":
        if kind == "rglru":
            _, pattern = group_layout(cfg)
            return _index(cache["rec"], g, pattern[:i].count("rglru"))
        return _index(cache["kv"], g)
    if cfg.family == "ssm":
        if kind == "mlstm":
            return _index(cache["mlstm"], g, i)
        return _index(cache["slstm"], g)
    if kind == "cross":
        return _index(cache["cross_kv"], g)
    return _index(cache["kv"], g, i)


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def _apply_position_decode(p: Params, kind: str, x, pcache, pos,
                           cfg: ModelConfig):
    """x: [B,1,d]; the layer's cache is updated in place. Returns x'."""
    h = rmsnorm(x, p.ln1, cfg.rmsnorm_eps)
    if kind in ("self", "local_attn"):
        if cfg.attn_kind == "mla":
            o, _ = mla_mod.mla_decode(p.attn, h, pcache, pos, cfg)
        else:
            o, _ = attn.attn_decode(p.attn, h, pcache, pos, cfg,
                                    ring=kind == "local_attn")
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
    elif kind == "rglru":
        x = x + rec.rglru_decode(p.rec, h, pcache, cfg)[0]
    elif kind == "mlstm":
        return x + rec.mlstm_decode(p.cell, h, pcache, cfg)[0]
    elif kind == "slstm":
        return x + rec.slstm_decode(p.cell, h, pcache, cfg)[0]
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
    pos = cache["pos"]
    toks = tokens[:, None] if tokens.ndim == 1 else tokens[:, None, :]
    x = _embed_tokens(params, {"tokens": toks}, cfg)
    _, pattern = group_layout(cfg)

    for j, p in enumerate(params.dense_prefix
                          if "dense_prefix" in params else ()):
        x = _apply_position_decode(p, "self", x,
                                   _index(cache["ckv_prefix"], j), pos, cfg)
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
    if kind in ("self", "local_attn"):
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
    elif kind == "rglru":
        y, new = rec.rglru_prefill(p.rec, h, cfg)
        x = x + y
    elif kind == "mlstm":
        y, new = rec.mlstm_prefill(p.cell, h, cfg)
        return x + y, new
    elif kind == "slstm":
        y, new = rec.slstm_prefill(p.cell, h, cfg)
        return x + y, new
    else:
        raise ValueError(kind)
    h2 = rmsnorm(x, p.ln2, cfg.rmsnorm_eps)
    return x + gated_mlp(h2, p.mlp.w_gate, p.mlp.w_up, p.mlp.w_down,
                         cfg.activation), new


def _to_ring(dst: torch.Tensor, kv: torch.Tensor) -> None:
    """The last min(S, W) rows of ``kv`` [B, S, Hkv, dh] into the ring
    ``dst`` [B, W, Hkv, dh], the row of absolute position p at slot p % W
    (where ``attn_decode(ring=True)`` writes it); the other slots stay
    zero."""
    S, W = kv.shape[1], dst.shape[1]
    n = min(S, W)
    slots = torch.arange(S - n, S, device=kv.device) % W
    dst[:, slots] = kv[:, S - n:].to(dst.dtype)


def _store(dst, new, S: int, kind: str) -> None:
    """A layer's prefill state into its cache slice: the first S rows of a
    self-attention or latent cache, the ring of a local attention, the
    whole cross KV and recurrent state."""
    if isinstance(dst, tuple):
        for d, n in zip(dst, new):
            _store(d, n, S, kind)
    elif isinstance(dst, dict):
        for k, d in dst.items():
            d.copy_(new[k])
    elif kind == "cross":
        dst.copy_(new)
    elif kind == "local_attn":
        _to_ring(dst, new)
    elif dst.shape[1] != S and type(dst) is not torch.Tensor:
        # a DTensor cache (its S may be sharded): one in-place write of
        # the rows, not a copy into a slice that DTensor may redistribute
        dst.index_copy_(1, torch.arange(S, device=dst.device),
                        new.to(dst.dtype))
    else:
        dst[:, :S] = new


@torch.no_grad()
def prefill(params: Params, batch: dict, cfg: ModelConfig,
            s_max: int | None = None, mesh=None):
    """Process a full prompt; returns (cache, last-position logits).

    ``s_max``: decode-cache capacity (>= prompt length); defaults to the
    prompt length + 64 so generation can continue after prefill. The hybrid
    family ignores it, as the reference does: its local attention's ring
    holds W = ``sliding_window or S`` slots. Under ``serve_quant="int8"``
    the cache is the float one (the reference's prefill returns it so).
    The VLM's cross KV (``cross_attn_kv`` of the vision embeddings) is
    stored in ``cache["cross_kv"]`` for decode (the reference leaves it
    zero: ROADMAP Queue 3). With ``mesh`` (parameters and batch DTensors
    on it) the cache is built on the mesh, placed by
    ``runtime.sharding.cache_sharding``."""
    tokens = batch["tokens"]
    B, S = tokens.shape[:2]
    x = _embed_tokens(params, batch, cfg)
    vision = batch.get("vision")
    _, pattern = group_layout(cfg)
    if cfg.family == "hybrid":
        cache_S = cfg.sliding_window or S
    else:
        cache_S = s_max if s_max is not None else S + 64
        if cache_S < S:
            raise ValueError(f"s_max {cache_S} is below the prompt length "
                             f"{S}")
    cache = _init_cache(cfg, B, cache_S, x.device, quant=False)
    if mesh is not None:
        from ..runtime import sharding as shd
        cache = shd.distribute(cache, shd.cache_sharding(cache, mesh))

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
