"""Recurrent blocks: RG-LRU (RecurrentGemma/Griffin) and xLSTM cells (port of
``repro.models.recurrent``).

RG-LRU is a diagonal linear recurrence with input-dependent gates
    a_t = exp(-c * softplus(Lambda) * r_t),
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t).
Prefill evaluates it with a log-depth scan that follows
``jax.lax.associative_scan``'s odd/even recursion (:func:`_associative_scan`),
so every element is combined in the reference's order; decode is a single
step.

mLSTM (matrix-memory LSTM) is evaluated chunkwise: within a chunk an
attention-like product with cumulative-gate weights, across chunks a loop
that carries the stabilized state (C~ = C * exp(-m), n~ = n * exp(-m), m).
The running max m starts at -1e30 in float32, so exp(m - g) is exactly 0
until the first input arrives.

sLSTM has a nonlinear h_{t-1} dependency (a block-diagonal recurrent
matrix), so its prefill is a loop over the sequence, as the reference's
``lax.scan`` is: a few launches a token and layer.

Every decode function updates its state dict in place (``copy_`` into each
leaf, which may be a view of the stacked decode cache) and reads nothing on
the host, so a CUDA graph can capture it. The ``*_train`` forwards share
the prefill bodies and write nothing in place, so autograd runs through
them (``transformer.forward_train``).

Numerics kept from JAX: ``jnp.var`` is the population variance
(``correction=0``); ``jax.nn.gelu(approximate=True)`` is the tanh form;
``jax.nn.softplus`` is ``logaddexp(x, 0)`` = max(x, 0) + log1p(exp(-|x|))
(:func:`softplus`; ``F.softplus`` switches to x above its threshold of 20
instead); ``jax.nn.log_sigmoid`` is ``F.logsigmoid``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..perf import op_analyze
from ..runtime.spmd import gather_model, gathered_grad, per_head
from .config import ModelConfig
from .layers import Params, dense_init

_LRU_C = 8.0
F32 = torch.float32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _group_norm(h: torch.Tensor, H: int, scale: torch.Tensor,
                dtype) -> torch.Tensor:
    """Per-head normalisation of [..., H*dh] (population variance, eps
    1e-6), times ``scale``, cast to ``dtype``."""
    lead, width = h.shape[:-1], h.shape[-1]
    hg = gather_model(h, H).reshape(*lead, H, width // H)
    mu = torch.mean(hg, dim=-1, keepdim=True)
    var = torch.var(hg, dim=-1, keepdim=True, correction=0)
    hn = ((hg - mu) * torch.rsqrt(var + 1e-6)).reshape(*lead, width)
    return (gathered_grad(hn, H) * scale).to(dtype)


def _conv_step(hist: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """``einsum("bcw,cw->bw")`` of the conv history and the taps."""
    return torch.einsum("bcw,cw->bw", hist, conv_w)


def _shift_in(conv: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """The history with ``new`` [B, w] appended ([B, cw, w]); ``conv`` keeps
    the last cw - 1 rows of it, in place."""
    hist = torch.cat([conv, new[:, None].to(conv.dtype)], dim=1)
    conv.copy_(hist[:, 1:])
    return hist


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def init_rglru_params(cfg: ModelConfig, dtype,
                      generator: torch.Generator | None = None,
                      device=None) -> Params:
    d, w = cfg.d_model, cfg.lru_width

    def dense(shape, dt=dtype, fan_in=None):
        return dense_init(shape, dt, fan_in=fan_in, generator=generator,
                          device=device)

    dev = torch.device("cpu" if device is None else device)
    lam = torch.empty((w,), dtype=F32, device=dev)
    if dev.type != "meta":
        lam.uniform_(2.0, 5.0, generator=generator)
    return Params(
        w_gate_in=dense((d, w)),                  # gelu branch
        w_in=dense((d, w)),                       # recurrent branch
        conv_w=dense((cfg.conv_width, w), fan_in=cfg.conv_width),
        wa=dense((w, w)),                         # recurrence gate
        wx=dense((w, w)),                         # input gate
        lam=lam,
        w_out=dense((w, d)))


def _causal_conv_train(v: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds (the reference's order).
    v: [B, S, w]. Each shift is the sequence's head cut off and zeros put
    in front (not ``F.pad``, whose sharding DTensor may not propagate)."""
    S = v.shape[1]
    out = torch.zeros_like(v)
    W = conv_w.shape[0]
    for j in range(W):
        shifted = torch.cat([torch.zeros_like(v[:, :j]), v[:, :S - j]],
                            dim=1) if j else v
        out = out + shifted * conv_w[W - 1 - j]
    return out


def _rglru_gates(p: Params, v: torch.Tensor, cfg: ModelConfig):
    r = torch.sigmoid((v @ p.wa).float())
    i = torch.sigmoid((v @ p.wx).float())
    log_a = -_LRU_C * softplus(p.lam) * r                    # [B, ., w]
    a = torch.exp(log_a)
    # sqrt(1 - a^2) with a = exp(log_a); clamp for fp safety
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * v.float()


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 1 (len(even) - len(odd) is
    0 or 1)."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n, *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _combine(a1, b1, a2, b2):
    """The linear recurrence's operator: (a1, b1) then (a2, b2)."""
    return a1 * a2, a2 * b1 + b2


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``_combine`` along axis 1 by
    ``jax.lax.associative_scan``'s recursion (pairs combined, the odd
    elements scanned, the even ones combined from them), so each element
    is computed by the reference's operations in its order: log2(S)
    levels of a few launches each."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _rglru_block(p: Params, x: torch.Tensor, cfg: ModelConfig):
    u = F.gelu(x @ p.w_gate_in, approximate="tanh")
    v_pre = x @ p.w_in
    v = _causal_conv_train(v_pre, p.conv_w)
    a, b = _rglru_gates(p, v, cfg)
    _, h = _associative_scan(a, b)
    y = (u * h.to(x.dtype)) @ p.w_out
    return y, h, v_pre


def rglru_train(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full Griffin recurrent block over [B, S, d] (parallel scan)."""
    return _rglru_block(p, x, cfg)[0]


def rglru_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Like rglru_train but also returns the decode state at the last step."""
    y, h, v_pre = _rglru_block(p, x, cfg)
    cw = cfg.conv_width - 1
    return y, {"h": h[:, -1], "conv": v_pre[:, -cw:]}


def rglru_init_state(cfg: ModelConfig, B: int, dtype, device=None) -> dict:
    w = cfg.lru_width
    return {"h": torch.zeros((B, w), dtype=F32, device=device),
            "conv": torch.zeros((B, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


def rglru_decode(p: Params, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """One-step Griffin block. x: [B, 1, d]; ``state`` updated in place."""
    u = F.gelu(x @ p.w_gate_in, approximate="tanh")[:, 0]
    v_new = (x @ p.w_in)[:, 0]                               # [B, w]
    v = _conv_step(_shift_in(state["conv"], v_new), p.conv_w)
    a, b = _rglru_gates(p, v, cfg)
    h = a * state["h"] + b
    state["h"].copy_(h)
    y = (u * h.to(x.dtype)) @ p.w_out
    return y[:, None], state


# ---------------------------------------------------------------------------
# mLSTM (chunkwise parallel)
# ---------------------------------------------------------------------------

def _mlstm_din(cfg: ModelConfig) -> int:
    return int(cfg.d_model * cfg.mlstm_proj_factor)


def init_mlstm_params(cfg: ModelConfig, dtype,
                      generator: torch.Generator | None = None,
                      device=None) -> Params:
    d = cfg.d_model
    din = _mlstm_din(cfg)
    H = cfg.n_heads
    dh = din // H

    def dense(shape, dt=dtype, fan_in=None):
        return dense_init(shape, dt, fan_in=fan_in, generator=generator,
                          device=device)

    return Params(
        w_up=dense((d, din)),
        w_z=dense((d, din)),                      # gate branch
        conv_w=dense((cfg.conv_width, din), fan_in=cfg.conv_width),
        # per-head (block-diagonal) qkv, as in the xLSTM paper
        wq=dense((H, dh, dh), fan_in=dh),
        wk=dense((H, dh, dh), fan_in=dh),
        wv=dense((H, dh, dh), fan_in=dh),
        w_if=dense((din, 2 * H), F32),            # i/f gate logits
        gn_scale=torch.ones((din,), dtype=dtype, device=device),
        w_down=dense((din, d), fan_in=din))


def _mlstm_chunk_scan(q, k, v, ig, fg, chunk: int):
    """Exact chunkwise mLSTM. q,k,v: [B,S,H,dh]; ig,fg: [B,S,H] log-gates.

    Returns h [B,S,H,dh] and final (C~, n~, m)."""
    B, S, H, dh = q.shape
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"mLSTM chunk {L}")
    scale = dh ** -0.5
    q = q.float() * scale
    k = k.float()
    v = v.float()
    dev = q.device
    Cp = torch.zeros((B, H, dh, dh), dtype=F32, device=dev)
    np_ = torch.zeros((B, H, dh), dtype=F32, device=dev)
    mp = torch.full((B, H), -1e30, dtype=F32, device=dev)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))

    def chunk_step(state, c0):
        Cp, np_, mp = state
        qq, kk, vv = q[:, c0:c0 + L], k[:, c0:c0 + L], v[:, c0:c0 + L]
        ii, ff = ig[:, c0:c0 + L], fg[:, c0:c0 + L]          # [B,L,H]
        b = torch.cumsum(ff, dim=1)                          # cumulative log-f
        u = ii - b                                           # i_s - b_s
        g = torch.maximum(mp[:, None, :], torch.cummax(u, dim=1).values)
        m_t = b + g
        # intra-chunk attention-like term
        a_log = u[:, None, :, :] - g[:, :, None, :]          # [B,t,s,H]
        w_ts = torch.where(mask[None, :, :, None], torch.exp(a_log), 0.0)
        qk = torch.einsum("bthd,bshd->btsh", qq, kk)
        A = qk * w_ts                                        # [B,t,s,H]
        intra = torch.einsum("btsh,bshd->bthd", A, vv)
        # inter-chunk (initial state) term
        inter_scale = torch.exp(mp[:, None, :] - g)          # [B,L,H]
        qC = torch.einsum("bthd,bhde->bthe", qq, Cp)
        num = intra + qC * inter_scale[..., None]
        den = torch.sum(A, dim=2) + \
            torch.einsum("bthd,bhd->bth", qq, np_) * inter_scale
        h = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]
        # state to end of chunk
        gL = g[:, -1, :]                                     # [B,H]
        wL = torch.exp(u - gL[:, None, :])                   # [B,L,H]
        kw = kk * wL[..., None]
        decay = torch.exp(mp - gL)
        Cp = decay[..., None, None] * Cp + \
            torch.einsum("bshd,bshe->bhde", kw, vv)
        np_ = decay[..., None] * np_ + torch.sum(kw, dim=1)
        mp = b[:, -1, :] + gL
        return (Cp, np_, mp), h

    (Cp, np_, mp), hs = op_analyze.scan(chunk_step, (Cp, np_, mp),
                                        range(0, S, L))
    return torch.cat(hs, dim=1), (Cp, np_, mp)


def _flat_scan(q, k, v, ig, fg, chunk: int):
    h, (Cf, nf, mf) = _mlstm_chunk_scan(q, k, v, ig, fg, chunk)
    return h, Cf, nf, mf


def _mlstm_block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Shared mLSTM block body; returns (y, final_state)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    xm = x @ p.w_up
    z = x @ p.w_z
    xc = F.silu(_causal_conv_train(xm, p.conv_w))
    din = xm.shape[-1]
    dh = din // H
    xch = gather_model(xc, H).reshape(B, S, H, dh)
    xmh = gather_model(xm, H).reshape(B, S, H, dh)
    q = torch.einsum("bshd,hde->bshe", xch, p.wq)
    k = torch.einsum("bshd,hde->bshe", xch, p.wk)
    v = torch.einsum("bshd,hde->bshe", xmh, p.wv)
    gates = (xm.float() @ p.w_if).reshape(B, S, H, 2)
    ig = gates[..., 0]
    fg = F.logsigmoid(gates[..., 1])
    # over a mesh each rank scans its own rows and heads
    h, Cf, nf, mf = per_head(
        lambda *a: _flat_scan(*a, cfg.mlstm_chunk), (q, 2), (k, 2), (v, 2),
        (ig, 2), (fg, 2), out_heads=(2, 1, 1, 1))
    hn = _group_norm(h.reshape(B, S, din), H, p.gn_scale, x.dtype)
    y = (hn * F.silu(z)) @ p.w_down
    cw = cfg.conv_width - 1
    return y, {"C": Cf, "n": nf, "m": mf, "conv": xm[:, -cw:]}


def mlstm_train(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full mLSTM block over [B, S, d]."""
    return _mlstm_block_apply(p, x, cfg)[0]


def mlstm_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig):
    return _mlstm_block_apply(p, x, cfg)


def mlstm_init_state(cfg: ModelConfig, B: int, dtype, device=None) -> dict:
    din = _mlstm_din(cfg)
    H = cfg.n_heads
    dh = din // H
    return {
        "C": torch.zeros((B, H, dh, dh), dtype=F32, device=device),
        "n": torch.zeros((B, H, dh), dtype=F32, device=device),
        "m": torch.full((B, H), -1e30, dtype=F32, device=device),
        "conv": torch.zeros((B, cfg.conv_width - 1, din), dtype=dtype,
                            device=device),
    }


def mlstm_decode(p: Params, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """One-step mLSTM block. x: [B, 1, d]; ``state`` updated in place (C
    by ``mul_`` and ``add_``: the reference's f_s * C + i_s * (k v^T))."""
    B = x.shape[0]
    H = cfg.n_heads
    xm = (x @ p.w_up)[:, 0]
    z = (x @ p.w_z)[:, 0]
    xc = F.silu(_conv_step(_shift_in(state["conv"], xm), p.conv_w))
    din = xm.shape[-1]
    dh = din // H
    xch = gather_model(xc, H).reshape(B, H, dh)
    xmh = gather_model(xm, H).reshape(B, H, dh)
    q = torch.einsum("bhd,hde->bhe", xch, p.wq).float() * dh ** -0.5
    k = torch.einsum("bhd,hde->bhe", xch, p.wk).float()
    v = torch.einsum("bhd,hde->bhe", xmh, p.wv).float()
    gates = (xm.float() @ p.w_if).reshape(B, H, 2)
    ig = gates[..., 0]
    fg = F.logsigmoid(gates[..., 1])
    m = state["m"]
    m_new = torch.maximum(fg + m, ig)
    i_s = torch.exp(ig - m_new)
    f_s = torch.exp(fg + m - m_new)
    kv = k[..., :, None] * v[..., None, :]                   # [B,H,dh,dh]
    kv.mul_(i_s[..., None, None])
    C = state["C"].mul_(f_s[..., None, None]).add_(kv)
    del kv
    n = state["n"].mul_(f_s[..., None]).add_(i_s[..., None] * k)
    m.copy_(m_new)
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, din)
    h = _group_norm(h, H, p.gn_scale, x.dtype)
    y = (h * F.silu(z)) @ p.w_down
    return y[:, None], state


# ---------------------------------------------------------------------------
# sLSTM (sequential by construction)
# ---------------------------------------------------------------------------

def _round_mult(x: float, m: int = 128) -> int:
    return max(m, int(-(-x // m) * m))


def init_slstm_params(cfg: ModelConfig, dtype,
                      generator: torch.Generator | None = None,
                      device=None) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    dup = _round_mult(d * cfg.slstm_proj_factor, 128 if d >= 128 else 16)

    def dense(shape, dt=dtype, fan_in=None):
        return dense_init(shape, dt, fan_in=fan_in, generator=generator,
                          device=device)

    return Params(
        w_ifzo=dense((d, 4 * d)),
        r_ifzo=dense((H, dh, 4 * dh), F32, fan_in=dh),    # block-diag recurrent
        b_ifzo=torch.zeros((4 * d,), dtype=F32, device=device),
        gn_scale=torch.ones((d,), dtype=dtype, device=device),
        w_up_gate=dense((d, dup)),
        w_up=dense((d, dup)),
        w_down=dense((dup, d), fan_in=dup))


def slstm_init_state(cfg: ModelConfig, B: int, device=None) -> dict:
    d = cfg.d_model
    H = cfg.n_heads

    def zeros(*shape):
        return torch.zeros(shape, dtype=F32, device=device)

    return {"c": zeros(B, d), "n": zeros(B, d), "h": zeros(B, d),
            "m": torch.full((B, H), -1e30, dtype=F32, device=device)}


def _slstm_cell(p: Params, x_t: torch.Tensor, st: dict,
                cfg: ModelConfig) -> dict:
    """x_t: [B, 4d] pre-activation input projections applied outside.
    Returns the new state (new tensors; ``st`` is not written)."""
    B, d = st["h"].shape[0], cfg.d_model
    H = cfg.n_heads
    dh = d // H
    hr = gather_model(st["h"], H).reshape(B, H, dh)
    rec = torch.einsum("bhd,hde->bhe", hr, p.r_ifzo).reshape(B, 4 * d)
    pre = x_t.float() + rec + p.b_ifzo
    it, ft, zt, ot = torch.split(pre, d, dim=-1)
    ith = it.reshape(B, H, dh)
    fth = ft.reshape(B, H, dh)
    # exponential gating with per-head stabilizer (max over head dims)
    lf = F.logsigmoid(fth)
    m_new = torch.maximum(torch.amax(lf, dim=-1) + st["m"],
                          torch.amax(ith, dim=-1))
    i_s = torch.exp(ith - m_new[..., None]).reshape(B, d)
    f_s = torch.exp(lf + st["m"][..., None] - m_new[..., None]).reshape(B, d)
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    c = f_s * st["c"] + i_s * z
    n = f_s * st["n"] + i_s
    h = o * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_out(p: Params, h: torch.Tensor, cfg: ModelConfig, dtype):
    h = _group_norm(h, cfg.n_heads, p.gn_scale, dtype)
    return (F.silu(h @ p.w_up_gate) * (h @ p.w_up)) @ p.w_down


def slstm_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """sLSTM block over [B,S,d] returning (y, final cell state): one cell
    step a token, as the reference's scan."""
    B, S, _ = x.shape
    xg = gather_model(x @ p.w_ifzo, cfg.n_heads)             # [B,S,4d]
    def step(st, t):
        st = _slstm_cell(p, xg[:, t], st, cfg)
        return st, st["h"]

    st, hs = op_analyze.scan(step, slstm_init_state(cfg, B, x.device),
                             range(S))
    return _slstm_out(p, torch.stack(hs, dim=1), cfg, x.dtype), st


def slstm_train(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full sLSTM block over [B, S, d] (sequential loop over S)."""
    return slstm_prefill(p, x, cfg)[0]


def slstm_decode(p: Params, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """One-step sLSTM block. x: [B, 1, d]; ``state`` updated in place."""
    xg = gather_model((x @ p.w_ifzo)[:, 0], cfg.n_heads)
    new = _slstm_cell(p, xg, state, cfg)
    for k, t in new.items():
        state[k].copy_(t)
    y = _slstm_out(p, new["h"], cfg, x.dtype)
    return y[:, None], state
