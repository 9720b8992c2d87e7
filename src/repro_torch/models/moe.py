"""Token-choice top-k MoE with capacity-based dispatch (DeepSeek V2/V3 style;
port of ``repro.models.moe`` without a mesh).

Routing: a float32 softmax router (float32 even in a bfloat16 model) ->
per-token top-k experts, renormalized gates. ``lax.top_k`` takes the lowest
index among equal probabilities; a stable descending sort does the same
(``torch.topk`` promises no order among ties on the card). Dispatch:
token-major priority over the k choices, a cumulative sum giving each
choice its position within its expert; each expert accepts up to
C = capacity(T) tokens and the rest are dropped: every dropped choice
scatters to one scratch slot E*C, the only slot written more than once,
which is discarded. One gather in, one gather out.

Shared experts (DeepSeek) are a dense gated MLP fused as one wide block.
The expert-parallel ``moe_ffn_ep`` (a mesh) is not ported yet: one card
has no mesh (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Params, dense_init


def init_moe_params(cfg: ModelConfig, dtype,
                    generator: torch.Generator | None = None,
                    device=None) -> Params:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def w(shape, dt=dtype, fan_in=None):
        return dense_init(shape, dt, fan_in=fan_in, generator=generator,
                          device=device)

    p = dict(router=w((d, E), torch.float32),
             w_gate=w((E, d, f), fan_in=d), w_up=w((E, d, f), fan_in=d),
             w_down=w((E, f, d), fan_in=f))
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p.update(shared_gate=w((d, fs)), shared_up=w((d, fs)),
                 shared_down=w((fs, d), fan_in=fs))
    return Params(**p)


def capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


def moe_route(p: Params, xf: torch.Tensor, cfg: ModelConfig) -> dict:
    """Routing and capacity assignment of tokens xf [T, d]: the router's
    ``probs`` [T, E], the renormalized ``gate_vals`` and expert ``ids``
    [T, k], and per choice (t, j) at t*k + j its ``keep`` mask and
    dispatch slot ``dest`` (E*C when dropped), with the capacity ``C``."""
    T = xf.shape[0]
    E, k = cfg.n_experts, cfg.moe_top_k
    C = capacity(T, cfg)
    probs = torch.softmax(xf.float() @ p.router, dim=-1)          # [T, E]
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, ids = top[:, :k], order[:, :k]                      # [T, k]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # capacity assignment, token-major priority over the k choices (a
    # comparison, not F.one_hot, which reads the host on the CPU)
    experts = torch.arange(E, device=xf.device)
    ids_flat = ids.reshape(T * k)
    onehot = (ids_flat[:, None] == experts).to(torch.int32)        # [T*k, E]
    pos = torch.cumsum(onehot, dim=0) - onehot      # position within expert
    pos_flat = torch.sum(pos * onehot, dim=-1)                     # [T*k]
    keep = pos_flat < C
    dest = torch.where(keep, ids_flat * C + pos_flat, E * C)   # drop: scratch
    return dict(probs=probs, gate_vals=gate_vals, ids=ids, keep=keep,
                dest=dest, C=C)


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
            mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss [])."""
    if mesh is not None:
        raise NotImplementedError("expert-parallel MoE over a mesh "
                                  "(moe_ffn_ep) is not ported yet (ROADMAP "
                                  "Queue 1)")
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.moe_top_k
    xf = x.reshape(T, d)
    rt = moe_route(p, xf, cfg)
    C, ids, keep, dest = rt["C"], rt["ids"], rt["keep"], rt["dest"]

    # load-balance aux (Switch-style): E * sum_e f_e * p_e
    me = torch.mean(rt["probs"], dim=0)
    ce = torch.mean((ids[:, :1] == torch.arange(E, device=x.device)).float(),
                    dim=0)
    aux = E * torch.sum(me * ce)

    token_of_choice = torch.arange(T * k, device=x.device) // k
    slot_token = torch.zeros(E * C + 1, dtype=torch.long, device=x.device
                             ).scatter_(0, dest, token_of_choice)[:-1]
    slot_used = torch.zeros(E * C + 1, dtype=x.dtype, device=x.device
                            ).scatter_(0, dest, torch.ones_like(
                                dest, dtype=x.dtype))[:-1]

    x_disp = (xf[slot_token] * slot_used[:, None]).reshape(E, C, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", x_disp, p.w_gate)) * \
        torch.einsum("ecd,edf->ecf", x_disp, p.w_up)
    y_e = torch.einsum("ecf,efd->ecd", h, p.w_down).reshape(E * C, d)

    y_choice = y_e[torch.clamp(dest, max=E * C - 1)]              # [T*k, d]
    y_choice = y_choice * (keep[:, None] * rt["gate_vals"].reshape(
        T * k)[:, None]).to(y_choice.dtype)
    y = torch.sum(y_choice.reshape(T, k, d), dim=1)

    if cfg.n_shared_experts:
        y = y + (F.silu(xf @ p.shared_gate) * (xf @ p.shared_up)) \
            @ p.shared_down
    return y.reshape(B, S, d).to(x.dtype), aux
