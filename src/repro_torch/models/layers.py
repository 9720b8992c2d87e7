"""Common layers: RMSNorm, RoPE, gated MLPs, softcap, init and the loss (port
of ``repro.models.layers``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..runtime.spmd import same_grad, whole_last


class Params(nn.Module):
    """A named set of weights, as the reference's parameter dicts are: each
    tensor a frozen ``nn.Parameter``, each nested set a submodule, under the
    reference's leaf names (``p.wq``, ``p.mlp.w_up``), so the state dict's
    keys are the reference's paths. The serving path computes nothing
    through autograd (training flips ``requires_grad``)."""

    def __init__(self, **leaves):
        super().__init__()
        for name, value in leaves.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def recomputed(fn, context_fn=None):
    """``fn`` as a non-reentrant ``torch.utils.checkpoint`` region: only
    its inputs are kept for the backward, which runs it again
    (``context_fn`` selects ops whose outputs are kept instead); ``fn``
    itself when no gradient is recorded."""
    if not torch.is_grad_enabled():
        return fn
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Normalised in float32 and scaled by ``1 + scale`` (the stored scale
    is an offset from one, zero at init). Over a mesh ``x`` comes whole in
    its last dim and reduced (``spmd.whole_last``), and the gradient of
    the result is brought to its placements (``spmd.same_grad``): the
    residual stream and its gradient stay whole over 'model' around the
    sharded products, Megatron's f and g."""
    dt = x.dtype
    x = whole_last(x).float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return same_grad(((x * torch.rsqrt(var + eps)) *
                      (1.0 + scale.float())).to(dt))


def rope_freqs(head_dim: int, theta: float,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [*pos_shape, head_dim//2], f32, on ``positions``'
    device."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; cos/sin: [..., seq, head_dim//2]."""
    dt = x.dtype
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, activation: str) -> torch.Tensor:
    """SwiGLU / GeGLU feed-forward (GeGLU's GELU is the tanh form)."""
    g = x @ w_gate
    u = x @ w_up
    act = F.silu(g) if activation == "swiglu" else F.gelu(g,
                                                         approximate="tanh")
    return (act * u) @ w_down


def softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(shape, dtype, fan_in: int | None = None,
               generator: torch.Generator | None = None,
               device=None) -> torch.Tensor:
    """A normal draw scaled by 1/sqrt(fan_in) (the first dimension unless
    given), drawn in float32 from ``generator`` on ``device`` and cast to
    ``dtype``; on ``meta`` only the shape and dtype exist."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * std).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token-level CE; logits [..., V] cast to f32 internally."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return -torch.mean(ll)
    mask = mask.float()
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
