"""AdamW + global-norm clipping + cosine schedule over a dict of named
tensors (port of ``repro.optim.adamw``).

Functional, as ``repro``'s: :func:`apply_updates` returns new parameters and
a new state and leaves its inputs alone. Only matrices (``ndim >= 2``) are
decayed, unless the caller names the decayed tensors (``decay``: the LM's
train step names those the reference decays, whose stacked leaves have a
layer axis more than the port's per-layer tensors). Moments and arithmetic are float32; the step counter is an int32
tensor on the parameters' device, so a training step reads nothing on the
host.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Container

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(step: torch.Tensor, cfg: OptimConfig) -> torch.Tensor:
    """Linear warm-up to ``lr``, then cosine decay to ``min_lr_frac * lr``
    (float32 [], from an integer step tensor)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = cfg.lr * (step + 1).to(torch.float32) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps).to(torch.float32)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 *
                    (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: dict[str, torch.Tensor]) -> dict:
    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    device = next(iter(params.values())).device
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tensors.values()))


def apply_updates(params: dict[str, torch.Tensor],
                  grads: dict[str, torch.Tensor], state: dict,
                  cfg: OptimConfig, decay: Container[str] | None = None):
    """One AdamW step; returns (params', state', metrics). ``grads`` has
    the keys of ``params``; ``decay``: the keys weight decay applies to
    (default: every tensor with ``ndim >= 2``)."""
    step = state["step"]
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    grads = {k: g.to(torch.float32) * scale for k, g in grads.items()}

    b1, b2 = cfg.b1, cfg.b2
    mu = {k: b1 * state["mu"][k] + (1 - b1) * g for k, g in grads.items()}
    nu = {k: b2 * state["nu"][k] + (1 - b2) * g * g
          for k, g in grads.items()}
    t = (step + 1).to(torch.float32)
    bc1 = 1 - torch.pow(torch.full((), b1, device=t.device), t)
    bc2 = 1 - torch.pow(torch.full((), b2, device=t.device), t)
    lr = schedule(step, cfg)

    def upd(k, p, m, v):
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2 if decay is None else k in decay:
            u = u + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * u).to(p.dtype)

    new_params = {k: upd(k, p.detach(), mu[k], nu[k])
                  for k, p in params.items()}
    new_state = {"mu": mu, "nu": nu, "step": step + 1}
    return new_params, new_state, {"grad_norm": gn, "lr": lr}
