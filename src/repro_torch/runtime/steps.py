"""Step builders: train / prefill / decode (port of ``repro.runtime.steps``
without the mesh).

The train step is functional, as the reference's jitted one is: it takes
the parameters as a flat dict of named tensors (the keys of the model's
``Params.state_dict()``, e.g. ``groups.0.self_0.attn.wq``), the AdamW state
and a batch, and returns new parameters, a new state and the metrics, all
tensors on the parameters' device. The forward and its backward
(``torch.autograd.grad``) run in one ``torch.func.functional_call`` on a
skeleton of the model built on the ``meta`` device, so no weights are held
twice, and the update is ``optim/adamw.py``'s. Nothing is written in
place, and nothing is read on the host.

``abstract_params`` and ``lower_cell`` (the dry-run's lowering) are not
ported yet (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..data.tokens import to_device
from ..device import resolve_device
from ..models import transformer as tf
from ..models.config import ModelConfig
from ..optim import adamw

# the reference stacks these subtrees' layers along a leading axis
STACKED = ("groups", "dense_prefix")


def decayed(params: dict[str, torch.Tensor]) -> frozenset[str]:
    """The names the reference's AdamW decays: a leaf whose stacked form
    (a layer axis in front under ``groups``/``dense_prefix``) has
    ``ndim >= 2``, so every per-layer tensor there, norm scales included."""
    return frozenset(k for k, p in params.items()
                     if p.dim() + (k.split(".")[0] in STACKED) >= 2)


class _LossAndGrads(nn.Module):
    """``forward_train`` and its gradients as one module call, for
    ``functional_call``: the backward runs inside the call, because a
    checkpointed region recomputes its forward there and must read the
    tensors the call binds, not the skeleton's."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.params = tf.init_params(cfg, device="meta")

    def forward(self, batch: dict):
        loss, metrics = tf.forward_train(self.params, batch, self.cfg)
        named = list(self.params.named_parameters())
        grads = torch.autograd.grad(loss, [t for _, t in named],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(t) if g is None else g
                 for (k, t), g in zip(named, grads)}
        return (loss.detach(), {k: m.detach() for k, m in metrics.items()},
                grads)


def loss_and_grads(cfg: ModelConfig, params: dict[str, torch.Tensor],
                   batch: dict, fn: nn.Module | None = None):
    """(loss, metrics, grads) of ``forward_train`` at ``params`` (a flat
    dict of tensors keyed as ``Params.state_dict()``); every gradient is a
    tensor (zeros where the loss does not depend on the parameter),
    metrics are detached."""
    fn = fn if fn is not None else _LossAndGrads(cfg)
    leaves = {f"params.{k}": v.detach().requires_grad_(True)
              for k, v in params.items()}
    with torch.enable_grad():
        return torch.func.functional_call(fn, leaves, (batch,))


def _batch_on(batch: dict, device: torch.device) -> dict:
    if any(isinstance(v, np.ndarray) for v in batch.values()):
        return to_device(batch, device)
    return {k: v.to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptimConfig,
                    device=None):
    """``train_step(params, opt_state, batch) -> (params', opt_state',
    metrics)`` on ``device`` (the card unless the caller names another;
    without a card this raises unless ``device="cpu"``). ``batch`` may be
    numpy arrays (``TokenStream.batch_at``) or tensors; it is moved to the
    device. Weight decay applies to what the reference decays
    (:func:`decayed`)."""
    device = resolve_device(device)
    fn = _LossAndGrads(cfg)

    def train_step(params, opt_state, batch):
        batch = _batch_on(batch, device)
        _, metrics, grads = loss_and_grads(cfg, params, batch, fn)
        params, opt_state, om = adamw.apply_updates(
            {k: v.detach() for k, v in params.items()}, grads, opt_state,
            opt_cfg, decay=decayed(params))
        return params, opt_state, {**metrics, **om}

    return train_step


def init_train_state(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """``{"params": flat dict, "opt": AdamW state}`` with weights drawn on
    ``device`` (the card unless named) from a generator seeded ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = dict(tf.init_params(cfg, generator=gen, device=device)
                  .state_dict())
    return {"params": params, "opt": adamw.init_opt_state(params)}


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, tokens):
        return tf.decode_step(params, cache, tokens, cfg)

    return decode_step


def make_prefill(cfg: ModelConfig, s_max: int | None = None):
    def prefill_step(params, batch):
        return tf.prefill(params, batch, cfg, s_max=s_max)

    return prefill_step
