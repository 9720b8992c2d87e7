"""Gradient compression for the data-parallel reduction: int8 QSGD with
error feedback (port of ``repro.optim.grad_compress`` over a
``torch.distributed`` process group: a mesh axis's).

Each tensor is quantized to int8 with one float32 scale (4x fewer bytes
than float32, 2x fewer than bfloat16), and the quantization residual is kept
in an error-feedback accumulator, which restores convergence to the
uncompressed trajectory (Karimireddy et al.-style EF).

:func:`compressed_psum` quantizes, all-gathers the int8 codes and the
scales over the group and sums them dequantized locally: with k ranks that
moves k*(n/4) float32-equivalent bytes instead of the ~2n of a ring
all-reduce. ``group`` is the counterpart of the reference's axis name: a
mesh axis's group (``mesh.get_group("data")``, or ``"pod"`` across pods)
or any process group. The gather is injectable (``gather=``), so k shards
can be summed in one process.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

Gather = Callable[[torch.Tensor], torch.Tensor]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scale []): scale = max|x| / 127 + 1e-12, codes
    round(x / scale) (half to even) clipped to +-127. The 127 is a float32
    tensor on x's device: CUDA computes a division by a Python float as a
    product by its reciprocal, which can round the scale an ulp away."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf)) / torch.full(
        (), 127.0, dtype=torch.float32, device=x.device) + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(grad: torch.Tensor, err: torch.Tensor):
    """Error-feedback compress one tensor. Returns (q, scale, new_err)."""
    corrected = grad.float() + err
    q, s = quantize_int8(corrected)
    return q, s, corrected - dequantize_int8(q, s)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """[k, *t.shape]: ``t`` of every rank of ``group``, in rank order."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def compressed_psum(grad: torch.Tensor, err: torch.Tensor, group=None,
                    gather: Gather | None = None):
    """int8 all-gather-sum of ``grad`` over ``group`` (or through
    ``gather``, which maps a tensor to the [k, ...] stack of every shard's);
    returns (the sum in grad's dtype, new_err)."""
    gather = gather or (lambda t: all_gather(t, group))
    q, s, new_err = ef_compress(grad, err)
    qs = gather(q)                              # [k, ...] int8
    ss = gather(s.reshape(1))[:, 0]             # [k]
    summed = torch.tensordot(ss, qs.float(), dims=([0], [0]))
    return summed.to(grad.dtype), new_err


def tree_compressed_psum(grads: dict, err_state: dict, group=None,
                         gather: Gather | None = None):
    """:func:`compressed_psum` of every tensor of a dict; ``err_state``
    has its keys (float32)."""
    out_g, out_e = {}, {}
    for k, g in grads.items():
        out_g[k], out_e[k] = compressed_psum(g, err_state[k], group, gather)
    return out_g, out_e


def init_error_state(grads: dict) -> dict:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def make_dp_compressed_train_step(loss_fn, opt_update, group=None):
    """Data-parallel train step with the compressed gradient reduce.

    Each rank runs ``step(params, err, opt_state, batch)`` on its shard of
    the batch: its gradients of ``loss_fn(params, batch) -> (loss,
    metrics)`` (``params`` a dict of tensors), the int8+EF all-gather-sum
    over ``group``, the mean over the group's ranks, and
    ``opt_update(params, grads, opt_state) -> (params', opt_state',
    metrics)`` applied alike on every rank, so the parameters stay
    replicated."""
    world = dist.get_world_size(group)

    def step(params, err, opt_state, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss, metrics = loss_fn(leaves, batch)
            gs = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), gs)}
        grads, err = tree_compressed_psum(grads, err, group)
        grads = {k: g / world for k, g in grads.items()}
        params, opt_state, om = opt_update(
            {k: v.detach() for k, v in params.items()}, grads, opt_state)
        return params, err, opt_state, {
            **{k: m.detach() for k, m in metrics.items()}, **om,
            "loss": loss.detach()}

    return step
