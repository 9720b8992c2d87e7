"""GPipe-style pipeline parallelism over the 'pod' axis (port of
``repro.runtime.pipeline_parallel``).

The production mesh's `pod` axis defaults to outer data-parallel; this
module offers the alternative: each pod holds a contiguous slice of the
layer stack and microbatches stream through a ring permute between
neighbouring stages. The schedule is the reference's: T = n_micro +
n_stages - 1 ticks; at tick t stage 0 takes microbatch t, every other
stage the activation its predecessor sent at tick t - 1, and the last
stage keeps microbatch t - (n_stages - 1)'s output. The permute is an
autograd function whose backward is the reverse permute, so
``torch.autograd`` through the pipelined forward yields the
reverse-pipeline backward without hand-written stage gradients, as the
reference's ``ppermute`` transpose does.

Each rank knows its stage on the host (``mesh.get_local_rank("pod")``),
so where the reference masks a tick's output with ``where`` the port
skips the stage (sending zeros) and stores only a valid output. The
outputs end as a sum over the stage axis (only the last stage's are
nonzero), replicated on every pod; every rank then computes the same
loss, and the sum's backward hands each stage the loss's gradient as it
is (``spmd.sum_over``).

Layer-granular (the stage function applies its slice of the stack), so it
composes with the in-stage TP/DP sharding: mesh ('pod'=stages, 'data',
'model').
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .spmd import sum_over


def _ring(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    """``t`` of the rank ``shift`` places before this one in ``group``'s
    ring (each rank sends its ``t`` ``shift`` places on)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.clone()
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    out = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t.contiguous(), dst, group),
        dist.P2POp(dist.irecv, out, src, group)])
    for req in reqs:
        req.wait()
    return out


class _Permute(torch.autograd.Function):
    """Ring permute to the next stage; its backward permutes back."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _ring(t, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring(g, ctx.group, -1), None


def pipeline_apply(
    stage_fn: Callable,       # (stage_params, x) -> x
    stage_params,             # pytree, leaves [n_stages, ...] (stage-major)
    x: torch.Tensor,          # [n_micro, micro_batch, ...] global microbatches
    mesh,
    axis: str = "pod",
) -> torch.Tensor:
    """Run x through n_stages pipeline stages; returns outputs [n_micro, ...].

    ``stage_params`` leaves carry a leading stage dim (every rank passes
    the whole stack; a stage reads its own slice, so its gradient lands in
    that slice only); ``x`` microbatches are the same on every stage (only
    stage 0 consumes them, only the last emits). The result is replicated
    over ``axis``."""
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    stage = mesh.get_local_rank(axis)
    params = torch.utils._pytree.tree_map(lambda t: t[stage], stage_params)
    n_micro = x.shape[0]
    buf = torch.zeros_like(x[0])
    outs = [torch.zeros_like(x[0]) for _ in range(n_micro)]
    sent = []
    # an idle tick sends zeros that still take part in autograd, so its
    # permute has a backward on every rank
    idle = torch.zeros((), dtype=x.dtype, device=x.device,
                       requires_grad=torch.is_grad_enabled())
    for t in range(n_micro + n_stages - 1):
        mb = t - stage
        if 0 <= mb < n_micro:
            y = stage_fn(params, x[t] if stage == 0 else buf)
            if stage == n_stages - 1:
                outs[mb] = y
        else:
            y = torch.zeros_like(buf) + idle
        buf = _Permute.apply(y, group)
        sent.append(buf)
    # every permute of every rank joins the output's graph (with weight
    # 0), so each rank's backward runs all of them, in the same (reverse
    # tick) order, and the ring's sends and receives pair up
    tie = sum(b.sum() for b in sent) * 0.0
    return sum_over(torch.stack(outs) + tie, group)


def split_stages(params, n_stages: int):
    """Reshape layer-stacked params [L, ...] -> [n_stages, L/n_stages, ...]."""
    def reshape(t):
        L = t.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             "stages")
        return t.reshape(n_stages, L // n_stages, *t.shape[1:])
    return torch.utils._pytree.tree_map(reshape, params)
