"""XNOR-popcount associative similarity kernel (port of
``repro.kernels.xnor_popcount_sim``; paper Sec. 4.2/4.3).

Hypervectors are packed 32 dims per word; xor + popcount gives the hamming
distance, and dot = d_eff - 2*hamming. :func:`packed_hamming_batched` keeps
a leading batch axis: the batched decide pass scores every stream's
proposals against that stream's own cache snapshot ([S, N, W] x [S, K, W])
and against its own proposals ([S, N, W] x [S, N, W]) in one launch. A block
stages ``tq`` query rows in shared memory and reuses each class row it reads
``tq`` times (``csrc/packed_hamming_batched.cu``); :func:`packed_hamming` is
the ``tq = 1`` specialization.
"""
from __future__ import annotations

import torch

from . import build, ref

TQ_DEFAULT = 8   # query rows per block (the kernel's register bound)


def fit_tile(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (>= 1): the query rows
    per block, so every block's rows are real rows."""
    t = max(1, min(cap, n))
    while n % t:
        t -= 1
    return t


def packed_hamming_batched(q_packed: torch.Tensor, im_packed: torch.Tensor,
                           *, tq: int = TQ_DEFAULT) -> torch.Tensor:
    """Hamming distance of every query to every class row: int32 [..., N, M].

    ``q_packed`` int32 [N, W] and ``im_packed`` int32 [M, W], or both with
    one leading batch axis ([S, N, W] and [S, M, W]: batch s scores its own
    rows only). Words are pre-sliced to the enabled ones. ``tq`` (1..8)
    caps the query rows a block shares; it is clipped to a divisor of N."""
    name = "packed_hamming_batched"
    if q_packed.dtype != torch.int32 or im_packed.dtype != torch.int32:
        raise TypeError(f"{name}: packed words must be int32")
    if q_packed.dim() != im_packed.dim() or q_packed.dim() not in (2, 3) or \
            q_packed.shape[:-2] != im_packed.shape[:-2] or \
            q_packed.shape[-1] != im_packed.shape[-1]:
        raise ValueError(f"{name}: expected [N, W] and [M, W], or "
                         "[S, N, W] and [S, M, W]")
    if not 1 <= tq <= TQ_DEFAULT:
        raise ValueError(f"{name}: tq={tq} must be in 1..{TQ_DEFAULT}")
    if not build.route(name, q_packed, im_packed):
        return ref.packed_hamming_ref(q_packed, im_packed)
    *lead, N, W = q_packed.shape
    M = im_packed.shape[-2]
    S = lead[0] if lead else 1
    out = torch.empty((*lead, N, M), dtype=torch.int32,
                      device=q_packed.device)
    if S and N and M:
        build.launch(name, q_packed.device, q_packed, im_packed, out, S, N,
                     M, W, fit_tile(N, tq))
    return out


def packed_hamming(q_packed: torch.Tensor,
                   im_packed: torch.Tensor) -> torch.Tensor:
    """Row-per-block variant: the ``tq = 1`` specialization."""
    return packed_hamming_batched(q_packed, im_packed, tq=1)
