"""XNOR-popcount associative similarity kernel (port of
``repro.kernels.xnor_popcount_sim``; paper Sec. 4.2/4.3).

Hypervectors are packed 32 dims per word; xor + popcount gives the hamming
distance, and dot = d_eff - 2*hamming. :func:`packed_hamming_batched` keeps
a leading batch axis: the batched decide pass scores every stream's
proposals against that stream's own cache snapshot ([S, N, W] x [S, K, W])
and against its own proposals ([S, N, W] x [S, N, W]) in one launch. The
CUDA kernel (``csrc/packed_hamming_batched.cu``) runs the products on the
1-bit tensor cores, hamming = popc(q) + popc(h) - 2 popc(q & h), and picks
its own tiles by the shape, so ``repro``'s query-tile knob ``tq`` and its
``tq = 1`` wrapper ``packed_hamming`` have no counterpart here.
"""
from __future__ import annotations

import torch

from ..perf.op_analyze import kernel_op
from . import build, ref


@kernel_op("packed_hamming_batched",
           lambda q, h: 64 * q.numel() * h.shape[-2])
def packed_hamming_batched(q_packed: torch.Tensor,
                           im_packed: torch.Tensor) -> torch.Tensor:
    """Hamming distance of every query to every class row: int32 [..., N, M].

    ``q_packed`` int32 [N, W] and ``im_packed`` int32 [M, W], or both with
    one leading batch axis ([S, N, W] and [S, M, W]: batch s scores its own
    rows only). Words are pre-sliced to the enabled ones."""
    name = "packed_hamming_batched"
    if q_packed.dtype != torch.int32 or im_packed.dtype != torch.int32:
        raise TypeError(f"{name}: packed words must be int32")
    if q_packed.dim() != im_packed.dim() or q_packed.dim() not in (2, 3) or \
            q_packed.shape[:-2] != im_packed.shape[:-2] or \
            q_packed.shape[-1] != im_packed.shape[-1]:
        raise ValueError(f"{name}: expected [N, W] and [M, W], or "
                         "[S, N, W] and [S, M, W]")
    if not build.route(name, q_packed, im_packed):
        return ref.packed_hamming_ref(q_packed, im_packed)
    *lead, N, W = q_packed.shape
    M = im_packed.shape[-2]
    S = lead[0] if lead else 1
    out = torch.empty((*lead, N, M), dtype=torch.int32,
                      device=q_packed.device)
    if S and N and M:
        build.launch(name, q_packed.device, q_packed, im_packed, out, S, N,
                     M, W)
    return out

