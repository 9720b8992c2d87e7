"""Delta-update kernel: sparse accumulator corrections (port of
``repro.kernels.delta_update``; paper Eq. 6, Sec. 4.3).

The ASIC pops flipped-bit indices from a Delta-FIFO and touches only those
item-memory columns; the TPU kernel scalar-prefetches the index array and
streams one D-major row per grid step. The CUDA kernel
(``csrc/delta_update.cu``) deals each row's budget to a cluster of blocks,
compacts the weighted entries in shared memory and reads only their rows
of ``dmajor``, so O(|Delta| * M) bytes move, never O(D * M); the blocks'
partial sums meet in distributed shared memory within the one launch.
Padding entries carry weight 0 (and index 0) and are skipped.
"""
from __future__ import annotations

import torch

from ..perf.op_analyze import kernel_op
from . import build, ref


@kernel_op("delta_update",
           lambda acc, dmajor, idx, w: 2 * idx.numel() * dmajor.shape[1])
def delta_update(acc: torch.Tensor, dmajor: torch.Tensor, idx: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """``acc + sum_k weight[k] * dmajor[idx[k], :]``: int32 [..., M].

    ``acc`` int32 [..., M] (the leading axes, if any, batch rows: JAX's
    vmap over streams), ``dmajor`` int8 [D, M], ``idx`` int32
    [..., budget] (as JAX's gather takes it: a negative index wraps from
    the end once, then every index clamps to [0, D)) and
    ``weight`` int32 [..., budget] in {-2, 0, +2}."""
    name = "delta_update"
    if acc.dtype != torch.int32 or idx.dtype != torch.int32 or \
            weight.dtype != torch.int32 or dmajor.dtype != torch.int8:
        raise TypeError(f"{name}: acc, idx and weight must be int32 and "
                        "dmajor int8")
    if dmajor.dim() != 2 or acc.shape[-1] != dmajor.shape[1] or \
            idx.shape != weight.shape or idx.shape[:-1] != acc.shape[:-1]:
        raise ValueError(f"{name}: expected acc [..., M], dmajor [D, M] and "
                         "idx, weight [..., budget] with acc's leading axes")
    D, M = dmajor.shape
    if D < 1:
        raise ValueError(f"{name}: dmajor has no rows")
    if not build.route(name, acc, dmajor, idx, weight):
        return ref.delta_update_ref(acc, dmajor, idx, weight)
    L, K = acc.numel() // max(M, 1), idx.shape[-1]
    out = torch.empty_like(acc)
    if L and M:
        build.launch(name, acc.device, acc, dmajor, idx, weight, out, L, M,
                     D, K)
    return out
