"""The port's hand-written CUDA kernels for the window step's full path and
encode front-end.

  * :func:`fused_scores` — one pass fusing the gated XNOR-popcount scan, the
    integer accumulation (``acc = D' - 2*hamming``) and the argmax / top-2
    readout, over a static plan's pre-sliced words. The switch lowering
    (the single-window step and the serial multi-stream step) runs it once
    per window on its bank choice (``core.aligner.full_scores_all``).
  * :func:`bank_prefix_hamming` — one pass over the plan-capped word prefix
    emitting the hamming count at every bank boundary, int32 [N, M, cap]. The
    batched multi-stream step hoists it over its flattened S x N_max
    proposal batch; a per-window bank choice then selects its boundary with
    one gather (``core.aligner.prefix_select``). The compact dispatch runs it
    over a bucket of only the full-path proposals.
  * :func:`delta_apply` — the delta path's Eq. 6 scatter-accumulate through
    the ``delta_update`` kernel.
  * :func:`sign_project_pack` — encode front-end: sign-projection fused with
    bit-packing, writing the packed words directly; a 3xTF32 tensor-core
    product (see its docstring).

Every wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty`` and launches on the current CUDA stream. A
tensor on the CPU takes the plain version in ``kernels.ref``; a CUDA tensor
launches the kernel or raises (no fallback). ``LAUNCHES`` counts kernel
launches per kernel (shared with the other kernel modules).
"""
from __future__ import annotations

import torch

from . import build, ref
from .build import LAUNCHES, reset_launches  # noqa: F401  (re-exported)
from .delta_update import delta_update


def fused_scores(q_packed: torch.Tensor, im_packed: torch.Tensor, *,
                 d_eff: int):
    """(acc int32 [N, M], best int32 [N], top2 int32 [N, 2]) in one pass.

    ``q_packed`` int32 [N, W] and ``im_packed`` int32 [M, W] hold a static
    plan's enabled words in one column order; ``acc = d_eff - 2*hamming``.
    ``best`` is the first index of each row's maximum (``argmax``) and
    ``top2`` the two highest accumulators, ``top2[:, 1]`` being the largest
    value at any other index (equal to ``top2[:, 0]`` on a tied maximum;
    INT32_MIN when M < 2)."""
    name = "fused_scores"
    if q_packed.dtype != torch.int32 or im_packed.dtype != torch.int32:
        raise TypeError(f"{name}: packed words must be int32")
    if q_packed.dim() != 2 or im_packed.dim() != 2 or \
            q_packed.shape[1] != im_packed.shape[1]:
        raise ValueError(f"{name}: expected [N, W] and [M, W]")
    N, W = q_packed.shape
    M = im_packed.shape[0]
    if M < 1:
        raise ValueError(f"{name}: the item memory has no classes")
    if not build.route(name, q_packed, im_packed):
        return ref.fused_scores_ref(q_packed, im_packed, d_eff=d_eff)
    dev = q_packed.device
    acc = torch.empty((N, M), dtype=torch.int32, device=dev)
    best = torch.empty((N,), dtype=torch.int32, device=dev)
    top2 = torch.empty((N, 2), dtype=torch.int32, device=dev)
    if N:
        build.launch(name, dev, q_packed, im_packed, acc, best, top2, N, M,
                     W, int(d_eff))
    return acc, best, top2


def bank_prefix_hamming(q_packed: torch.Tensor, im_packed: torch.Tensor, *,
                        cap: int) -> torch.Tensor:
    """Hamming over the first 1..cap banks' enabled words: int32 [N, M, cap].

    ``q_packed`` int32 [N, cap * epw] and ``im_packed`` int32 [M, cap * epw]
    hold the plan's enabled words in the same bank-major column order."""
    name = "bank_prefix_hamming"
    if q_packed.dtype != torch.int32 or im_packed.dtype != torch.int32:
        raise TypeError(f"{name}: packed words must be int32")
    if q_packed.dim() != 2 or im_packed.dim() != 2:
        raise ValueError(f"{name}: expected 2-D [N, W] and [M, W]")
    N, W = q_packed.shape
    M, W2 = im_packed.shape
    if W != W2 or cap < 1 or W % cap:
        raise ValueError(f"{name}: W={W}, W_im={W2}, cap={cap}: the word "
                         "counts must agree and divide by cap")
    if not build.route(name, q_packed, im_packed):
        return ref.bank_prefix_hamming_ref(q_packed, im_packed, cap=cap)
    out = torch.empty((N, M, cap), dtype=torch.int32, device=q_packed.device)
    if N and M:
        build.launch(name, q_packed.device, q_packed, im_packed, out, N, M,
                     W, cap)
    return out


def delta_apply(acc: torch.Tensor, dmajor: torch.Tensor, idx: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """Sparse Eq. 6 scatter-accumulate
    ``acc + sum_k weight[k] * dmajor[idx[k], :]`` through the
    ``delta_update`` kernel; ``acc`` [..., M] with the matching leading axes
    on ``idx``/``weight`` [..., budget] (the multi-stream loop's [S])."""
    return delta_update(acc, dmajor, idx, weight)


def sign_project_pack(z: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Packed query words int32 [N, D//32] = pack(sign(z @ R.T)), bit i
    of word w = dim 32w + i, bit 1 where y >= 0 (NaN -> 0).

    ``z`` float32 [N, d], ``R`` float32 [D, d], D % 32 == 0. The CUDA
    kernel (``csrc/sign_project_pack.cu`` over ``csrc/sign_gemm.cuh``)
    replaces the TPU kernel ``src/repro/kernels/fused_window.py:382``
    (``_pack_kernel``, ``pallas_call`` at ``:403``). It runs the product on
    the tensor cores in 3xTF32 (big = tf32(x), small = tf32(x - big);
    small*big + big*small + big*big summed in float32, about 2^-21 |z*R| of
    error per product). Operations bound it on the H100 at N >= 128 (0.104
    ms at the engine's N = 2048, 6.5 us at N = 128) and bytes at N = 8 (R's
    16.8 MB, 5 us). Its bits agree with any float32 product except where
    |y| is within rounding of zero, under the rule of
    ``ref.sign_pack_disagreement`` (no bit with |y| above tau =
    d * 2^-23 * sum|z*R| may differ, at most 1e-4 of those below): 3xTF32
    stays two orders of magnitude inside tau, while one TF32 product
    (about 2^-11 |z*R|) flipped 83 % of the 1e-4 budget in the emulation of
    ``tests/test_torch_encode_split.py`` (N = 128, d = 512, D = 8192). On
    the card the features must be finite:
    a +-inf entry is outside the split's contract (big(inf) * small(R) can
    turn a y of +-inf into NaN), and nothing checks for it; an all-zero row
    packs all ones and a row holding a NaN all zeros, as in the plain
    version."""
    name = "sign_project_pack"
    if z.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError(f"{name}: z and R must be float32")
    if z.dim() != 2 or R.dim() != 2 or z.shape[1] != R.shape[1]:
        raise ValueError(f"{name}: expected z [N, d] and R [D, d]")
    N, d = z.shape
    D = R.shape[0]
    if D % 32:
        raise ValueError(f"{name}: D={D} must be a multiple of 32")
    if not build.route(name, z, R):
        return ref.sign_project_pack_ref(z, R)
    out = torch.empty((N, D // 32), dtype=torch.int32, device=z.device)
    if N and D:
        build.launch(name, z.device, z, R, out, N, d, D)
    return out
