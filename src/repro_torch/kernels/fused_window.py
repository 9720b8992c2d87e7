"""The port's hand-written CUDA kernels for the multi-stream serving path.

  * :func:`bank_prefix_hamming` — one pass over the plan-capped word prefix
    emitting the hamming count at every bank boundary, int32 [N, M, cap]. The
    batched multi-stream step hoists it over its flattened S x N_max
    proposal batch; a per-window bank choice then selects its boundary with
    one gather (``core.aligner.prefix_select``).
  * :func:`sign_project_pack` — encode front-end: sign-projection fused with
    bit-packing, writing the packed words directly.

Every wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty`` and launches on the current CUDA stream. A
tensor on the CPU takes the plain version in ``kernels.ref``; a CUDA tensor
launches the kernel or raises (no fallback). ``LAUNCHES`` counts kernel
launches per wrapper, so a run can show that its path went through them.
"""
from __future__ import annotations

import torch

from . import build, ref

LAUNCHES = {name: 0 for name in build.SIGNATURES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _route(name: str, *tensors: torch.Tensor) -> bool:
    """True to launch the CUDA kernel, False for the plain CPU version."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on different devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return True


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


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
    if not _route(name, q_packed, im_packed):
        return ref.bank_prefix_hamming_ref(q_packed, im_packed, cap=cap)
    out = torch.empty((N, M, cap), dtype=torch.int32, device=q_packed.device)
    if N == 0 or M == 0:
        return out
    fn = build.launch_fn(name)
    with torch.cuda.device(q_packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q_packed.data_ptr(), im_packed.data_ptr(), out.data_ptr(),
                 N, M, W, cap, stream)
    _check(name, err)
    LAUNCHES[name] += 1
    return out


def sign_project_pack(z: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Packed query words int32 [N, D//32] = pack(sign(z @ R.T)).

    ``z`` float32 [N, d], ``R`` float32 [D, d]. The kernel computes the
    product in plain FP32 (no TF32, no tensor cores): its bits agree with
    any float32 product except where |y| is within rounding of zero."""
    name = "sign_project_pack"
    if z.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError(f"{name}: z and R must be float32")
    if z.dim() != 2 or R.dim() != 2 or z.shape[1] != R.shape[1]:
        raise ValueError(f"{name}: expected z [N, d] and R [D, d]")
    N, d = z.shape
    D = R.shape[0]
    if D % 32:
        raise ValueError(f"{name}: D={D} must be a multiple of 32")
    if not _route(name, z, R):
        return ref.sign_project_pack_ref(z, R)
    out = torch.empty((N, D // 32), dtype=torch.int32, device=z.device)
    if N == 0 or D == 0:
        return out
    fn = build.launch_fn(name)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(z.data_ptr(), R.data_ptr(), out.data_ptr(), N, d, D, stream)
    _check(name, err)
    LAUNCHES[name] += 1
    return out
