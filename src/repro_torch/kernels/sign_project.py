"""Fused sign-projection kernel: codes = sign(z @ R.T) (port of
``repro.kernels.sign_project``; paper Sec. 3.2).

Fuses the [N, d] x [d, D] projection with the sign quantization, so the
float32 intermediate y never reaches device memory: only the int8 bipolar
code is written (4x less than y; ``fused_window.sign_project_pack`` packs
32 codes per word for a further 8x). The CUDA kernel
(``csrc/sign_project.cu``) is a register-tiled plain FP32 product (no TF32,
no tensor cores): its signs agree with any float32 product except where
|y| is within rounding of zero, so it is held to the plain version by the
agreement rule of ``ref.sign_disagreement``.
"""
from __future__ import annotations

import torch

from . import build, ref


def sign_project(z: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Bipolar int8 codes [N, D] = sign(z @ R.T), sign(0) -> +1 and
    NaN -> -1.

    ``z`` float32 [N, d] and ``R`` float32 [D, d]; any N and D, d >= 1."""
    name = "sign_project"
    if z.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError(f"{name}: z and R must be float32")
    if z.dim() != 2 or R.dim() != 2 or z.shape[1] != R.shape[1]:
        raise ValueError(f"{name}: expected z [N, d] and R [D, d]")
    N, d = z.shape
    D = R.shape[0]
    if d < 1:
        raise ValueError(f"{name}: the feature axis is empty")
    if not build.route(name, z, R):
        return ref.sign_project_ref(z, R)
    out = torch.empty((N, D), dtype=torch.int8, device=z.device)
    if N and D:
        build.launch(name, z.device, z, R, out, N, d, D)
    return out
