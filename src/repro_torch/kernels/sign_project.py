"""Fused sign-projection kernel: codes = sign(z @ R.T) (port of
``repro.kernels.sign_project``; paper Sec. 3.2).

Fuses the [N, d] x [d, D] projection with the sign quantization, so the
float32 intermediate y never reaches device memory: only the int8 bipolar
code is written (4x less than y; ``fused_window.sign_project_pack`` packs
32 codes per word for a further 8x).

The CUDA kernel (``csrc/sign_project.cu`` over the mainloop of
``csrc/sign_gemm.cuh``) replaces the TPU kernel
``src/repro/kernels/sign_project.py:30`` (``_kernel``, ``pallas_call`` at
``:46``). It runs the product on the tensor cores in 3xTF32: every
operand x is split into big = tf32(x) and small = tf32(x - big), and
small*big + big*small + big*big is summed in float32 (about 2^-21 |z*R|
of error per product). On the H100 operations bound it at N >= 128 (three
TF32 products at 495 TFLOP/s: 0.104 ms at N = 2048, 6.5 us at N = 128)
and bytes at N = 8 (R's 16.8 MB read once, 5 us). Its signs agree with
any float32 product except where |y| is within rounding of zero, so it is
held to the plain version by the agreement rule of
``ref.sign_disagreement``: no code with |y| above tau = d * 2^-23 *
sum|z*R| (2^-14 sum|z*R| at d = 512) may differ, and at most 1e-4 of the
codes below it. 3xTF32 stays two orders of magnitude inside tau; one TF32
product (about 2^-11 |z*R|) does not: emulated at N = 128, d = 512,
D = 8192 it flipped 87 of 1,048,576 codes, 83 % of that 1e-4 budget,
against none for 3xTF32 (``tests/test_torch_encode_split.py`` pins both).
"""
from __future__ import annotations

import torch

from . import build, ref


def sign_project(z: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Bipolar int8 codes [N, D] = sign(z @ R.T), sign(0) -> +1 and
    NaN -> -1.

    ``z`` float32 [N, d] and ``R`` float32 [D, d]; any N and D, d >= 1.
    On the card the features must be finite: a +-inf entry is outside the
    3xTF32 split's contract (big(inf) * small(R) can turn a y of +-inf into
    NaN), and nothing checks for it; an all-zero row codes +1 and a row
    holding a NaN codes -1, as in the plain version."""
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
