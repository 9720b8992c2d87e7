"""Event SNN encoder (port of ``repro.core.encoder``; paper Sec. 3.2, 'Event
SNN encoder').

A lightweight spiking backbone over aggregated event windows: two conv-LIF
stages stepped over time bins, rate-coded readout, then a linear head to the
feature space z_e in R^d. Spikes use a straight-through surrogate gradient
(sigmoid derivative) so the contrastive bridge (Eq. 2-3) can train the SNN
end to end against frozen CLIP targets.

The per-proposal query hypervector is q = sign(R z_e) with a fixed random
projection R (not trained), per the paper; :func:`query_hv` computes it
through ``kernels.ops.sign_project`` (the ``sign_project`` CUDA kernel on
the card).

Two details keep the floats close to ``repro``'s:

  * ``"SAME"`` padding is XLA's: at stride 2 on an even size the one padded
    row and column go at the bottom and right, where ``padding=1`` would pad
    both sides (:func:`same_pad`);
  * every convolution, forward and backward, runs with cuDNN's TF32 off,
    whatever the caller's global flags (:class:`_ConvFP32`). Only the
    convolutions are guarded: cuDNN's TF32 flag is on by default, the
    matrix products' (``torch.backends.cuda.matmul.allow_tf32``) off, and
    the head's product follows that flag as the caller sets it.

The spike is a step, so two float computations of a membrane potential
within rounding of the threshold may fire differently; no port can be bit
for bit equal to ``repro`` here (``tests/test_torch_encoder.py`` states the
rule).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops

_SURROGATE_BETA = 4.0


class Spike(torch.autograd.Function):
    """Heaviside forward (v > 0, strict), sigmoid-derivative backward:
    g * beta * sigma(beta v) * (1 - sigma(beta v)) with beta = 4."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return (v > 0.0).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        s = torch.sigmoid(_SURROGATE_BETA * v)
        return g * _SURROGATE_BETA * s * (1.0 - s)


def spike(v: torch.Tensor) -> torch.Tensor:
    return Spike.apply(v)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    c1: int = 16
    c2: int = 32
    feat_dim: int = 512
    tau: float = 0.7        # LIF leak
    thresh: float = 0.5     # firing threshold


class Encoder(nn.Module):
    """The encoder's weights: ``conv1`` [c1, 2, 3, 3] and ``conv2``
    [c2, c1, 3, 3] (OIHW; ``repro`` stores HWIO), ``head`` [c2, d] and
    ``head_b`` [d]."""

    def __init__(self, conv1: torch.Tensor, conv2: torch.Tensor,
                 head: torch.Tensor, head_b: torch.Tensor):
        super().__init__()
        self.conv1 = nn.Parameter(conv1)
        self.conv2 = nn.Parameter(conv2)
        self.head = nn.Parameter(head)
        self.head_b = nn.Parameter(head_b)


def init_encoder(cfg: EncoderConfig,
                 generator: torch.Generator | None = None) -> Encoder:
    """He-initialised weights (fan-in 18, 9 c1 and c2, as ``repro``), drawn
    on the CPU from ``generator``; ``Encoder.to`` moves them."""
    def he(shape, fan_in):
        return torch.randn(shape, generator=generator) * np.sqrt(2.0 / fan_in)

    return Encoder(
        conv1=he((cfg.c1, 2, 3, 3), 18),
        conv2=he((cfg.c2, cfg.c1, 3, 3), 9 * cfg.c1),
        head=he((cfg.c2, cfg.feat_dim), cfg.c2),
        head_b=torch.zeros((cfg.feat_dim,)),
    )


def same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: (low, high) with
    total = max((ceil(size / stride) - 1) * stride + k - size, 0) and
    low = total // 2."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


_FLAGS_LOCK = threading.RLock()


@contextlib.contextmanager
def _fp32_conv_flags():
    """cuDNN on, TF32 off, the caller's benchmark and determinism kept.

    ``cudnn.flags`` sets process-wide flags for the block and puts them
    back after it, so a cuDNN call that another thread makes meanwhile
    runs with TF32 off too. The lock keeps two of these blocks (a forward
    and autograd's backward on its own thread) from overlapping, where the
    later to end would put back the flags the other had set."""
    cudnn = torch.backends.cudnn
    with _FLAGS_LOCK, cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                                  deterministic=cudnn.deterministic,
                                  allow_tf32=False):
        yield


class _ConvFP32(torch.autograd.Function):
    """Unpadded ``F.conv2d`` whose forward and backward both run inside
    :func:`_fp32_conv_flags` (autograd runs the backward later, on its own
    thread on the card, outside any block the forward ran in)."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _fp32_conv_flags():
            return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _fp32_conv_flags():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [ctx.stride] * 2, [0, 0], [1, 1], False,
                [0, 0], 1, [ctx.needs_input_grad[0],
                            ctx.needs_input_grad[1], False])
        return gx, gw, None


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """``repro``'s ``_conv`` in NCHW / OIHW: XLA's ``"SAME"`` padding applied
    with ``F.pad``, then an unpadded FP32 convolution."""
    kh, kw = w.shape[-2:]
    top, bottom = same_pad(x.shape[-2], kh, stride)
    left, right = same_pad(x.shape[-1], kw, stride)
    x = F.pad(x, (left, right, top, bottom))
    return _ConvFP32.apply(x, w, stride)


def encode_batch(enc: Encoder, vols: torch.Tensor, cfg: EncoderConfig
                 ) -> torch.Tensor:
    """vols: [N, T_bins, H, W, 2] (proposal windows) -> z_e [N, d].

    LIF membrane potentials persist across time bins (soft reset); the
    readout is the spike rate of the second stage, globally pooled. conv1
    does not depend on the LIF state, so it runs over all N x T windows at
    once; conv2 runs once per time bin over the N proposals."""
    N, T, H, W, _ = vols.shape
    x = vols.permute(0, 1, 4, 2, 3).reshape(N * T, 2, H, W)
    c1 = conv_same(x, enc.conv1, 2)
    c1 = c1.reshape(N, T, *c1.shape[1:])                  # [N, T, c1, h1, w1]
    v1 = torch.zeros_like(c1[:, 0])
    v2 = rate = None
    for t in range(T):
        v1 = cfg.tau * v1 + c1[:, t]
        s1 = spike(v1 - cfg.thresh)
        c2 = conv_same(s1, enc.conv2, 2)                  # [N, c2, h2, w2]
        if v2 is None:
            v2 = torch.zeros_like(c2)
            rate = torch.zeros_like(c2)
        v2 = cfg.tau * v2 + c2
        s2 = spike(v2 - cfg.thresh)
        v1 = v1 - s1 * cfg.thresh                         # soft reset
        v2 = v2 - s2 * cfg.thresh
        rate = rate + s2
    pooled = torch.mean(rate / T, dim=(2, 3))             # [N, c2]
    return pooled @ enc.head + enc.head_b                 # [N, d]


def encode(enc: Encoder, vol: torch.Tensor, cfg: EncoderConfig
           ) -> torch.Tensor:
    """vol: [T_bins, H, W, 2] (one proposal window) -> z_e [d]."""
    return encode_batch(enc, vol[None], cfg)[0]


def make_projection(D: int, d: int,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Fixed random projection R [D, d] for q = sign(R z_e), drawn on the
    CPU."""
    return torch.randn((D, d), generator=generator) / np.sqrt(d)


def query_hv(enc: Encoder, vol: torch.Tensor, R: torch.Tensor,
             cfg: EncoderConfig) -> torch.Tensor:
    """Full encoder -> bipolar query path: int8 codes sign(R z_e), [D] for
    one window [T_bins, H, W, 2], [N, D] for [N, T_bins, H, W, 2]. The
    projection runs through ``ops.sign_project`` on the volumes' device
    (the ``sign_project`` kernel on the card)."""
    one = vol.dim() == 4
    with torch.no_grad():
        z = encode_batch(enc, vol[None] if one else vol, cfg)
    q = ops.sign_project(z, R, device=vol.device)
    return q[0] if one else q
