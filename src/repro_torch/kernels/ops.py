"""Public kernel entry points (port of ``repro.kernels.ops``; so far the
encode front-end only)."""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import fused_window


def encode_packed(z, R, *, device=None) -> torch.Tensor:
    """Fused encode front-end: int32 words [N, D//32] = pack(sign(z @ R.T)).

    ``z`` [N, d] encoder features and ``R`` [D, d] projection (numpy arrays
    or tensors) move to ``device`` as float32 — the GPU unless the caller
    asks for the CPU — and go through ``fused_window.sign_project_pack``:
    the CUDA kernel on the card, its plain version on the CPU."""
    dev = resolve_device(device)
    return fused_window.sign_project_pack(_f32(z, dev), _f32(R, dev))


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):   # a copy: numpy inputs may be read-only
        x = torch.from_numpy(np.array(x, np.float32))
    return x.to(device=device, dtype=torch.float32).contiguous()
