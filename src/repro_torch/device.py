"""Device resolution shared by the port's entry points, and the card's
identity as ``nvidia-smi`` reports it."""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Asking for CUDA (explicitly or by default) on a machine without
    a GPU raises; there is no silent fall back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return device


def smi(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields>`` for the first GPU, as it prints
    them without a header. Every time the port measures on a card is
    reported beside ``smi("name,power.limit")``."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
