"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

Inputs are drawn with numpy from a seed and handed to both packages; JAX
uint32 words cross as their int32 bit patterns (``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SMALL = dict(D=1024, B=8, M=32, K=4, N_max=8, delta_budget=128, feat_dim=64)


def bipolar(rng: np.random.Generator, shape) -> np.ndarray:
    return np.where(rng.random(shape) < 0.5, 1, -1).astype(np.int8)


def pack_np(bip: np.ndarray) -> np.ndarray:
    """numpy pack_bits: bipolar int8 [..., D] -> uint32 [..., D//32]."""
    bits = (bip > 0).astype(np.uint64).reshape(*bip.shape[:-1], -1, 32)
    return np.sum(bits << np.arange(32, dtype=np.uint64), axis=-1,
                  dtype=np.uint64).astype(np.uint32)


def as_np(x) -> np.ndarray:
    """A JAX array, numpy array or torch tensor as numpy (int32 torch words
    stay int32; compare words through :func:`words`)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def words(x) -> np.ndarray:
    """Packed words from either package as uint32."""
    a = as_np(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def assert_same(a, b, what=""):
    a, b = as_np(a), as_np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype == np.float32 or b.dtype == np.float32:
        # bit-equal float32, -0.0 vs 0.0 and NaN payloads included
        assert np.array_equal(a.astype(np.float32).view(np.int32),
                              b.astype(np.float32).view(np.int32)), what
    else:
        assert np.array_equal(a, b), what


def assert_dataclass_same(port_obj, jax_obj, what=""):
    """Every field of a port dataclass equals the JAX pytree's field."""
    for f in dataclasses.fields(port_obj):
        pv, jv = getattr(port_obj, f.name), getattr(jax_obj, f.name)
        if dataclasses.is_dataclass(pv):
            assert_dataclass_same(pv, jv, f"{what}.{f.name}")
        elif f.name in ("packed", "pmajor", "q_packed"):
            assert_same(words(pv), words(jv), f"{what}.{f.name}")
        else:
            assert_same(pv, jv, f"{what}.{f.name}")

