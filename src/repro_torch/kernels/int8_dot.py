"""Exact int8 x int8 -> int32 contractions of the int8 decode cache (the
``serve_quant="int8"`` path of ``models/attention.py`` and ``models/mla.py``).

The reference contracts its int8 operands with ``jnp.einsum`` on
``astype(int32)`` (``src/repro/models/attention.py:178, 208``;
``src/repro/models/mla.py:126-132``); no Pallas kernel is involved. The
card has no batched integer product in PyTorch (``torch.matmul`` refuses
integer types on CUDA, ``torch._int_mm`` is 2-D with more than 16 rows),
and a float32 product stops being exact once a sum passes 2^24, so
``csrc/int8_dot.cu`` accumulates in int32. Two entry points:

- :func:`rows`: ``out[b,h,g,s] = sum_k a[b,h,g,k] c[b,s,h,k]``, the GQA
  scores (``bhgd,bshd->bhgs``) and, with one head group, the MLA scores
  (``bhr,bsr->bhs``);
- :func:`cols`: ``out[b,h,g,k] = sum_s p[b,h,g,s] c[b,s,h,k]`` for
  ``k < K``, the GQA values and the MLA values over the first r codes of
  each r + dr latent row (the row stride is passed, nothing is copied).

Both take plain tensors: over a mesh the caller runs them on each rank's
own rows and heads (``spmd.per_head``), and a DTensor raises ``TypeError``.
On a CPU tensor each takes its plain version (``ref.int8_dot_rows_ref``,
``ref.int8_dot_cols_ref``: an int32 einsum); on a CUDA tensor it launches
the kernel, which adds one to ``build.LAUNCHES["int8_dot"]``.
"""
from __future__ import annotations

import torch

from ..perf.op_analyze import kernel_op
from . import build, ref

NAME = "int8_dot"
ROWS, COLS = 0, 1


def _check(a: torch.Tensor, c: torch.Tensor, k: int) -> None:
    if any(type(t).__name__ == "DTensor" for t in (a, c)):
        raise TypeError(f"{NAME}: a DTensor reached the wrapper; over a mesh "
                        "the caller passes each rank's local tensors "
                        "(runtime/spmd.py::per_head)")
    if a.dtype != torch.int8 or c.dtype != torch.int8:
        raise TypeError(f"{NAME}: operands must be int8")
    if a.dim() != 4 or c.dim() != 4 or c.shape[0] != a.shape[0] or \
            c.shape[2] != a.shape[1]:
        raise ValueError(f"{NAME}: expected a [B, Hk, G, *] and c "
                         f"[B, S, Hk, L], got {tuple(a.shape)} and "
                         f"{tuple(c.shape)}")
    if k > c.shape[3]:
        raise ValueError(f"{NAME}: {k} codes a row, c holds {c.shape[3]}")
    if a.shape[0] * a.shape[1] > 65535:
        raise ValueError(f"{NAME}: B * Hk above 65535")


def _launch(mode: int, a: torch.Tensor, c: torch.Tensor, out: torch.Tensor,
            S: int, K: int) -> torch.Tensor:
    B, Hk, G = a.shape[:3]
    if out.numel():
        if S == 0 or K == 0:
            out.zero_()
        else:
            build.launch(NAME, a.device, a, c, out, mode, B, Hk, G, S, K,
                         c.shape[3])
    return out


@kernel_op(NAME, lambda a, c: 2 * a.numel() * c.shape[1])
def rows(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """int32 [B, Hk, G, S]: every row of ``a`` int8 [B, Hk, G, K] against
    the first K codes of every row of ``c`` int8 [B, S, Hk, L >= K] of its
    head."""
    K = a.shape[-1]
    _check(a, c, K)
    if not build.route(NAME, a, c):
        return ref.int8_dot_rows_ref(a, c)
    B, Hk, G = a.shape[:3]
    S = c.shape[1]
    out = torch.empty((B, Hk, G, S), dtype=torch.int32, device=a.device)
    return _launch(ROWS, a, c, out, S, K)


@kernel_op(NAME, lambda p, c, k=None: 2 * p.numel()
           * (c.shape[3] if k is None else k))
def cols(p: torch.Tensor, c: torch.Tensor, k: int | None = None
         ) -> torch.Tensor:
    """int32 [B, Hk, G, k]: ``p`` int8 [B, Hk, G, S] weighting the rows of
    ``c`` int8 [B, S, Hk, L] of its head, over their first ``k`` codes (all
    L when None)."""
    k = c.shape[3] if k is None else k
    _check(p, c, k)
    if p.shape[3] != c.shape[1]:
        raise ValueError(f"{NAME}: p has {p.shape[3]} positions, c "
                         f"{c.shape[1]}")
    if not build.route(NAME, p, c):
        return ref.int8_dot_cols_ref(p, c, k)
    B, Hk, G, S = p.shape
    out = torch.empty((B, Hk, G, k), dtype=torch.int32, device=p.device)
    return _launch(COLS, p, c, out, S, k)
