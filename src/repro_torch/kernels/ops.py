"""Public kernel entry points (port of ``repro.kernels.ops``).

Bank gating contract: ``banks`` is a *static* int here, latched on the host
per call, and each plan reads only its enabled words. Steps whose bank
choice is a per-window tensor go through ``core.aligner.full_scores_all``
(bank-prefix dispatch), ``core.aligner.switch_scores`` (the bank choice
read on the host) or ``core.aligner.compact_full_scores``.
Unlike ``repro``'s wrappers these need no fallback to a plain version on
ragged shapes: every CUDA kernel of the port takes any N and M.

Precision gating rides the same contract: ``planes`` (of ``plane_total``
bit-slice planes) selects the enabled words plane-major — a contiguous
per-plane-block prefix of the item memory's ``pmajor`` view when the caller
provides it, a static column gather otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.item_memory import plane_sel
from ..device import resolve_device
from . import fused_window
from .sign_project import sign_project as _sign_project
from .xnor_popcount_sim import packed_hamming_batched


def _batched_hamming(q: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Shared dispatch for every packed-hamming consumer (full-path scans
    and cache lookups): ``packed_hamming_batched``. int32 [..., N, M]."""
    return packed_hamming_batched(q.contiguous(), h.contiguous())


def _plan_columns(arrays, banks: int, bank_words: int, planes: int | None,
                  plane_total: int, pmajor: torch.Tensor | None = None):
    """Restrict packed-word arrays to a (banks, planes) plan's enabled words.

    Returns the restricted arrays (all in the same column order — hamming
    sums over columns, so any shared order is exact) and the effective
    dimension. Full precision keeps the contiguous bank-prefix slice;
    reduced precision selects plane-major columns — from a contiguous
    per-plane-block prefix of ``pmajor`` for the last array (the item
    memory) when given, a static gather otherwise."""
    words_eff = banks * bank_words
    if planes is None or planes >= plane_total:
        return tuple(a[:, :words_eff] for a in arrays), 32 * words_eff
    sel = plane_sel(words_eff, planes, plane_total)
    out = []
    for i, a in enumerate(arrays):
        if i == len(arrays) - 1 and pmajor is not None:
            wpb = pmajor.shape[1] // plane_total
            keep = words_eff // plane_total
            out.append(torch.cat([pmajor[:, p * wpb: p * wpb + keep]
                                  for p in range(planes)], dim=1))
        else:
            out.append(a[:, torch.as_tensor(sel, device=a.device)])
    return tuple(out), 32 * sel.size


def packed_similarity(q_packed: torch.Tensor, im_packed: torch.Tensor, *,
                      banks: int, bank_words: int, planes: int | None = None,
                      plane_total: int = 4,
                      pmajor: torch.Tensor | None = None):
    """Full-scan scores under the (banks, planes) plan's enabled dims:
    (acc int32 [N, M], cosine f32 [N, M]) through
    ``packed_hamming_batched``."""
    (q, h), d_eff = _plan_columns((q_packed, im_packed), banks, bank_words,
                                  planes, plane_total, pmajor=pmajor)
    acc = d_eff - 2 * _batched_hamming(q, h)
    return acc, acc.to(torch.float32) / d_eff


def fused_similarity(q_packed: torch.Tensor, im_packed: torch.Tensor, *,
                     banks: int, bank_words: int, planes: int | None = None,
                     plane_total: int = 4,
                     pmajor: torch.Tensor | None = None):
    """Host-latched entry to the fused window-step kernel
    (``fused_window.fused_scores``): scan, integer accumulation and the
    argmax / top-2 readout in one pass. Returns (acc int32 [N, M], cosine
    f32 [N, M], best int32 [N], top2 int32 [N, 2])."""
    (q, h), d_eff = _plan_columns((q_packed, im_packed), banks, bank_words,
                                  planes, plane_total, pmajor=pmajor)
    acc, best, top2 = fused_window.fused_scores(q.contiguous(),
                                                h.contiguous(), d_eff=d_eff)
    return acc, acc.to(torch.float32) / d_eff, best, top2


def cache_nearest(q_packed: torch.Tensor, cache_packed: torch.Tensor,
                  cache_valid: torch.Tensor, *, banks: int, bank_words: int,
                  planes: int | None = None, plane_total: int = 4):
    """Batched PSU nearest match: every query vs every cache entry, the
    cache's packed queries standing in for the item memory. Returns (idx
    int32 [N], rho f32 [N] per Eq. 5, hamming int32 [N]); invalid entries
    are pushed to rho = -inf, and the first maximum wins ties."""
    (q, c), d_eff = _plan_columns((q_packed, cache_packed), banks,
                                  bank_words, planes, plane_total)
    ham = _batched_hamming(q, c)
    rho = 1.0 - 2.0 * ham.to(torch.float32) / float(d_eff)
    rho = torch.where(cache_valid[None, :], rho, float("-inf"))
    idx = torch.argmax(rho, dim=-1)
    n = torch.arange(idx.shape[0], device=idx.device)
    return idx.to(torch.int32), rho[n, idx], ham[n, idx]


def masked_hamming_all(q_packed: torch.Tensor, e_packed: torch.Tensor,
                       wmask: torch.Tensor) -> torch.Tensor:
    """Plan-gated hamming lookup table int32 [..., N, K]: every query row vs
    every entry row, counted over the words ``wmask`` [..., W] enables (a
    per-window tensor). Disabled words are zeroed on both operands, so their
    xor adds nothing and the plain hamming kernel computes the gated sum.
    With a leading stream axis each stream scores its own rows only — the
    batched decide pass's snapshot and proposal tables in one launch
    each."""
    wmask = wmask[..., None, :]
    q = torch.where(wmask, q_packed, 0)
    e = torch.where(wmask, e_packed, 0)
    return _batched_hamming(q, e)


def delta_update(acc: torch.Tensor, dmajor: torch.Tensor, idx: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """Sparse Eq. 6 correction (``fused_window.delta_apply``)."""
    return fused_window.delta_apply(acc, dmajor, idx, weight)


def encode_packed(z, R, *, device=None) -> torch.Tensor:
    """Fused encode front-end: int32 words [N, D//32] = pack(sign(z @ R.T)).

    ``z`` [N, d] encoder features and ``R`` [D, d] projection (numpy arrays
    or tensors) move to ``device`` as float32 — the GPU unless the caller
    asks for the CPU — and go through ``fused_window.sign_project_pack``:
    the CUDA kernel on the card, its plain version on the CPU."""
    dev = resolve_device(device)
    return fused_window.sign_project_pack(_f32(z, dev), _f32(R, dev))


def sign_project(z, R, *, device=None) -> torch.Tensor:
    """Fused bipolar projection: int8 codes [N, D] = sign(z @ R.T), sign(0)
    -> +1.

    ``z`` [N, d] and ``R`` [D, d] (numpy arrays or tensors) move to
    ``device`` as float32 — the GPU unless the caller asks for the CPU —
    and go through ``sign_project.sign_project``: the CUDA kernel on the
    card at any N and D (``repro``'s off-tile oracle fallback has no
    counterpart here), its plain version on the CPU."""
    dev = resolve_device(device)
    return _sign_project(_f32(z, dev), _f32(R, dev))


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):   # a copy: numpy inputs may be read-only
        x = torch.from_numpy(np.array(x, np.float32))
    return x.to(device=device, dtype=torch.float32).contiguous()
