"""Banked, bit-sliced item memory (port of ``repro.core.item_memory``).

Four coherent views, each matched to an access pattern:

  * ``bipolar``  int8  [M, D]   — source of truth
  * ``packed``   int32 [M, D/32] — full-scan XNOR-popcount path; banks are
    contiguous word ranges, so D' gating is a prefix of words
  * ``pmajor``   int32 [M, D/32] — the packed words reordered bit-plane-major
    (word w belongs to plane ``w % bit_planes``; plane blocks contiguous)
  * ``dmajor``   int8  [D, M]   — delta path: one flipped dimension reads the
    contiguous row ``dmajor[i, :]``

The dims a (banks, planes) plan enables are exactly
``{d : word(d) < banks * bank_words  and  word(d) % P < planes}``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import hdc
from .types import TorrConfig


@dataclasses.dataclass
class ItemMemory:
    bipolar: torch.Tensor   # int8  [M, D]
    packed: torch.Tensor    # int32 [M, D//32]
    dmajor: torch.Tensor    # int8  [D, M]
    pmajor: torch.Tensor    # int32 [M, D//32] plane-major word order

    @property
    def M(self) -> int:
        return self.bipolar.shape[0]

    @property
    def D(self) -> int:
        return self.bipolar.shape[1]

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def to(self, device) -> "ItemMemory":
        return ItemMemory(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


def plane_permutation(words: int, plane_total: int) -> np.ndarray:
    """Word permutation packed -> plane-major: plane p's words (w % P == p)
    first, ascending within each plane block."""
    order = np.concatenate([
        np.arange(p, words, plane_total) for p in range(plane_total)
    ])
    return order.astype(np.int64)


def plane_sel(limit_words: int, planes: int, plane_total: int) -> np.ndarray:
    """Indices of the enabled words among the first ``limit_words`` packed
    words, keeping ``planes`` of ``plane_total`` planes, plane-major."""
    sel = np.concatenate([
        np.arange(p, limit_words, plane_total) for p in range(planes)
    ])
    return sel.astype(np.int64)


def plan_word_sel(cfg: TorrConfig, banks: int, planes: int) -> np.ndarray:
    """Enabled-word indices for a (banks, planes) plan, plane-major: the
    column order of the host-latched wrappers in ``kernels.ops``."""
    return plane_sel(banks * cfg.bank_words, planes, cfg.bit_planes)


def bank_plane_sel(cfg: TorrConfig, banks: int, planes: int) -> np.ndarray:
    """Enabled-word indices for a (banks, planes) plan in *bank-major* order
    (bank 0's enabled words first, plane-major inside each bank): the column
    order of the bank-prefix kernel, where every bank's enabled words form a
    contiguous run."""
    return np.concatenate([
        np.arange(b * cfg.bank_words + p, (b + 1) * cfg.bank_words,
                  cfg.bit_planes)
        for b in range(banks)
        for p in range(planes)
    ]).astype(np.int64)


def pmajor_bank_blocks(pmajor: torch.Tensor, cfg: TorrConfig, banks: int,
                       planes: int) -> torch.Tensor:
    """The (banks, planes) plan's enabled item-memory words in the bank-major
    column order of :func:`bank_plane_sel`, assembled from contiguous slices
    of the ``pmajor`` view. int32 [M, banks * planes * plane_words]."""
    wpb = pmajor.shape[-1] // cfg.bit_planes      # words per plane block
    bpw = cfg.plane_words                         # bank's words per plane
    return torch.cat([
        pmajor[..., p * wpb + b * bpw: p * wpb + (b + 1) * bpw]
        for b in range(banks)
        for p in range(planes)
    ], dim=-1)


def build_item_memory(bipolar: torch.Tensor, plane_total: int = 4) -> ItemMemory:
    """Derive all access-pattern views from bipolar codes [M, D].

    ``plane_total`` must match the consuming config's ``bit_planes``; a grain
    that does not divide the word count is an error."""
    bipolar = bipolar.to(torch.int8)
    packed = hdc.pack_bits(bipolar)
    words = packed.shape[-1]
    if words % plane_total:
        raise ValueError(
            f"plane_total={plane_total} does not divide the packed word "
            f"count {words} (D={32 * words})")
    perm = torch.as_tensor(plane_permutation(words, plane_total),
                           device=packed.device)
    return ItemMemory(
        bipolar=bipolar,
        packed=packed,
        dmajor=bipolar.T.contiguous(),
        pmajor=packed[:, perm].contiguous(),
    )


def item_memory_from_prototypes(feats: torch.Tensor, R: torch.Tensor,
                                tie: torch.Tensor | None = None,
                                plane_total: int = 4) -> ItemMemory:
    """Class prototypes: bundle sign-projected examples per class.

    ``feats`` is [M, n_examples, d]; ``R`` the [D, d] projection. This is how
    the item memory is *trained* from encoder features so that the
    associative aligner realizes the CLIP-transferred semantics. ``tie``
    (bipolar [M, D], or None) breaks each class's zero-sum dimensions; it
    stands for ``repro``'s keyed bundle, whose bits come from
    ``jax.random`` and so are drawn outside the port. Without it a zero sum
    bundles to +1, as ``repro`` does with ``key=None``."""
    hv = hdc.sign_project(feats, R)                        # [M, n, D]
    s = torch.sum(hv.to(torch.int32), dim=1, dtype=torch.int32)
    if tie is not None:
        s = torch.where(s == 0, tie.to(torch.int32), s)
    bundled = torch.where(s >= 0, 1, -1).to(torch.int8)
    return build_item_memory(bundled, plane_total=plane_total)


def _index(banks, device):
    """(banks as an int64 tensor, its device)."""
    if isinstance(banks, torch.Tensor):
        return banks.to(torch.int64), banks.device
    return torch.tensor(banks, dtype=torch.int64, device=device), device


def word_mask(cfg: TorrConfig, banks, device=None) -> torch.Tensor:
    """Boolean mask [..., D//32] of packed words enabled by ``banks`` banks
    (``banks`` may carry leading axes)."""
    banks, device = _index(banks, device)
    words_eff = banks * cfg.bank_words
    ar = torch.arange(cfg.words, dtype=torch.int64, device=device)
    return ar < words_eff[..., None]


def plan_word_mask(cfg: TorrConfig, banks, planes: int,
                   device=None) -> torch.Tensor:
    """Boolean mask [..., D//32] of words enabled by a (banks, planes) plan;
    with all planes kept it is :func:`word_mask`."""
    wm = word_mask(cfg, banks, device)
    if planes >= cfg.bit_planes:
        return wm
    plane_of = torch.arange(cfg.words, device=wm.device) % cfg.bit_planes
    return torch.logical_and(wm, plane_of < planes)


def dim_mask(cfg: TorrConfig, banks, device=None) -> torch.Tensor:
    """Boolean mask [..., D] of dimensions enabled by ``banks`` banks."""
    banks, device = _index(banks, device)
    d_eff = banks * cfg.bank_dims
    ar = torch.arange(cfg.D, dtype=torch.int64, device=device)
    return ar < d_eff[..., None]


def plan_dim_mask(cfg: TorrConfig, banks, planes: int,
                  device=None) -> torch.Tensor:
    """Boolean mask [..., D] of dimensions enabled by a (banks, planes)
    plan: the oracle-side statement of the plan (tests mask bipolar dims
    with it)."""
    dm = dim_mask(cfg, banks, device)
    if planes >= cfg.bit_planes:
        return dm
    word_of = torch.arange(cfg.D, device=dm.device) // 32
    return torch.logical_and(dm, (word_of % cfg.bit_planes) < planes)
