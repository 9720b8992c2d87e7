"""Depth-K query cache with per-entry per-class accumulators (port of
``repro.core.query_cache``; paper Fig. 4).

Each entry carries the packed query (for the PSU's nearest match + XOR), the
integer per-class accumulator and the plan tag it was computed under, the
cached final output scores (aggressive bypass), the aligner top-k key and
margin of the last window (reasoner gating), and age/validity for LRU.
Functions take an optional leading stream axis ``[S]`` on every leaf; the
slot and per-query arguments then carry ``[S]`` too.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from . import hdc
from .item_memory import plan_word_mask
from .types import TorrConfig, map_tensors

INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class CacheState:
    packed: torch.Tensor    # int32 [K, D//32] cached queries
    acc: torch.Tensor       # int32 [K, M] per-class dot accumulators
    acc_tag: torch.Tensor   # int32 [K] plan tag (banks, planes) for acc
    out: torch.Tensor       # f32   [K, M] cached final (post-reasoner) scores
    topk_key: torch.Tensor  # int32 [K, top_k] aligner top-k indices
    margin: torch.Tensor    # f32   [K] aligner top-1/top-2 margin
    age: torch.Tensor       # int32 [K]
    valid: torch.Tensor     # bool  [K]


def init_cache(cfg: TorrConfig, device=None) -> CacheState:
    """An empty depth-K cache on ``device`` (the card unless the caller
    asks for the CPU)."""
    K = cfg.K
    device = resolve_device(device)
    return CacheState(
        packed=torch.zeros((K, cfg.words), dtype=torch.int32, device=device),
        acc=torch.zeros((K, cfg.M), dtype=torch.int32, device=device),
        acc_tag=torch.zeros((K,), dtype=torch.int32, device=device),
        out=torch.zeros((K, cfg.M), dtype=torch.float32, device=device),
        topk_key=torch.full((K, cfg.top_k), -1, dtype=torch.int32,
                            device=device),
        margin=torch.zeros((K,), dtype=torch.float32, device=device),
        age=torch.full((K,), INT32_MAX // 2, dtype=torch.int32,
                       device=device),
        valid=torch.zeros((K,), dtype=torch.bool, device=device),
    )


def init_cache_batch(cfg: TorrConfig, n_streams: int,
                     device=None) -> CacheState:
    """Stacked per-stream caches: every leaf gains a leading [S] axis."""
    one = init_cache(cfg, device)
    return map_tensors(
        lambda x: x[None].repeat(n_streams, *([1] * x.dim())), one)


def reset_slot(cache: CacheState, cfg: TorrConfig, slot: int) -> CacheState:
    """Invalidate one stream slot of a stacked cache (stream admit/retire)."""
    fresh = init_cache(cfg, cache.packed.device)
    new = map_tensors(torch.clone, cache)
    for f in dataclasses.fields(CacheState):
        getattr(new, f.name)[slot] = getattr(fresh, f.name)
    return new


def _set_rows(x: torch.Tensor, slot: torch.Tensor, value) -> torch.Tensor:
    """Copy of ``x`` with row ``slot`` of each stream set to ``value``. A
    Python scalar becomes a tensor by a fill on ``x``'s device, so no host
    data enters the step's captured segments."""
    y = x.clone()
    if not isinstance(value, torch.Tensor):
        value = torch.full((), value, dtype=x.dtype, device=x.device)
    if slot.dim() == 0:
        y[slot] = value
    else:
        y[torch.arange(slot.shape[0], device=x.device), slot] = value
    return y


def nearest(cache: CacheState, q_packed: torch.Tensor, cfg: TorrConfig,
            banks, planes: int | None = None):
    """Nearest cached query over the dims a (banks, planes) plan enables.

    Returns (idx int32, rho f32 per Eq. 5, hamming int32), each [...] for
    queries [..., W]. Invalid entries are pushed to rho = -inf; the first
    maximum wins ties (``torch.argmax``, like ``jnp.argmax``)."""
    planes = cfg.bit_planes if planes is None else planes
    banks = torch.as_tensor(banks, device=q_packed.device)
    wmask = plan_word_mask(cfg, banks, planes)
    xor = cache.packed ^ q_packed[..., None, :]                  # [..., K, W]
    pc = torch.where(wmask[..., None, :], hdc.popcount32(xor), 0)
    ham = torch.sum(pc, dim=-1, dtype=torch.int32)                # [..., K]
    d_eff = cfg.d_eff_planned(banks.to(torch.int32), planes).to(torch.float32)
    rho = 1.0 - 2.0 * ham.to(torch.float32) / d_eff[..., None]    # Eq. 5
    rho = torch.where(cache.valid, rho, float("-inf"))
    idx = torch.argmax(rho, dim=-1)
    rho_i = torch.gather(rho, -1, idx[..., None])[..., 0]
    ham_i = torch.gather(ham, -1, idx[..., None])[..., 0]
    return idx.to(torch.int32), rho_i, ham_i


def hamming_all(cache, q_packed_all: torch.Tensor, cfg: TorrConfig, banks,
                planes: int | None = None) -> torch.Tensor:
    """Masked hamming of every query against every cache entry: int32
    [..., N, K] under the (banks, planes) plan's word mask — one batched
    lookup pass in place of N per-proposal :func:`nearest` scans. Reads
    only ``packed``, so it takes a :class:`CacheState` or a
    :class:`MetaCache`; the sums equal :func:`nearest`'s."""
    from . import aligner

    planes = cfg.bit_planes if planes is None else planes
    wmask = plan_word_mask(cfg, torch.as_tensor(banks,
                                                device=q_packed_all.device),
                           planes)
    return aligner.lookup_hamming_all(q_packed_all, cache.packed, wmask)


def nearest_all(cache, q_packed_all: torch.Tensor, cfg: TorrConfig, banks,
                planes: int | None = None):
    """Batched :func:`nearest`: (idx [..., N], rho [..., N], ham [..., N])
    of every query against one frozen cache snapshot (no intra-window
    updates). The same integers, the same Eq. 5 float32 expression and the
    same first-maximum ties as :func:`nearest` per row."""
    planes = cfg.bit_planes if planes is None else planes
    banks = torch.as_tensor(banks, device=q_packed_all.device)
    ham = hamming_all(cache, q_packed_all, cfg, banks, planes)
    d_eff = cfg.d_eff_planned(banks.to(torch.int32),
                              planes).to(torch.float32)
    rho = 1.0 - 2.0 * ham.to(torch.float32) / d_eff[..., None, None]
    rho = torch.where(cache.valid[..., None, :], rho, float("-inf"))
    idx = torch.argmax(rho, dim=-1)
    rho_i = torch.gather(rho, -1, idx[..., None])[..., 0]
    ham_i = torch.gather(ham, -1, idx[..., None])[..., 0]
    return idx.to(torch.int32), rho_i, ham_i


def lru_slot(cache: CacheState) -> torch.Tensor:
    """Slot to evict: first invalid entry, else the oldest."""
    score = torch.where(cache.valid, cache.age, INT32_MAX)
    return torch.argmax(score, dim=-1).to(torch.int32)


def write_entry(cache: CacheState, slot: torch.Tensor, *, packed, acc,
                acc_tag, out, topk_key, margin) -> CacheState:
    """Write/refresh one entry and rejuvenate it; everyone else ages."""
    slot = slot.to(torch.int64)
    age = _set_rows(cache.age + 1, slot, 0)
    return CacheState(
        packed=_set_rows(cache.packed, slot, packed),
        acc=_set_rows(cache.acc, slot, acc),
        acc_tag=_set_rows(cache.acc_tag, slot,
                          torch.as_tensor(acc_tag).to(torch.int32)),
        out=_set_rows(cache.out, slot, out),
        topk_key=_set_rows(cache.topk_key, slot, topk_key),
        margin=_set_rows(cache.margin, slot, margin),
        age=age,
        valid=_set_rows(cache.valid, slot, True),
    )


@dataclasses.dataclass
class MetaCache:
    """The decision-relevant slice of :class:`CacheState`: everything later
    path decisions in the same window can observe (packed queries, plan
    tags, age, validity) and nothing else. The compact dispatch's decide
    pass carries this view so the [K, M] value arrays never ride its loop.
    :func:`nearest` and :func:`lru_slot` take it in place of a
    :class:`CacheState`."""

    packed: torch.Tensor    # int32 [K, D//32]
    acc_tag: torch.Tensor   # int32 [K]
    age: torch.Tensor       # int32 [K]
    valid: torch.Tensor     # bool  [K]


def meta_view(cache: CacheState) -> MetaCache:
    return MetaCache(packed=cache.packed, acc_tag=cache.acc_tag,
                     age=cache.age, valid=cache.valid)


def meta_touch(meta: MetaCache, slot: torch.Tensor) -> MetaCache:
    """Metadata image of :func:`touch`: rejuvenate, content untouched."""
    age = _set_rows(meta.age + 1, slot.to(torch.int64), 0)
    return dataclasses.replace(meta, age=age)


def meta_write(meta: MetaCache, slot: torch.Tensor, *, packed,
               acc_tag) -> MetaCache:
    """Metadata image of :func:`write_entry`: refresh one entry's packed
    query and plan tag and rejuvenate it (everyone else ages), without the
    value fields the decide pass cannot know yet. The two must stay
    update-for-update identical or the decide and apply passes diverge."""
    slot = slot.to(torch.int64)
    return MetaCache(
        packed=_set_rows(meta.packed, slot, packed),
        acc_tag=_set_rows(meta.acc_tag, slot,
                          torch.as_tensor(acc_tag).to(torch.int32)),
        age=_set_rows(meta.age + 1, slot, 0),
        valid=_set_rows(meta.valid, slot, True),
    )


def touch(cache: CacheState, slot: torch.Tensor) -> CacheState:
    """Bypass hit: rejuvenate the entry without modifying its contents."""
    age = _set_rows(cache.age + 1, slot.to(torch.int64), 0)
    return dataclasses.replace(cache, age=age)
