"""Carry state across from the JAX package as numpy arrays.

The JAX package's objects reach this module as numpy arrays (for example
``np.asarray`` of each leaf); the functions return the port's objects.
uint32 packed words become int32 tensors with the same bit patterns
(``np.ndarray.view(np.int32)``); :func:`to_numpy` is the inverse view for
comparisons. Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.item_memory import ItemMemory, build_item_memory
from .core.pipeline import TorrState
from .core.query_cache import CacheState
from .core.types import TorrConfig

CACHE_FIELDS = tuple(f.name for f in dataclasses.fields(CacheState))


def words_from_numpy(words: np.ndarray) -> torch.Tensor:
    """uint32 (or int32) packed words -> int32 tensor, bit for bit."""
    words = np.ascontiguousarray(words)
    if words.dtype == np.uint32:
        words = words.view(np.int32)
    if words.dtype != np.int32:
        raise TypeError(f"packed words must be uint32 or int32, got "
                        f"{words.dtype}")
    return torch.from_numpy(words.copy())


def item_memory_from_numpy(bipolar: np.ndarray,
                           plane_total: int = 4) -> ItemMemory:
    """Item memory rebuilt from the bipolar int8 codes [M, D]."""
    return build_item_memory(torch.from_numpy(np.array(bipolar, np.int8)),
                             plane_total=plane_total)


def item_memory_views_from_numpy(packed, dmajor, pmajor,
                                 bipolar) -> ItemMemory:
    """Item memory taking every view as given (no rebuild)."""
    return ItemMemory(
        bipolar=torch.from_numpy(np.asarray(bipolar, np.int8).copy()),
        packed=words_from_numpy(packed),
        dmajor=torch.from_numpy(np.asarray(dmajor, np.int8).copy()),
        pmajor=words_from_numpy(pmajor),
    )


def cache_state_from_numpy(packed, acc, acc_tag, out, topk_key, margin, age,
                           valid) -> CacheState:
    """A (possibly stacked) query cache from its eight leaves."""
    return CacheState(
        packed=words_from_numpy(packed),
        acc=torch.from_numpy(np.asarray(acc, np.int32).copy()),
        acc_tag=torch.from_numpy(np.asarray(acc_tag, np.int32).copy()),
        out=torch.from_numpy(np.asarray(out, np.float32).copy()),
        topk_key=torch.from_numpy(np.asarray(topk_key, np.int32).copy()),
        margin=torch.from_numpy(np.asarray(margin, np.float32).copy()),
        age=torch.from_numpy(np.asarray(age, np.int32).copy()),
        valid=torch.from_numpy(np.asarray(valid, bool).copy()),
    )


def torr_state_from_numpy(cache: dict, task_weights) -> TorrState:
    """Pipeline state from a mapping of cache leaves and the task weights."""
    return TorrState(
        cache=cache_state_from_numpy(**{k: cache[k] for k in CACHE_FIELDS}),
        task_weights=torch.from_numpy(
            np.asarray(task_weights, np.float32).copy()))


def system_from_numpy(R, codes, task_w, *, cfg: TorrConfig, graph=None):
    """A TOOD system from the JAX system's projection, bipolar concept codes
    and task weights (``graph`` is optional: serving never reads it)."""
    from .serving.tood_pipelines import TorrSystem

    return TorrSystem(cfg=cfg, R=np.asarray(R, np.float32),
                      im=item_memory_from_numpy(codes, cfg.bit_planes),
                      task_w=np.asarray(task_w, np.float32), graph=graph)


def to_numpy(x, *, words: bool = False):
    """Tensor -> numpy (uint32 view when ``words``); a dataclass of tensors
    -> a dict of numpy arrays, packed-word leaves as uint32."""
    if dataclasses.is_dataclass(x):
        return {f.name: to_numpy(getattr(x, f.name),
                                 words=f.name in ("packed", "pmajor",
                                                  "q_packed"))
                for f in dataclasses.fields(x)}
    a = x.detach().cpu().numpy()
    return a.view(np.uint32) if words else a
