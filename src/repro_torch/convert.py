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

from .core.bridge import FrozenProxy
from .core.encoder import Encoder
from .core.events import EventBatch
from .core.item_memory import ItemMemory, build_item_memory
from .core.pipeline import TorrState
from .core.query_cache import CacheState
from .core.types import TorrConfig
from .serving.reranker import RerankerParams, RerankerState

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


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def event_batch_from_numpy(x, y, t, p, count) -> EventBatch:
    """A padded event window from its five leaves."""
    def i32(a):
        return torch.from_numpy(np.array(a, np.int32))

    return EventBatch(x=i32(x), y=i32(y), t=_f32(t), p=i32(p),
                      count=i32(count))


def encoder_from_numpy(conv1, conv2, head, head_b) -> Encoder:
    """The encoder from ``repro``'s weights (convolutions HWIO -> OIHW)."""
    return Encoder(conv1=_f32(conv1).permute(3, 2, 0, 1).contiguous(),
                   conv2=_f32(conv2).permute(3, 2, 0, 1).contiguous(),
                   head=_f32(head), head_b=_f32(head_b))


def encoder_to_numpy(tensors) -> dict:
    """The inverse of :func:`encoder_from_numpy` for a mapping of the
    encoder's four tensors (its parameters, their gradients): numpy in
    ``repro``'s layout (convolutions OIHW -> HWIO)."""
    out = {k: v.detach().cpu().numpy() for k, v in tensors.items()}
    for k in ("conv1", "conv2"):
        out[k] = np.ascontiguousarray(out[k].transpose(2, 3, 1, 0))
    return out


def frozen_proxy_from_numpy(w1, w2) -> FrozenProxy:
    return FrozenProxy(w1=_f32(w1), w2=_f32(w2))


def reranker_params_from_numpy(R, task_w, concept_map,
                               alpha) -> RerankerParams:
    """Reranker parameters; ``concept_map`` [M, V] or None (identity)."""
    return RerankerParams(
        R=_f32(R), task_w=_f32(task_w),
        concept_map=None if concept_map is None else _f32(concept_map),
        alpha=_f32(alpha))


def reranker_state_from_numpy(prev_q, prev_s, valid) -> RerankerState:
    """Reranker state; ``prev_q``'s uint32 words become int32 bit
    patterns."""
    return RerankerState(
        prev_q=words_from_numpy(prev_q), prev_s=_f32(prev_s),
        valid=torch.from_numpy(np.array(valid, bool)))


# ---------------------------------------------------------------------------
# The LM (models/): the reference's parameter pytree stacks each pattern
# position's layers along a group axis; the port keeps a module a layer
# ---------------------------------------------------------------------------

def _lm_path(name: str) -> tuple[tuple, int | None]:
    """A port parameter's name -> (the reference's path, the index along
    the stacked axis, or None for an unstacked leaf)."""
    parts = name.split(".")
    if parts[0] == "groups":                # groups.<g>.<kind>_<i>.<rest>
        return ("groups", *parts[2:]), int(parts[1])
    if parts[0] == "dense_prefix":          # dense_prefix.<j>.<rest>
        return ("dense_prefix", *parts[2:]), int(parts[1])
    return tuple(parts), None


def _np_float(t: torch.Tensor) -> np.ndarray:
    """A float tensor as numpy, bfloat16 widened to float32 (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _lm_tree(named, leaf) -> dict:
    """Named per-layer tensors (the port's ``named_parameters()``, or a
    flat dict's items with those names) in the reference's nested layout,
    each leaf ``leaf(tensors, stacked)`` of its layers' tensors in layer
    order."""
    layers: dict = {}
    for name, t in named:
        path, idx = _lm_path(name)
        layers.setdefault(path, (idx is not None, []))[1].append((idx, t))
    out: dict = {}
    for path, (stacked, ts) in layers.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        ts = sorted(ts, key=lambda it: it[0]) if stacked else ts
        node[path[-1]] = leaf([t for _, t in ts], stacked)
    return out


def _stack_np(ts, stacked):
    return np.stack([_np_float(t) for t in ts]) if stacked \
        else _np_float(ts[0])


def _lm_flat_from_tree(names, tree: dict) -> dict:
    """``{name: float32 tensor}`` for the port's parameter ``names`` from
    the reference's nested tree (the group axis split), on the CPU."""
    out = {}
    for name in names:
        path, idx = _lm_path(name)
        node = tree
        for key in path:
            node = node[key]
        a = np.asarray(node if idx is None else node[idx], np.float32)
        out[name] = torch.from_numpy(a.copy())
    return out


def lm_params_from_numpy(cfg, tree: dict):
    """The reference's LM parameter pytree (nested dicts of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) -> the port's
    ``transformer`` parameters on the CPU: the group axis split into
    layers, each leaf cast to the port's dtype for it (bfloat16 arrays
    arrive exactly through float32)."""
    from .models import transformer as tf

    params = tf.init_params(cfg, device="meta").to_empty(device="cpu")
    flat = _lm_flat_from_tree([n for n, _ in params.named_parameters()],
                              tree)
    with torch.no_grad():
        for name, param in params.named_parameters():
            if flat[name].shape != param.shape:
                raise ValueError(f"{'/'.join(_lm_path(name)[0])}: "
                                 f"{tuple(flat[name].shape)}, the port's "
                                 f"{tuple(param.shape)}")
            param.copy_(flat[name])
    return params


def lm_params_to_numpy(params) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: the reference's nested
    layout with the layers stacked along the group axis (bfloat16 leaves
    as float32)."""
    return _lm_tree(params.named_parameters(), _stack_np)


def lm_grads_to_numpy(grads: dict) -> dict:
    """A flat dict of the port's per-layer tensors (gradients, moments or
    parameters of the train step, keyed as ``Params.state_dict()``) ->
    the reference's nested layout, the layers stacked along the group axis
    (bfloat16 as float32)."""
    return _lm_tree(grads.items(), _stack_np)


def lm_opt_state_from_numpy(cfg, opt: dict) -> dict:
    """The reference's AdamW state ``{"mu": tree, "nu": tree, "step": []}``
    (numpy leaves) -> the port's train-step state on the CPU: ``mu`` and
    ``nu`` flat dicts of float32 tensors keyed as the port's parameters
    (each stacked leaf split per layer, as :func:`lm_params_from_numpy`
    splits the parameters), ``step`` an int32 scalar tensor."""
    from .models import transformer as tf

    names = [n for n, _ in tf.init_params(cfg, device="meta")
             .named_parameters()]
    return {"mu": _lm_flat_from_tree(names, opt["mu"]),
            "nu": _lm_flat_from_tree(names, opt["nu"]),
            "step": torch.tensor(int(np.asarray(opt["step"])),
                                 dtype=torch.int32)}


def lm_param_specs(params) -> dict:
    """{reference path "a/b/c": (shape, dtype name)} of the port's
    parameters in the reference's stacked layout, read from shapes alone
    (so a model on ``meta`` gives it without allocating)."""
    tree = _lm_tree(params.named_parameters(), lambda ts, stacked: (
        ((len(ts),) if stacked else ()) + tuple(ts[0].shape),
        str(ts[0].dtype).removeprefix("torch.")))
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = v

    walk(tree, ())
    return flat


# decode-cache leaves the reference keeps in float32 (recurrent states,
# int8 scales) or in int8 (the int8 codes), by their key; every other float
# leaf is in the model's dtype
_F32_LEAVES = frozenset({"h", "C", "n", "m", "c", "ks", "vs", "s"})
_INT8_LEAVES = frozenset({"kq", "vq", "q"})


def lm_cache_from_numpy(cfg, cache: dict) -> dict:
    """The reference's decode cache (a dict of numpy arrays, tuples and
    dicts of them) -> the port's on the CPU: each leaf in the reference's
    dtype for it (the int8 codes int8, the recurrent states and int8
    scales float32, the rest the config's dtype), ``pos`` an int32 scalar
    tensor."""
    from .models.transformer import _dtype

    dt = _dtype(cfg)

    def leaf(a, key):
        if isinstance(a, tuple):
            return tuple(leaf(x, key) for x in a)
        if isinstance(a, dict):
            return {k: leaf(v, k) for k, v in a.items()}
        if key in _INT8_LEAVES:
            return torch.from_numpy(np.array(a, np.int8))
        t = torch.from_numpy(np.array(a, np.float32))
        return t if key in _F32_LEAVES else t.to(dt)

    return {k: (torch.tensor(int(np.asarray(v)), dtype=torch.int32)
                if k == "pos" else leaf(v, k)) for k, v in cache.items()}


def lm_cache_to_numpy(cache: dict) -> dict:
    """A copy of the port's decode cache as numpy, in the reference's
    layout (bfloat16 leaves as float32, int8 codes as int8): decode updates
    the cache in place, so the arrays never share its memory."""
    def leaf(t):
        if isinstance(t, tuple):
            return tuple(leaf(x) for x in t)
        if isinstance(t, dict):
            return {k: leaf(v) for k, v in t.items()}
        return np.array(_np_float(t) if t.is_floating_point()
                        else t.detach().cpu().numpy())

    return {k: leaf(v) for k, v in cache.items()}


def to_numpy(x, *, words: bool = False):
    """Tensor -> numpy (uint32 view when ``words``); a dataclass of tensors
    -> a dict of numpy arrays, packed-word leaves as uint32."""
    if dataclasses.is_dataclass(x):
        return {f.name: to_numpy(getattr(x, f.name),
                                 words=f.name in ("packed", "pmajor",
                                                  "q_packed", "prev_q"))
                for f in dataclasses.fields(x)}
    a = x.detach().cpu().numpy()
    return a.view(np.uint32) if words else a
