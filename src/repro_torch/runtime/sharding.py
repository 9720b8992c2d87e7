"""Sharding rules: DP / TP / EP / SP over a ``DeviceMesh`` (port of the
parameter, batch and cache half of ``repro.runtime.sharding``).

Parameters follow Megatron-style column/row parallelism over the 'model'
axis; MoE experts are expert-parallel over 'model'; batch shards over
('pod', 'data'). Decode caches pick, per tensor, the best shardable axis:
KV heads when divisible by the model-axis size, else sequence (flash-decode
style), else head_dim, so every (arch x shape) cell partitions without
padding.

A spec is the reference's ``PartitionSpec`` as a tuple: one entry a tensor
dim, each an axis name, a tuple of axis names or None. Rules are
*name-based on the trailing dims* and padded with leading Nones. The
reference stacks each pattern position's layers along a leading axis
(``groups/self_0/attn/wq`` [G, d, H*dh]); the port keeps a tensor a layer
(``groups.0.self_0.attn.wq`` [d, H*dh]), so a port leaf's spec is the
reference's spec of the stacked leaf with the stacked dim removed
(:func:`param_spec` computes it on the stacked rank). The decode cache keeps
the reference's stacked layout, so its specs are the reference's as they
are.

A mesh here is anything with ``mesh_dim_names`` and ``shape`` (a
``torch.distributed.device_mesh.DeviceMesh``); only the axis sizes are read.
:func:`placements` turns a spec into DTensor placements (``Shard(dim)`` on
each mesh axis that names a dim, ``Replicate()`` elsewhere) and
:func:`distribute` places a tree with ``distribute_tensor``.

The stream half (the reference's ``stream_mesh`` and the stacked
per-stream serving state) shards the multi-stream engine's leading slot
axis over a :class:`StreamMesh`, a 1-D list of devices, and replicates
the item memory. Streams are independent, so the port needs no DTensor
there: :func:`split_streams` gives each device its own rows as plain
tensors and :func:`join_streams` puts them back together
(``serving.async_engine`` runs one step on every shard).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

# trailing-dims spec per parameter leaf name
_COL = (None, "model")     # [in, out_sharded]
_ROW = ("model", None)     # [in_sharded, out]

_PARAM_RULES: dict[str, tuple] = {
    # embeddings
    "embed": ("model", None),        # [V, d] vocab-sharded
    "unembed": (None, "model"),
    # attention & projections (column-parallel)
    "wq": _COL, "wk": _COL, "wv": _COL,
    "wq_a": (None, None), "wq_b": _COL,
    "wkv_a": (None, None), "wk_b": _COL, "wv_b": _COL,
    # row-parallel outputs
    "wo": _ROW, "w_down": _ROW, "w_out": _ROW,
    # MLPs / recurrent branches (column-parallel)
    "w_gate": _COL, "w_up": _COL, "w_z": _COL,
    "w_gate_in": _COL, "w_in": _COL, "w_ifzo": _COL,
    "w_up_gate": _COL,
    "shared_gate": _COL, "shared_up": _COL, "shared_down": _ROW,
    # gates / small
    "router": (None, None), "w_if": (None, None), "proj": (None, None),
    "wa": _COL, "wx": _COL,
    "conv_w": (None, "model"),
    "lam": ("model",), "gn_scale": ("model",),
    "r_ifzo": (None, None, None),
    "head": (None, None), "head_b": (None,),
}

# MoE expert stacks: leading experts dim is expert-parallel
_MOE_EXPERT_RULES = {
    "w_gate": ("model", None, None),
    "w_up": ("model", None, None),
    "w_down": ("model", None, None),
}

# the subtrees whose layers the reference stacks along a leading axis
STACKED = ("groups", "dense_prefix")

Spec = tuple


# ---------------------------------------------------------------------------
# Trees: nested dicts (flat dicts keyed "a.b.c" split at the dots), tuples
# and lists of tensors (or anything with ``shape``)
# ---------------------------------------------------------------------------

def _path_of(key) -> tuple:
    return tuple(key.split(".")) if isinstance(key, str) else (key,)


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over ``tree``; a dict key "a.b" is the path
    components ("a", "b"), a sequence index an int component."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + _path_of(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map_with_path(fn, getattr(tree, f.name),
                                       path + (f.name,))
            for f in dataclasses.fields(tree)})
    return fn(path, tree)


def _names(path) -> list[str]:
    return [str(e) for e in path if isinstance(e, str)]


def n_stacked(path) -> int:
    """1 where the reference stacks the leaf's layers (a ``groups.<g>`` or
    ``dense_prefix.<j>`` path), else 0."""
    for a, b in zip(path, path[1:]):
        if a in STACKED and str(b).isdigit():
            return 1
    return 0


def sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_spec(path, leaf) -> Spec:
    """The spec of a parameter (or an optimizer moment) at ``path``."""
    names = _names(path)
    name = names[-1] if names else ""
    rules = _MOE_EXPERT_RULES if "moe" in names and \
        name in _MOE_EXPERT_RULES else _PARAM_RULES
    if name not in rules:
        return ()
    trailing = rules[name]
    stack = n_stacked(path)
    pad = len(leaf.shape) + stack - len(trailing)
    if pad < 0:   # e.g. a 1-D leaf hitting a 2-D rule; replicate
        return ()
    full = (None,) * pad + tuple(trailing)
    if any(a is not None for a in full[:stack]):
        raise ValueError(f"{'.'.join(names)}: the rule {trailing} shards "
                         "the stacked layer axis")
    return full[stack:]


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _drop_indivisible(spec: Spec, leaf, mesh) -> Spec:
    """Replace any sharded dim the leaf's shape can't divide with None."""
    sz = sizes(mesh)
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        size = 1
        for a in _axes(entry):
            size *= sz[a]
        out.append(entry if leaf.shape[dim] % size == 0 else None)
    return tuple(out)


def params_pspecs(params, mesh=None) -> Any:
    """The tree of specs of a parameter tree (a flat dict keyed as
    ``Params.state_dict()``, an AdamW state, or any nested dict of
    tensors); with a mesh, indivisible dims are replicated."""
    if mesh is None:
        return tree_map_with_path(param_spec, params)
    return tree_map_with_path(
        lambda p, l: _drop_indivisible(param_spec(p, l), l, mesh), params)


# ---------------------------------------------------------------------------
# Activations / batches / caches
# ---------------------------------------------------------------------------

def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _entry(axes: tuple):
    """A spec entry of ``axes``: one axis as its name (``PartitionSpec``
    keeps ("data",) so)."""
    return axes[0] if len(axes) == 1 else axes


def _divisible(n: int, mesh, axes) -> bool:
    sz = sizes(mesh)
    size = 1
    for a in _axes(axes):
        size *= sz[a]
    return n % size == 0 and n >= size


def batch_spec(mesh, leaf) -> Spec:
    """Tokens/labels/vision: shard dim0 over (pod, data) when divisible."""
    nd = len(leaf.shape)
    ba = batch_axes(mesh)
    if _divisible(leaf.shape[0], mesh, ba):
        return (_entry(ba),) + (None,) * (nd - 1)
    if _divisible(leaf.shape[0], mesh, "data"):
        return ("data",) + (None,) * (nd - 1)
    return (None,) * nd


def batch_pspecs(batch, mesh) -> Any:
    return tree_map_with_path(lambda p, l: batch_spec(mesh, l), batch)


def cache_spec(path, leaf, mesh) -> Spec:
    """Decode-cache sharding. Layout conventions (see models.transformer):

    kv        [G(, pos), B, S, Hkv, dh]
    ckv       [G, B, S, r+dr]
    cross_kv  [G, B, Nv, Hkv, dh]
    rec.h     [G, n_rec, B, w]        rec.conv [G, n_rec, B, cw, w]
    mlstm.C   [G, n_m, B, H, dh, dh]  mlstm.n [G, n_m, B, H, dh]
    mlstm.m   [G, n_m, B, H]          mlstm.conv [G, n_m, B, cw, din]
    slstm.*   [G, B, d] / [G, B, H]
    """
    names = _names(path)
    if not names:
        return ()
    top = names[0]
    shape = leaf.shape
    nd = len(shape)
    spec: list = [None] * nd
    msize = sizes(mesh)["model"]

    def shard_batch(dim):
        ba = batch_axes(mesh)
        if _divisible(shape[dim], mesh, ba):
            spec[dim] = _entry(ba)
        elif _divisible(shape[dim], mesh, "data"):
            spec[dim] = "data"

    if top == "pos":
        return ()
    leafname = names[-1]
    if top in ("kv", "cross_kv"):
        if leafname in ("ks", "vs"):      # int8-cache scales: [.., B, S, Hkv]
            b_dim, s_dim, h_dim = nd - 3, nd - 2, nd - 1
            shard_batch(b_dim)
            if shape[h_dim] % msize == 0:
                spec[h_dim] = "model"
            elif top == "kv" and shape[s_dim] % msize == 0:
                spec[s_dim] = "model"
            return tuple(spec)
        # k/v (or kq/vq) trailing dims: [B, S, Hkv, dh]
        b_dim, s_dim, h_dim, d_dim = nd - 4, nd - 3, nd - 2, nd - 1
        shard_batch(b_dim)
        if shape[h_dim] % msize == 0:
            spec[h_dim] = "model"
        elif top == "kv" and shape[s_dim] % msize == 0:
            spec[s_dim] = "model"
        elif shape[d_dim] % msize == 0:
            spec[d_dim] = "model"
        return tuple(spec)
    if top.startswith("ckv"):   # 'ckv' and 'ckv_prefix' (dense-prefix MLA)
        if leafname == "s":               # int8 latent scales [G, B, S]
            b_dim, s_dim = nd - 2, nd - 1
            shard_batch(b_dim)
            if shape[s_dim] % msize == 0:
                spec[s_dim] = "model"
            return tuple(spec)
        b_dim, s_dim = nd - 3, nd - 2
        shard_batch(b_dim)
        if shape[s_dim] % msize == 0:
            spec[s_dim] = "model"
        return tuple(spec)
    if top == "rec":
        shard_batch(nd - 2 if leafname == "h" else nd - 3)
        if shape[nd - 1] % msize == 0:
            spec[nd - 1] = "model"
        return tuple(spec)
    if top == "mlstm":
        if leafname == "C":
            shard_batch(2)
            if shape[4] % msize == 0:
                spec[4] = "model"
        elif leafname in ("n", "conv"):
            shard_batch(2)
            if shape[nd - 1] % msize == 0:
                spec[nd - 1] = "model"
        elif leafname == "m":
            shard_batch(2)
        return tuple(spec)
    if top == "slstm":
        shard_batch(1)
        if leafname != "m" and shape[nd - 1] % msize == 0:
            spec[nd - 1] = "model"
        return tuple(spec)
    return ()


def cache_pspecs(cache, mesh) -> Any:
    return tree_map_with_path(lambda p, l: cache_spec(p, l, mesh), cache)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's place on a mesh: the counterpart of ``NamedSharding``."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec``: ``Shard(d)`` on every mesh axis that
    a tensor dim d names, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e is not None and axis in _axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def params_sharding(params, mesh) -> Any:
    return tree_map_with_path(
        lambda p, l: Sharding(mesh, _drop_indivisible(param_spec(p, l), l,
                                                      mesh)), params)


def batch_sharding(batch, mesh) -> Any:
    return tree_map_with_path(
        lambda p, l: Sharding(mesh, batch_spec(mesh, l)), batch)


def cache_sharding(cache, mesh) -> Any:
    return tree_map_with_path(
        lambda p, l: Sharding(mesh, cache_spec(p, l, mesh)), cache)


def tree_zip_map(fn: Callable, tree, shardings):
    if isinstance(tree, dict):
        return {k: tree_zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_zip_map(fn, v, s)
                          for v, s in zip(tree, shardings))
    return fn(tree, shardings)


def distribute(tree, shardings) -> Any:
    """Each tensor of ``tree`` as a DTensor placed by its :class:`Sharding`
    (``distribute_tensor``: every rank passes the full tensor, rank 0's
    values are scattered; a ``meta`` tensor stays on ``meta``). The local
    tensors never share memory with ``tree``'s (a replicated one would),
    so an in-place step on either leaves the other alone."""
    from torch.distributed.tensor import distribute_tensor

    def place(t, s: Sharding):
        return distribute_tensor(t.detach().clone(), s.mesh, s.placements)

    return tree_zip_map(place, tree, shardings)


def full_tensors(tree) -> Any:
    """The full tensor of every DTensor of ``tree`` (gathered on every
    rank); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    return tree_map_with_path(
        lambda p, t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def abstract_tree(init_fn: Callable, *args, **kwargs):
    """``init_fn(*args, **kwargs, device="meta")``: every tensor with its
    shape and dtype, nothing allocated (the counterpart of
    ``jax.eval_shape``)."""
    return init_fn(*args, **kwargs, device="meta")


# ---------------------------------------------------------------------------
# Multi-stream serving: stacked per-stream state over a 1-D stream mesh
# ---------------------------------------------------------------------------
# The multi-stream engine stacks every per-stream leaf with a leading
# stream-slot axis [S, ...]. Streams are independent (the batched step is
# the window FSM once per slot), so the partitioning is: shard the leading
# S axis, replicate the shared item memory. The engine pads its slot count
# to a multiple of the device count so the leading axis always divides.

STREAM_AXIS = "stream"


class StreamMesh(tuple):
    """A 1-D mesh over the stream axis: a tuple of ``torch.device``s, one a
    shard, read as the reference's engine reads its ``Mesh``
    (``shape[STREAM_AXIS]``, ``devices.size``). A device may appear more
    than once: two shards on one card, or CPU shards."""

    def __new__(cls, devices):
        import torch

        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a stream mesh needs at least one device")
        return super().__new__(cls, devs)

    axis_names = (STREAM_AXIS,)

    @property
    def shape(self) -> dict[str, int]:
        return {STREAM_AXIS: len(self)}

    @property
    def devices(self) -> np.ndarray:
        out = np.empty(len(self), dtype=object)
        out[:] = self
        return out


def stream_mesh(n_devices: int | None = None, devices=None) -> StreamMesh:
    """1-D mesh over (the first) ``n_devices`` CUDA cards (None or 0: all)
    for stream sharding; or over ``devices``, an explicit list (CPU
    shards, or several shards on one card)."""
    if devices is not None:
        return StreamMesh(devices)
    import torch

    m = torch.cuda.device_count()
    n = m if n_devices in (None, 0) else n_devices
    if n > m or n < 1:
        raise ValueError(f"requested {n} devices, only {m} present")
    return StreamMesh(torch.device("cuda", i) for i in range(n))


def pad_stream_slots(n_slots: int, mesh: StreamMesh | None) -> int:
    """Round a slot count up to a multiple of the mesh's stream-axis size."""
    if mesh is None:
        return n_slots
    n_dev = mesh.shape[STREAM_AXIS]
    return -(-n_slots // n_dev) * n_dev


def stream_spec(leaf) -> Spec:
    """Shard the leading stream-slot axis; everything trailing replicated."""
    return (STREAM_AXIS,) + (None,) * (len(leaf.shape) - 1)


def stream_sharding(tree, mesh: StreamMesh) -> Any:
    """:class:`Sharding` tree for stacked per-stream state / batches. Every
    leaf must carry the leading [S] stream axis with S divisible by the
    mesh (guaranteed by :func:`pad_stream_slots`)."""
    return tree_map_with_path(
        lambda p, l: Sharding(mesh, stream_spec(l)), tree)


def replicated_sharding(tree, mesh: StreamMesh) -> Any:
    """Fully replicated :class:`Sharding` tree (the shared item memory)."""
    return tree_map_with_path(lambda p, l: Sharding(mesh, ()), tree)


def stream_rows(n_slots: int, mesh: StreamMesh) -> list[tuple[int, int]]:
    """The slot rows [lo, hi) each shard of ``mesh`` owns."""
    n = len(mesh)
    if n_slots % n:
        raise ValueError(f"{n_slots} slots do not divide over {n} shards; "
                         "pad them with pad_stream_slots")
    per = n_slots // n
    return [(k * per, (k + 1) * per) for k in range(n)]


def split_streams(tree, mesh: StreamMesh) -> list:
    """A stacked [S, ...] tree as one tree per shard of ``mesh``: shard k's
    rows (:func:`stream_rows`) copied to its device, sharing no memory with
    ``tree`` or another shard."""
    leaves = []
    tree_map_with_path(lambda p, l: leaves.append(l), tree)
    if not leaves:
        raise ValueError("split_streams: no tensor in the tree")
    rows = stream_rows(leaves[0].shape[0], mesh)
    return [tree_map_with_path(
        lambda p, l, lo=lo, hi=hi, d=d: l[lo:hi].to(d, copy=True), tree)
        for (lo, hi), d in zip(rows, mesh)]


def join_streams(trees: list, device) -> Any:
    """The per-shard trees of :func:`split_streams` stacked back into one
    [S, ...] tree on ``device``."""
    import torch

    parts = [[] for _ in trees]
    for part, t in zip(parts, trees):
        tree_map_with_path(lambda p, l, part=part: part.append(l), t)
    it = iter(zip(*parts))
    return tree_map_with_path(
        lambda p, l: torch.cat([x.to(device) for x in next(it)]), trees[0])
