"""The port's steps over a mesh: what DTensor needs beyond its own rules.

Under :func:`mesh_mode` the model's code runs unchanged on DTensors placed
by ``runtime/sharding.py``: ``implicit_replication()`` treats the plain
tensors the model creates (``arange``, masks, zeros) as replicated, and a
few ops get a handler of their own in DTensor's dispatcher for as long as
the mode is on:

  * ops without a sharding strategy that are pointwise
    (``log_sigmoid_backward``, the xLSTM gates' backward): operands that
    share one placement run shard by shard, as any pointwise op does;
    others are replicated first;
  * in-place ops whose operands are placed otherwise than their first
    (DTensor would run them on a copy and relabel the operand, see
    ``_INPLACE``), a cache row's ``index_copy_`` and a ``copy_``: each
    rank's shard is written in place.

Where DTensor's rules fail or pick a poor layout, the model's code
redistributes explicitly, so the layout at those sites depends neither
on DTensor's rules nor on its torch version: attention's and the mLSTM's cores run on each rank's own rows
and heads as local tensors (:func:`per_head`); the embedding is
Megatron's vocabulary-parallel lookup (:func:`lookup`); a norm takes the
residual stream whole over 'model' and returns its gradient whole
(:func:`whole_last`, :func:`same_grad`: Megatron's f and g, without which
DTensor, choosing by communication alone, gathers whole weights instead);
a head split, or the backward of a head merge, that does not divide the
'model' axis is gathered first (:func:`gather_model`,
:func:`gathered_grad`); and the MoE's global routing gathers the tokens
(:func:`replicate`, the all-gather the reference's SPMD partitioner
inserts there, ``src/repro/models/moe.py:51-55``) and runs each rank's
own experts. An op DTensor cannot propagate raises.

Every gather made here, outside DTensor's own rules, is noted to an active
``perf/op_analyze.py`` analyzer (its op, where, bytes), so a dry-run
record shows it. On a 1x1 mesh every placement is a whole tensor, so the
step is bit-equal to the plain step. The handlers are installed in the
process-wide dispatcher table that
``torch.distributed.tensor.parallel.loss_parallel`` also uses, and removed
when the mode exits.
"""
from __future__ import annotations

import contextlib
import math

import torch

aten = torch.ops.aten

# pointwise ops DTensor registers no strategy for
_POINTWISE = (aten.log_sigmoid_backward.default,)

# in-place ops of the port's steps. DTensor may run one on a redistributed
# copy of its first operand and then only relabel that operand's placement
# (the write lands in the copy, a view never sees it). A pointwise one
# whose operands all have the first one's shape and placement (none
# partial) runs shard by shard; every other case, and an indexed write,
# runs on the full tensors, the result's shard written into the operand's
# own local tensor
_INPLACE_POINTWISE = (aten.add_.Tensor, aten.mul_.Tensor,
                      aten.masked_fill_.Scalar)
_INPLACE = _INPLACE_POINTWISE + (aten.index_put_.default,)


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _replicate_spec(spec):
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec

    return DTensorSpec(spec.mesh, (Replicate(),) * spec.mesh.ndim,
                       tensor_meta=spec.tensor_meta)


def _full(x):
    """A DTensor's full tensor on every rank (inside the dispatcher)."""
    from torch.distributed.tensor._redistribute import \
        redistribute_local_tensor

    if not isinstance(x, _dtensor()):
        return x
    return redistribute_local_tensor(x._local_tensor, x._spec,
                                     _replicate_spec(x._spec))


def _wrap(t, mesh, placements, like=None):
    """A DTensor of local tensor ``t``; its global shape and strides are
    ``like``'s (a DTensor of the same placements), else ``t``'s own (a
    replicated ``t``)."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, \
        TensorMeta

    if not isinstance(t, torch.Tensor):
        return t
    g = like if like is not None else t
    spec = DTensorSpec(mesh, tuple(placements), tensor_meta=TensorMeta(
        g.shape, g.stride(), t.dtype))
    return _dtensor()(t, spec, requires_grad=False)


def _map(fn, tree):
    return torch.utils._pytree.tree_map(fn, tree)


def _dtensors(args, kwargs) -> list:
    leaves = torch.utils._pytree.tree_leaves((args, kwargs))
    return [a for a in leaves if isinstance(a, _dtensor())]


def _note(op: str, nbytes: int) -> None:
    """A gather of ``nbytes`` (per device) made outside DTensor's rules,
    noted to the active analyzer, if any."""
    from ..perf import op_analyze

    an = op_analyze.active()
    if an is not None:
        an.note_gather(op, nbytes)


def _gathered_bytes(ds) -> int:
    """The bytes of the DTensors in ``ds`` not already whole on every
    rank, at their full size."""
    from torch.distributed.tensor import Replicate

    return sum(d.numel() * d.element_size() for d in ds
               if any(not isinstance(p, Replicate) for p in d.placements))


def _run_replicated(op_call, args, kwargs):
    """``op_call`` on the full tensors; the result replicated, or written
    back shard by shard into an in-place op's first operand."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._redistribute import \
        redistribute_local_tensor

    ds = _dtensors(args, kwargs)
    mesh = ds[0].device_mesh
    gathered = _gathered_bytes(ds)
    if gathered:
        _note(str(op_call), gathered)
    full_args, full_kwargs = _map(_full, args), _map(_full, kwargs)
    out = op_call(*full_args, **full_kwargs)
    if op_call._schema.is_mutable and isinstance(args[0], _dtensor()):
        self = args[0]
        shard = redistribute_local_tensor(out, _replicate_spec(self._spec),
                                          self._spec)
        self._local_tensor.copy_(shard)
        return self
    return _map(lambda t: _wrap(t, mesh, (Replicate(),) * mesh.ndim), out)


def _local(a):
    return a._local_tensor if isinstance(a, _dtensor()) else a


def _same_placement(ds, first) -> bool:
    from torch.distributed.tensor import Partial

    return all(d._spec.placements == first._spec.placements and
               d.shape == first.shape for d in ds) and not any(
        isinstance(p, Partial) for p in first._spec.placements)


def _pointwise(op_call, args, kwargs):
    ds = _dtensors(args, kwargs)
    if _same_placement(ds, ds[0]):
        local = op_call(*_map(_local, args), **_map(_local, kwargs))
        return _wrap(local, ds[0].device_mesh, ds[0]._spec.placements,
                     like=ds[0])
    return _run_replicated(op_call, args, kwargs)


def _inplace(op_call, args, kwargs):
    self = args[0]
    if op_call in _INPLACE_POINTWISE and isinstance(self, _dtensor()) and \
            _same_placement(_dtensors(args, kwargs), self):
        op_call(*_map(_local, args), **_map(_local, kwargs))
        return self
    return _run_replicated(op_call, args, kwargs)


def _model_axis(t, parts) -> int | None:
    """The index of the 'model' axis of ``t``'s mesh if ``t`` is a DTensor
    there and a view that splits a dim of ``t`` into ``parts`` (leading
    sizes) cannot keep that dim sharded over it: its first part other
    than 1 does not divide the axis (DTensor's view rule shards only that
    part, and only evenly)."""
    if not isinstance(t, _dtensor()):
        return None
    names = t.device_mesh.mesh_dim_names or ()
    if "model" not in names:
        return None
    i = names.index("model")
    lead = next((n for n in parts if n != 1), 1)
    return None if lead % t.device_mesh.size(i) == 0 else i


def model_whole(t: torch.Tensor) -> torch.Tensor:
    """``t`` gathered over the 'model' axis where it is sharded there (its
    other placements kept); otherwise, and for a plain tensor, ``t``
    itself. Differentiable."""
    from torch.distributed.tensor import Replicate, Shard

    if not isinstance(t, _dtensor()):
        return t
    names = t.device_mesh.mesh_dim_names or ()
    if "model" not in names or not isinstance(
            t.placements[names.index("model")], Shard):
        return t
    placements = list(t.placements)
    placements[names.index("model")] = Replicate()
    out = t.redistribute(t.device_mesh, placements)
    _note("model_whole",
          out._local_tensor.numel() * out._local_tensor.element_size())
    return out


def gather_model(t: torch.Tensor, *parts: int) -> torch.Tensor:
    """``t`` before a view splits its dim sharded over 'model' into
    ``parts`` (e.g. the heads of a projection): :func:`model_whole` where
    that split cannot stay sharded there (:func:`_model_axis`), else ``t``
    itself."""
    return t if _model_axis(t, parts) is None else model_whole(t)


def gathered_grad(t: torch.Tensor, *parts: int) -> torch.Tensor:
    """``t`` just after a view merged ``parts`` (e.g. heads) into its last
    dim, whose backward splits that dim again, where that split cannot
    stay sharded over 'model' (:func:`_model_axis`): ``t`` gathered over
    'model' if that dim is sharded there, and its gradient brought to
    ``t``'s placements, so the backward view never sees the dim sharded
    (a product with a row-sharded weight returns it so). Otherwise, and
    for a plain tensor, ``t`` itself."""
    from torch.distributed.tensor import Shard

    i = _model_axis(t, parts)
    if i is None:
        return t
    p = t.placements[i]
    if isinstance(p, Shard) and p.dim % t.ndim == t.ndim - 1:
        t = model_whole(t)
    return same_grad(t)


def per_head(fn, *args, out_heads=None):
    """``fn(*locals)`` on each rank's own batch rows and heads, for a core
    (attention) that is independent per row and per head. Each of
    ``args`` is ``(tensor, head_dim)``: ``head_dim`` the dim of the
    tensor's heads, or None for a tensor every head shares (a single KV
    head, MLA's rope key); a plain value is passed as it is. Over a mesh
    the tensors are DTensors, dim 0 their batch: on the batch axes each
    keeps the first tensor's batch sharding, and over 'model' each is
    split by heads where every head dim divides that axis (the shared
    tensors whole, their gradients partial), else by rows where the rows
    each rank holds divide it, else not at all (every tensor whole there,
    a gather :func:`_note` records). The result has the first tensor's
    layout, or with ``out_heads`` (one head dim for each of the tuple
    ``fn`` returns, dim 0 the batch of each) that tuple so placed. A
    DTensor passed as a plain value (a mask every head shares) must be
    replicated on every axis; ``fn`` gets its local tensor.
    Without DTensors, ``fn(*tensors)``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    tensors = [a[0] if isinstance(a, tuple) else a for a in args]
    first = tensors[0]
    if not isinstance(first, _dtensor()):
        return fn(*tensors)
    for i, a in enumerate(args):
        if not isinstance(a, tuple) and isinstance(a, _dtensor()):
            if not all(isinstance(p, Replicate) for p in a.placements):
                raise ValueError(f"per_head: a whole value placed "
                                 f"{a.placements}, not replicated")
            tensors[i] = a.to_local()
    mesh = first.device_mesh
    names = mesh.mesh_dim_names or ()
    batch = [Shard(0) if p == Shard(0) and name != "model" else Replicate()
             for name, p in zip(names, first.placements)]
    model = None
    if "model" in names:
        m = mesh.size(names.index("model"))
        rows = first.shape[0] // math.prod(
            mesh.size(i) for i, p in enumerate(batch) if p == Shard(0))
        if args[0][1] is not None and all(
                a[1] is None or t.shape[a[1]] % m == 0
                for t, a in zip(tensors, args) if isinstance(a, tuple)):
            model = "heads"
        elif rows % m == 0:
            model = "rows"

    def layout(d, grad=False):
        out = []
        for name, p in zip(names, batch):
            if name != "model":
                out.append(p)
            elif model == "rows":
                out.append(Shard(0))
            elif model == "heads":
                out.append(Shard(d) if d is not None else
                           Partial() if grad else Replicate())
            else:
                out.append(Replicate())
        return tuple(out)

    ins = tuple(layout(a[1]) if isinstance(a, tuple) else None
                for a in args)
    grads = tuple(layout(a[1], grad=True) if isinstance(a, tuple)
                  else None for a in args)
    for t, target in zip(tensors, ins):
        if target is not None and any(
                isinstance(q, Replicate) and isinstance(p, Shard)
                for p, q in zip(t.placements, target)):
            _note("per_head", t.numel() * t.element_size() // math.prod(
                mesh.size(i) for i, q in enumerate(target)
                if isinstance(q, Shard)))
    outs = list(ins[0]) if out_heads is None else tuple(
        layout(d) for d in out_heads)
    def local(*a):          # gradients leave contiguous, for DTensor's views
        return fn(*(_ContiguousGrad.apply(x) if isinstance(
            x, torch.Tensor) and x.requires_grad else x for x in a))

    mapped = local_map(local, out_placements=outs, in_placements=ins,
                       in_grad_placements=grads, device_mesh=mesh,
                       redistribute_inputs=True)
    return mapped(*tensors)


def lookup(table: torch.Tensor, tokens: torch.Tensor,
           books: torch.Tensor | None = None) -> torch.Tensor:
    """``table[tokens]``, or with codebooks the sum of their rows
    ``table[books, tokens].sum(dim=2)``, the vocabulary being ``table``'s
    dim 0 (1 with codebooks). Over a mesh
    (``table`` whole on the batch axes, ``tokens`` sharded there by rows)
    each rank looks up its own tokens in its own rows: with the
    vocabulary sharded over 'model', Megatron's vocabulary-parallel
    embedding (tokens outside the rank's rows give zeros, and the partial
    rows are summed over 'model' at once); with the columns sharded, the
    rank's columns.
    DTensor's own rule for the lookup's backward (an accumulating
    ``index_put``) fails on some torch versions."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    vocab = 0 if books is None else 1
    if not isinstance(table, _dtensor()):
        return table[tokens] if books is None else \
            table[books, tokens].sum(dim=2)
    mesh = table.device_mesh
    names = mesh.mesh_dim_names or ()
    tok = tokens.placements if isinstance(tokens, _dtensor()) else \
        (Replicate(),) * mesh.ndim
    rows_axes = [name != "model" and p == Shard(0)
                 for name, p in zip(names, tok)]
    t_in, t_grad, k_in, out = [], [], [], []
    span = (0, table.shape[vocab])
    for i, (name, p, by_rows) in enumerate(zip(names, table.placements,
                                               rows_axes)):
        if name == "model" and p == Shard(vocab):
            n = table.shape[vocab] // mesh.size(i)
            span = (mesh.get_local_rank(name) * n, n)
            t_in.append(p), t_grad.append(p), k_in.append(Replicate())
            out.append(Partial())
        elif name == "model" and isinstance(p, Shard):
            t_in.append(p), t_grad.append(p), k_in.append(Replicate())
            out.append(Shard(tokens.ndim - vocab))
        else:
            t_in.append(Replicate())
            t_grad.append(Partial() if by_rows else Replicate())
            k_in.append(Shard(0) if by_rows else Replicate())
            out.append(Shard(0) if by_rows else Replicate())

    def local(tbl, tok):
        lo, n = span
        inside = (tok >= lo) & (tok < lo + n)
        idx = torch.where(inside, tok - lo, 0)
        if books is None:
            return torch.where(inside[..., None], tbl[idx], 0)
        return torch.where(inside[..., None], tbl[books, idx], 0).sum(dim=2)

    k_in = tuple(k_in) if isinstance(tokens, _dtensor()) else None
    rows = local_map(local, out_placements=out,
                     in_placements=(tuple(t_in), k_in),
                     in_grad_placements=(tuple(t_grad), k_in),
                     device_mesh=mesh, redistribute_inputs=True)(
        table, tokens)
    return placed_as(rows, rows)      # the partial rows summed


def same_grad(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is, its gradient brought to ``t``'s own placements (a
    partial one read as replicated: a gradient is a whole value) before
    autograd goes on with it; a plain tensor as it is."""
    from torch.distributed.tensor import Partial, Replicate

    if not isinstance(t, _dtensor()):
        return t
    grad = tuple(Replicate() if isinstance(p, Partial) else p
                 for p in t.placements)
    return _dtensor().from_local(
        t.to_local(grad_placements=grad), t.device_mesh, t.placements,
        run_check=False, shape=t.shape, stride=t.stride())


def whole_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` before a reduction over its last dim (a norm): a partial sum
    reduced and a shard of the last dim gathered (noted), other
    placements kept; a plain tensor as it is. Differentiable. So the
    residual stream enters each block whole over 'model', as Megatron's
    does, and a product with a column-sharded weight never gathers the
    weight instead."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    if not isinstance(t, _dtensor()):
        return t
    target = tuple(
        Replicate() if isinstance(p, Partial) or (
            isinstance(p, Shard) and p.dim % t.ndim == t.ndim - 1) else p
        for p in t.placements)
    if target == tuple(t.placements):
        return t
    if any(isinstance(p, Shard) and q != p
           for p, q in zip(t.placements, target)):
        _note("whole_last", t.numel() * t.element_size() // math.prod(
            t.device_mesh.size(i) for i, q in enumerate(target)
            if isinstance(q, Shard)))
    return t.redistribute(t.device_mesh, target)


def placed_as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` redistributed to ``like``'s placements, a partial one read as
    replicated (a partial sum reduced); a plain tensor as it is.
    Differentiable."""
    from torch.distributed.tensor import Partial, Replicate

    if not isinstance(t, _dtensor()):
        return t
    target = tuple(Replicate() if isinstance(p, Partial) else p
                   for p in like.placements)
    return t if tuple(t.placements) == target else t.redistribute(
        like.device_mesh, target)


def replicate(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole on every rank (a plain tensor as it is).
    Differentiable."""
    from torch.distributed.tensor import Replicate

    if not isinstance(t, _dtensor()):
        return t
    gathered = _gathered_bytes([t])
    if not gathered:
        return t
    _note("replicate", gathered)
    return t.redistribute(t.device_mesh,
                          (Replicate(),) * t.device_mesh.ndim)


def _index_copy_(op_call, args, kwargs):
    """``self.index_copy_(dim, index, source)`` with one index (a decode
    step's cache row): ``source`` moved to ``self``'s placements (its
    ``dim`` whole), and each rank writes the row into its own shard when
    the row falls there, else writes its shard's row back; no gather of
    ``self``. Other cases run on the full tensors."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._redistribute import \
        redistribute_local_tensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    self, dim, index, source = args[:4]
    if not isinstance(self, _dtensor()) or kwargs or index.numel() != 1 \
            or source.dim() != self.dim():
        return _run_replicated(op_call, args, kwargs)
    dim = dim % self.dim()
    mesh = self.device_mesh
    target = tuple(Replicate() if p == Shard(dim) else p
                   for p in self._spec.placements)
    src_spec = source._spec if isinstance(source, _dtensor()) else \
        _replicate_spec(DTensorSpec(mesh, (), tensor_meta=None))
    src_full_meta = DTensorSpec(mesh, src_spec.placements,
                                tensor_meta=_meta_of(source))
    src = redistribute_local_tensor(
        source._local_tensor if isinstance(source, _dtensor()) else source,
        src_full_meta, DTensorSpec(mesh, target,
                                   tensor_meta=_meta_of(source)))
    local_shape, offset = compute_local_shape_and_global_offset(
        self.shape, mesh, self._spec.placements)
    local = self._local_tensor
    idx = _full(index).reshape(1) - offset[dim]
    ok = (idx >= 0) & (idx < local_shape[dim])
    idx = torch.clamp(idx, 0, max(local_shape[dim] - 1, 0))
    if local.shape[dim]:
        old = local.index_select(dim, idx)
        local.index_copy_(dim, idx, torch.where(ok, src.to(local.dtype),
                                                old))
    return self


def _copy_(op_call, args, kwargs):
    """``self.copy_(src)``: ``src`` moved to ``self``'s placements and
    copied shard by shard (DTensor's own rule may relabel ``self``
    instead); a broadcast copy runs on the full tensors."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._redistribute import \
        redistribute_local_tensor

    self, src = args[:2]
    if not isinstance(self, _dtensor()) or tuple(src.shape) != \
            tuple(self.shape):
        return _run_replicated(op_call, args, kwargs)
    mesh = self.device_mesh
    if isinstance(src, _dtensor()):
        local = redistribute_local_tensor(
            src._local_tensor, src._spec,
            DTensorSpec(mesh, self._spec.placements,
                        tensor_meta=_meta_of(src)))
    else:
        local = redistribute_local_tensor(
            src, DTensorSpec(mesh, _replicate_spec(self._spec).placements,
                             tensor_meta=_meta_of(src)),
            DTensorSpec(mesh, self._spec.placements,
                        tensor_meta=_meta_of(src)))
    self._local_tensor.copy_(local, **kwargs)
    return self


def _meta_of(t):
    from torch.distributed.tensor._dtensor_spec import TensorMeta

    return TensorMeta(t.shape, t.stride(), t.dtype)


@contextlib.contextmanager
def mesh_mode():
    """Run the port's model code on DTensors (see the module docstring)."""
    from torch.distributed.tensor.experimental import implicit_replication

    handlers = _dtensor()._op_dispatcher._custom_op_handlers
    mine = {op: _pointwise for op in _POINTWISE}
    mine.update({op: _inplace for op in _INPLACE})
    mine[aten.index_copy_.default] = _index_copy_
    mine[aten.copy_.default] = _copy_
    saved = {op: handlers[op] for op in mine if op in handlers}
    handlers.update(mine)
    try:
        with implicit_replication():
            yield
    finally:
        for op in mine:
            handlers.pop(op, None)
        handlers.update(saved)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        from torch.distributed import _functional_collectives as funcol

        return funcol.all_reduce(t, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) of ``t`` over ``group`` whose ranks all compute the
    same loss from the sum: the gradient of each rank's addend is the
    sum's gradient as it is (Megatron's reduce from the model-parallel
    region; ``dist.nn.functional.all_reduce`` would sum the gradient too,
    counting a replicated loss once a rank)."""
    return _SumOver.apply(t, group)
