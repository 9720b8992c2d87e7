"""Op-level analyzer: FLOPs, bytes and collectives of one run of a call
(the port's counterpart of ``repro.perf.hlo_analyze``).

The reference analyzes optimized HLO. The port has no HLO: eager PyTorch
runs every aten op as a kernel of its own. :class:`OpAnalyzer` is a
``TorchDispatchMode`` that runs a call once (on ``meta``, the CPU or the
card) and records every aten op that reaches a plain tensor. Under DTensor
it records the local ops each DTensor op turns into, so every figure is
per device, as the reference's per-device SPMD module is. The fields keep
the reference's names:

  * ``flops``: the sum over ops of ``torch.utils.flop_counter``'s
    registered formula (matrix products, attention, convolutions: 2 per
    multiply-add); an op without a formula counts 0, as the reference
    counts only dots and convolutions;
  * ``bytes_traffic``: bytes read plus bytes written by each op: its
    tensor operands and outputs, each counted once. A view (``view``,
    ``slice``, ``select``, ``transpose``, ...) moves nothing; a gather
    (``index``, ``index_select``, ``embedding``) reads only the elements
    it returns; an in-place op writes its first operand (an indexed
    write, ``index_copy_`` or ``index_put_``, only the rows it is given)
    and reads the others;
  * ``bytes_traffic_pessimistic``: every operand and output of every op
    counted in full, views and in-place operands included;
  * ``collective_bytes`` / ``collective_counts``: per reference kind
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``) the larger of the operand and output bytes of
    each collective op (the functional collectives DTensor issues and the
    ``c10d`` ones a ``torch.distributed`` call issues);
  * ``peak_live_bytes``: the high-water mark of bytes held by the tensors
    the recorded ops allocated (released when a tensor dies), beside the
    arguments of the call;
  * ``gathers``: the gathers the mesh layer made outside DTensor's own
    rules (``runtime/spmd.py``: a head split that does not divide the
    'model' axis, the MoE's global dispatch, an op run on full tensors),
    by op and where: their count and the bytes each device ends up
    holding. Their collectives are counted among the others as well.

Every figure is times the op's multiplicity (see :func:`scan`).

Two kinds of region keep the count honest:

  * :func:`kernel_op` wraps each hand-written kernel's wrapper: it counts
    as one op (its tensors in and out, the kernel's operation count) on
    every device, and the ops inside it (the plain version on the CPU, the
    output allocations on the card) are hidden;
  * :func:`scan` runs the body of a Python loop that stands where the
    reference has ``lax.scan`` (the sLSTM over the prompt, the mLSTM's
    chunks). With ``sample_loops`` it runs the first step, then one more
    whose ops (and their backward's, found by autograd sequence number)
    count for the remaining trip count, the counterpart of
    ``hlo_analyze``'s trip-count scaling; the values are then those of
    one step repeated, so this is for counting on ``meta``, never for
    results.

Outside an analyzer both cost one look at the dispatch-mode stack.
"""
from __future__ import annotations

import dataclasses
import functools
import sys
import weakref
from collections import defaultdict
from typing import Callable

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# op-name fragments of the collectives (functional and c10d) -> kind
_COLLECTIVES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                ("broadcast", "collective-permute"),
                ("send", "collective-permute"),
                ("recv", "collective-permute"))

# metadata-only ops that allocate and move nothing
_FREE = frozenset({"detach", "alias", "lift_fresh", "_local_scalar_dense",
                   "wait_tensor", "empty", "empty_like", "empty_strided",
                   "new_empty", "new_empty_strided", "sym_size",
                   "sym_stride", "sym_numel", "is_same_size", "set_",
                   "_unsafe_view"})
# in-place ops that write only the rows (or entries) their operands give
_INDEXED_WRITES = frozenset({"index_copy_", "index_put_", "scatter_",
                             "index_add_", "scatter_add_",
                             "masked_scatter_", "_index_put_impl_"})
# gathers: read only the elements they return (and their indices)
_GATHERS = frozenset({"index", "index_select", "gather", "embedding",
                      "take_along_dim", "take"})
# in-place ops that do not read their first operand
_WRITE_ONLY = frozenset({"copy_", "fill_", "zero_", "normal_", "uniform_"})

_ROOT = "repro_torch"
_SKIP_FRAMES = ("perf/op_analyze.py", "runtime/spmd.py",
                "kernels/build.py")


@dataclasses.dataclass
class OpRecord:
    """One recorded op (or kernel): per-device figures, already times
    ``mult``."""
    name: str
    flops: float
    bytes: float
    shapes: tuple
    dtypes: tuple
    where: str
    mult: float
    collective: str | None = None
    pessimistic: float = 0.0


@dataclasses.dataclass
class Analysis:
    flops: float
    bytes_traffic: float
    bytes_traffic_pessimistic: float
    collective_bytes: dict
    collective_counts: dict
    peak_live_bytes: float = 0.0
    ops: list = dataclasses.field(default_factory=list)
    gathers: list = dataclasses.field(default_factory=list)

    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))

    def op_names(self) -> list[str]:
        return [r.name for r in self.ops]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _where() -> str:
    """The innermost frame of the port's own code outside the analyzer:
    "models/attention.py:112 attn_train"."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        if _ROOT in fn and not fn.endswith(_SKIP_FRAMES):
            rel = fn.split(_ROOT + "/", 1)[-1]
            return f"{rel}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return ""


def _collective_kind(name: str) -> str | None:
    base = name.split(".")[-1]
    for frag, kind in _COLLECTIVES:
        if frag in base:
            return kind
    return None


class OpAnalyzer(TorchDispatchMode):
    """Records every op of the calls run under it (``with OpAnalyzer() as
    an: fn(...)``; then ``an.analysis()``)."""

    def __init__(self, sample_loops: bool = False):
        super().__init__()
        self.sample_loops = sample_loops
        self.records: list[OpRecord] = []
        self._hidden = 0
        self._mult = [1.0]
        self._ranges: list[tuple[int, int, float]] = []
        self._live = 0
        self.peak_live_bytes = 0
        self.gathers: dict = defaultdict(lambda: [0.0, 0.0])

    # -- recording -------------------------------------------------------
    def _multiplicity(self) -> float:
        m = self._mult[-1]
        if self._ranges:
            node = torch._C._current_autograd_node()
            if node is not None:
                seq = node._sequence_nr()
                for lo, hi, k in self._ranges:
                    if lo <= seq <= hi:
                        m *= k
        return m

    def _track(self, outs: list[torch.Tensor]) -> None:
        for t in outs:
            n = _nbytes(t)
            if not n:
                continue
            self._live += n
            self.peak_live_bytes = max(self.peak_live_bytes, self._live)
            weakref.finalize(t, self._release, n)

    def _release(self, n: int) -> None:
        self._live -= n

    def record(self, name: str, ins: list, outs: list, flops: float,
               moved: float, pessimistic: float, collective=None) -> None:
        m = self._multiplicity()
        self.records.append(OpRecord(
            name=name, flops=flops * m, bytes=moved * m,
            shapes=tuple(tuple(t.shape) for t in outs),
            dtypes=tuple(str(t.dtype).removeprefix("torch.") for t in outs),
            where=_where(), mult=m, collective=collective,
            pessimistic=pessimistic * m))

    def note_gather(self, op: str, nbytes: float) -> None:
        """A gather of ``nbytes`` per device outside DTensor's rules
        (``runtime/spmd.py``), times the multiplicity."""
        m = self._multiplicity()
        g = self.gathers[(op, _where())]
        g[0] += m
        g[1] += nbytes * m

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        subclasses = [t for t in types
                      if t is not torch.Tensor and t is not torch.nn.Parameter]
        if any(t.__name__ == "DTensor" for t in subclasses):
            return NotImplemented  # DTensor: record the local ops it runs
        out = func(*args, **kwargs)
        if subclasses:             # DTensor's shape propagation (fake)
            return out
        if self._hidden:
            return out
        name = func._schema.name.split("::")[-1]
        overload = func._overloadpacket
        if name in _FREE:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        pessimistic = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        kind = _collective_kind(str(func._schema.name))
        if kind is not None:
            moved = max(sum(map(_nbytes, ins)), sum(map(_nbytes, outs)))
            self.record(name, ins, outs, 0.0, moved, pessimistic, kind)
            return out
        if func.is_view:
            self.record(name, ins, outs, 0.0, 0.0, pessimistic)
            return out
        flops = 0.0
        fn = _flop_registry().get(overload)
        if fn is not None:
            flops = float(fn(*args, **kwargs, out_val=out))
        mutated = bool(func._schema.arguments) and \
            func._schema.arguments[0].alias_info is not None and \
            func._schema.arguments[0].alias_info.is_write
        if mutated and ins:
            others = ins[1:]
            if name in _INDEXED_WRITES:
                # read the indices and values, write the values' worth
                vals = max((_nbytes(t) for t in others
                            if t.is_floating_point() or t.dtype in
                            (torch.int8, torch.int32)), default=0)
                moved = sum(map(_nbytes, others)) + vals
            else:
                moved = sum(map(_nbytes, others)) + _nbytes(ins[0]) * (
                    1 if name in _WRITE_ONLY else 2)
        elif name in _GATHERS and ins:
            idx = sum(_nbytes(t) for t in ins[1:]
                      if not t.is_floating_point())
            moved = 2 * sum(map(_nbytes, outs)) + idx
            self._track(outs)
        else:
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self._track(outs)
        self.record(name, ins, outs, flops, moved, pessimistic)
        return out

    # -- results ---------------------------------------------------------
    def analysis(self) -> Analysis:
        coll_b = {k: 0.0 for k in COLLECTIVE_KINDS}
        coll_n = {k: 0 for k in COLLECTIVE_KINDS}
        for r in self.records:
            if r.collective:
                coll_b[r.collective] += r.bytes
                coll_n[r.collective] += int(round(r.mult))
        return Analysis(
            flops=float(sum(r.flops for r in self.records)),
            bytes_traffic=float(sum(r.bytes for r in self.records
                                    if not r.collective)),
            bytes_traffic_pessimistic=float(sum(
                r.pessimistic for r in self.records if not r.collective)),
            collective_bytes=coll_b, collective_counts=coll_n,
            peak_live_bytes=float(self.peak_live_bytes),
            ops=list(self.records),
            gathers=[dict(op=k[0], where=k[1], count=v[0], bytes=v[1])
                     for k, v in self.gathers.items()])


@functools.cache
def _flop_registry() -> dict:
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def active() -> OpAnalyzer | None:
    """The innermost analyzer on the dispatch-mode stack, if any."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpAnalyzer):
            return mode
    return None


def analyze(fn: Callable, *args, sample_loops: bool = False,
            **kwargs) -> tuple[object, Analysis]:
    """(``fn(*args, **kwargs)``, its :class:`Analysis`)."""
    with OpAnalyzer(sample_loops=sample_loops) as an:
        out = fn(*args, **kwargs)
    return out, an.analysis()


# ---------------------------------------------------------------------------
# Regions
# ---------------------------------------------------------------------------

def kernel_op(name: str, operations: Callable) -> Callable:
    """Decorator of a hand-written kernel's wrapper: under an analyzer the
    call is one op ``name`` (its tensor arguments read, its outputs
    written, ``operations(*args, **kwargs)`` operations) and the ops
    inside are hidden."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            an = active()
            if an is None:
                return fn(*args, **kwargs)
            an._hidden += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                an._hidden -= 1
            ins, outs = _tensors((args, kwargs)), _tensors(out)
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            an._track(outs)
            an.record(name, ins, outs, float(operations(*args, **kwargs)),
                      moved, moved)
            return out
        return call
    return wrap


def scan(body: Callable, carry, xs) -> tuple[object, list]:
    """``for x in xs: carry, y = body(carry, x)``; returns (carry, [y]).
    Under an analyzer with ``sample_loops`` the body runs twice: on
    ``xs[0]`` as it is (the first step's carry may be placed otherwise,
    e.g. a plain initial state beside DTensor inputs), then on ``xs[1]``
    with its ops (and, through autograd's sequence numbers, their
    backward's) counted ``len(xs) - 1`` times; [y] is the first y and the
    second repeated."""
    xs = list(xs)
    an = active()
    if an is None or not an.sample_loops or len(xs) < 3:
        ys = []
        for x in xs:
            carry, y = body(carry, x)
            ys.append(y)
        return carry, ys
    n = len(xs) - 1
    carry, y0 = body(carry, xs[0])
    lo = _next_sequence_nr(an)
    an._mult.append(an._mult[-1] * n)
    try:
        carry, y = body(carry, xs[1])
    finally:
        an._mult.pop()
    hi = _next_sequence_nr(an) - 1
    if hi >= lo:
        an._ranges.append((lo, hi, float(n)))
    return carry, [y0] + [y] * n


def _next_sequence_nr(an: OpAnalyzer) -> int:
    """The sequence number autograd gives the next node it creates (a
    throwaway node, hidden from the analyzer); -1 without grad mode."""
    if not torch.is_grad_enabled():
        return -1
    an._hidden += 1
    try:
        probe = torch.zeros((), device="meta", requires_grad=True) * 1
    finally:
        an._hidden -= 1
    return probe.grad_fn._sequence_nr() + 1


def aggregate(ops: list[OpRecord]) -> list[dict]:
    """The records summed by (op, output shapes, where): rows of ``op``,
    ``shapes``, ``where``, ``count``, ``flops``, ``bytes``."""
    acc: dict = defaultdict(lambda: [0.0, 0.0, 0.0])
    for r in ops:
        a = acc[(r.name, r.shapes, r.where)]
        a[0] += r.mult
        a[1] += r.flops
        a[2] += r.bytes
    return [dict(op=k[0], shapes=[list(s) for s in k[1]], where=k[2],
                 count=v[0], flops=v[1], bytes=v[2])
            for k, v in acc.items()]
