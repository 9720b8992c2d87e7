"""The step's graph family: each static key of a step segment captured once
in a CUDA graph (the port's counterpart of ``repro``'s ``jax.jit`` over
``torr_stream_batch_step`` and ``torr_window_step``).

``repro`` compiles the step once per static key (cfg, serial, plan, fused,
bucket_cap, decide) and runs every later call as one executable. The
port's step is a few thousand small launches a window, so eagerly Python
sets the pace. ``core.pipeline`` splits each lowering at its host reads
into segments, pure functions of tensors whose static arguments and host
values are bound before the call; :meth:`GraphFamily.run` captures each
segment key once in a ``torch.cuda.CUDAGraph``. Every later call with
that key copies its inputs into the graph's static input buffers
(``copy_``), replays the graph and returns clones of the static outputs:
the engine's telemetry backlog and the callers read results after the
next replay has overwritten the static ones.

A key names the segment, its static arguments, the tensor shapes, the
host value read before it and the item memory's identity: the item
memory's tensors are constants of the graph. An entry keeps its segment
function, and with it the item memory, alive, so that identity is never
reused while the graph lives. One graph per key: the family is bounded
by the key space (ladder levels x lowerings x bucket tiers x host
values), as the reference's executable family is.

Capture follows ``torch.cuda.graphs``: one eager call on a side stream
first (the kernel libraries are built and loaded, cub and cuBLAS
workspaces exist), then the capture. The kernel wrappers count their
launches on the host (``kernels.build.LAUNCHES``); a capture records
launches without running them, so the family takes the capture's counts
back out and adds them on every replay, which runs those kernels.

A capture is thread-local (``capture_error_mode="thread_local"``): the
async engine's dispatcher captures a new key while its collector copies
results and callers submit windows, and only the capturing thread's
calls are held to the rules of a capture. The cyclic garbage collector
is held off while a graph is captured (:func:`collection_paused`): a
collection on the capturing thread can free the graphs of an engine that
is no longer referenced, and destroying a graph there invalidates the
capture. ``captures`` records each capture's segment name and seconds.

No fallback: a capture or replay error raises; nothing reruns the step
eagerly. On the CPU there is no graph: :data:`EAGER` runs each segment as
it is, the plain path there, as a kernel wrapper's plain version is on a
CPU tensor (``StreamEngine(jit=True, device="cpu")`` uses it).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import threading
import time

import torch

from ..kernels import build

CU_GRAPH_NODE_TYPE_KERNEL = 0

# captures in progress on any thread, and whether the collector was on before
# the first of them
_gc_lock = threading.Lock()
_gc_hold = {"captures": 0, "was_enabled": False}


@contextlib.contextmanager
def collection_paused():
    """The cyclic garbage collector off (for every thread) until the last
    of the nested or concurrent ``with`` blocks exits, then as it was."""
    with _gc_lock:
        if _gc_hold["captures"] == 0:
            _gc_hold["was_enabled"] = gc.isenabled()
            gc.disable()
        _gc_hold["captures"] += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_hold["captures"] -= 1
            if _gc_hold["captures"] == 0 and _gc_hold["was_enabled"]:
                gc.enable()


def tree_map(fn, obj):
    """``fn`` on every tensor of nested tuples, lists and dataclasses;
    other leaves (None, ints) stay as they are."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_map(fn, x) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def leaves(obj) -> list:
    """The tensors of ``obj`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, obj)
    return out


class Eager:
    """Runs each segment as it is: the step on the CPU and with
    ``jit=False``."""

    def run(self, key, fn, inputs):
        del key
        return fn(*inputs)


EAGER = Eager()


@dataclasses.dataclass
class Entry:
    graph: torch.cuda.CUDAGraph
    fn: object          # the segment (pins the item memory it reads)
    inputs: tuple       # static input buffers
    outputs: object     # static outputs, overwritten by every replay
    launches: dict      # per-kernel launches one replay runs
    kernel_nodes: int   # kernel nodes of the graph


def kernel_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The kernel nodes of a captured graph (kept with ``keep_graph``),
    counted through the driver API."""
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = (ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t))
    cu.cuGraphNodeGetType.argtypes = (ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int))
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = cu.cuGraphGetNodes(g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    if not err:
        err = cu.cuGraphGetNodes(g, nodes, ctypes.byref(n))
    kind, count = ctypes.c_int(), 0
    for node in nodes:
        if err:
            break
        err = cu.cuGraphNodeGetType(node, ctypes.byref(kind))
        count += kind.value == CU_GRAPH_NODE_TYPE_KERNEL
    if err:
        raise RuntimeError(f"counting a graph's nodes failed: CUresult {err}")
    return count


class GraphFamily:
    """One captured CUDA graph per segment key, replayed on later calls.

    ``replays`` and ``nodes_replayed`` count on the host, like
    ``LAUNCHES``: the graphs replayed and their kernel nodes; ``captures``
    holds (segment name, seconds) of every capture, its side-stream
    warm-up and instantiation included."""

    def __init__(self):
        self._entries: dict = {}
        self.replays = 0
        self.nodes_replayed = 0
        self.captures: list = []

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self):
        return self._entries.keys()

    def entry(self, key) -> Entry:
        return self._entries[key]

    def run(self, key, fn, inputs):
        """``fn(*inputs)`` through the graph of ``key``: captured at the
        key's first call, then its inputs copied in, one replay, and clones
        of its outputs returned."""
        entry = self._entries.get(key)
        if entry is None:
            t0 = time.perf_counter()
            entry = self._entries[key] = self._capture(fn, inputs)
            self.captures.append((key[0], time.perf_counter() - t0))
        dst, src = leaves(entry.inputs), leaves(inputs)
        if len(dst) != len(src):
            raise ValueError(f"graph {key[0]!r}: {len(src)} input tensors, "
                             f"captured with {len(dst)}")
        for d, s in zip(dst, src):
            if d.shape != s.shape or d.dtype != s.dtype:
                raise ValueError(
                    f"graph {key[0]!r}: input {tuple(s.shape)} {s.dtype}, "
                    f"captured as {tuple(d.shape)} {d.dtype}")
            d.copy_(s)
        entry.graph.replay()
        for name, n in entry.launches.items():
            build.LAUNCHES[name] += n
        self.replays += 1
        self.nodes_replayed += entry.kernel_nodes
        return tree_map(torch.clone, entry.outputs)

    @staticmethod
    def _capture(fn, inputs) -> Entry:
        static_in = tree_map(torch.clone, inputs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*static_in)     # builds and loads everything the capture runs
        torch.cuda.current_stream().wait_stream(side)
        before = dict(build.LAUNCHES)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with collection_paused(), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                static_out = fn(*static_in)
        finally:
            captured = {k: n - before[k] for k, n in build.LAUNCHES.items()}
            build.LAUNCHES.update(before)   # recorded, not run
        nodes = kernel_nodes(graph)
        graph.instantiate()
        return Entry(graph, fn, static_in, static_out,
                     {k: n for k, n in captured.items() if n}, nodes)
