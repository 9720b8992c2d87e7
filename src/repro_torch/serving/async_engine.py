"""Async, device-sharded multi-stream serving runtime: the dispatch/collect
split (port of ``repro.serving.async_engine``).

Scheduling contract
===================

``AsyncStreamEngine`` serves the same fixed-slot scheduling contract as the
synchronous :class:`~repro_torch.serving.stream_engine.StreamEngine` (admit
binds a stream to a slot and resets its cache row, submit enqueues one
window per call, retire drops the remaining backlog with the slot) but
splits the serving loop across two daemon threads so host work overlaps
device work:

  * the **dispatcher** pops the head window of every busy slot (the
    assembly the sync engine performs, so batch composition and per-stream
    queue depths are identical for the same submission order), applies the
    RT-deadline admission decision per popped window, launches the step on
    a CUDA stream it owns (copies in, graph replays, clones out; launches
    return while the card computes), records an event right after it, and
    hands the in-flight step to the collector through a bounded queue. A
    depth of ``pipeline_depth`` steps gives double buffering: the
    dispatcher assembles step t+1 on the host while step t runs, and
    blocks (backpressure) rather than running ahead of the card.
  * the **collector** waits on that event (the counterpart of ``repro``'s
    ``jax.block_until_ready``), then copies the step's outputs and
    telemetry to pinned host buffers on a stream of its own that waits for
    that event alone, so step t's copy never queues behind step t+1;
    it slices per-slot rows and resolves each window's
    :class:`concurrent.futures.Future` with host-resident
    ``(WindowOutput, WindowTelemetry)`` numpy trees.

Determinism: with admission control off (``tracker=None``) and the same
submission order, every batch the dispatcher assembles is the batch the
sync engine would build, so results are bit-identical to ``StreamEngine``.
Construct with ``paused=True`` and call :meth:`start` after submitting to
reproduce the sync engine's drain schedule exactly.

Sharding: pass ``mesh`` (a :class:`~repro_torch.runtime.sharding.
StreamMesh` from ``runtime.sharding.stream_mesh``) to shard the stacked
``TorrState`` along the leading stream-slot axis, with the shared item
memory replicated: one :class:`Shard` a mesh device, each with its rows
of the state, its device's copy of the item memory, its own CUDA stream
and its own ``GraphFamily`` (captured under its device; captures take
turns). The slot count is padded up to a multiple of the device count
(``runtime.sharding.pad_stream_slots``); pad slots ride the pipeline's
pad branch. A step assembles one batch, as the unsharded engine does,
resolves one lowering, plan and ``auto`` choice, and runs it on every
shard in turns (``pipeline.run_in_turns``): every shard's launches up to
its host read (compact's full-path count, switch's bank choices) are
enqueued before any shard reads, so the cards never wait for one
another's reads. Compact's ``bucket_cap`` is the same number on every
shard, resolved against the whole step's rows; a shard whose full-path
rows overflow it takes the exact fallback, so outputs and telemetry equal
the unsharded engine's. The collector waits on each shard's event and
copies each shard's rows into one host tree. Streams are independent, so
the sharding is communication-free and exact; on a one-device mesh (or
``mesh=None``) the engine runs its unsharded path. The ``serial``
lowering runs the slots one after another and cannot shard; it is
refused with a mesh of several devices. A mesh may name one card more
than once (several shards on one card) or the CPU (CPU shards, the
tests' stand-in for several cards).

The card: every device operation of the engine (its state, admission,
the batch gather, the step) runs on the dispatcher's stream; a window
tensor submitted on the card is ordered after the caller's stream and
recorded on the dispatcher's. The dispatcher dispatches under the engine
lock, as ``repro`` does, so ``submit`` and ``admit`` wait through the
step's host reads (compact's full-path count, switch's bank choices). A
step with a new static key captures its graph inside the served loop;
captures are thread-local (``core.capture``), so the collector's and the
callers' device calls stay legal meanwhile. With a governor armed,
:meth:`warmup` captures the current key of every ladder level.

Deadline control: pass a ``DeadlineTracker`` (``serving.deadline``) to
enforce RT-30/RT-60 per-window deadlines. The dispatcher consults the pure
decision table per popped window: ADMIT serves as-is, ESCALATE forces the
window's queue-depth input to Alg. 1's load gate ``H(N, q)`` to at least
``cfg.q_hi``, SHED fails the window's future with ``WindowShed`` without
spending a slot-step on it. The collector feeds measured step latencies
back into the tracker's projection EMA and records per-window latency.

QoS governor: pass a ``Governor`` (``repro_torch.control``) alongside the
tracker to close the loop between slack and the compute path. Per
dispatched step the dispatcher feeds the governor the head windows'
projected slack plus the deepest per-slot backlog; the governor returns a
knob plan that is latched for the step. The collector closes the energy
loop: every served window's telemetry is priced by
``perf.cycle_model.telemetry_cost`` and folded into the governor's energy
EWMA. ``fused="auto"`` folds each step's full-path fraction on the
collector. A worker error (a capture, a replay, a copy) fails every
pending future with :class:`~repro_torch.runtime.fault.EngineDead`;
nothing falls back to another path.

Session state: with ``store=`` the dispatcher takes each step's snapshot
rows (references to the post-step state, no device call) and the
collector writes them only after the futures of the step they cover have
been resolved, so a snapshot covering a window implies its result was
delivered. The collector copies the state's stacked leaves once a step,
on its own stream after the step's event, into pinned memory (never a
``.cpu()`` on the dispatcher's stream). :meth:`abandon` stops the workers
without joining them, for a supervisor's recovery.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Dict

import numpy as np
import torch

from ..core import capture, pipeline
from ..core.item_memory import ItemMemory
from ..core.pipeline import TorrState
from ..core.types import StreamBatch, TorrConfig, map_tensors
from ..device import resolve_device
from ..obs.bridge import telemetry_digest
from ..obs.spans import NULL_SPAN, span
from ..obs.trace import now_us, trace_scope
from ..perf.cycle_model import telemetry_cost
from ..runtime import sharding as shd
from ..runtime.fault import EngineDead
from .deadline import Decision, DeadlineTracker, WindowShed
from .stream_engine import (GATE_ADMIT, GATE_ESCALATE, GATE_SHED,
                            StreamEngine, window_leaves)

# the deadline tracker's Decision values are fed straight into
# StreamEngine._assemble's gate protocol; pin the alignment here, the one
# module that imports both layers
assert (GATE_ADMIT, GATE_ESCALATE, GATE_SHED) == (
    Decision.ADMIT, Decision.ESCALATE, Decision.SHED)


def _detach_frames(exc) -> None:
    """Keep the stack of a worker's fatal exception (and of the exceptions
    it was raised from) as a note on it, and drop its frames. A worker's
    frames hold the engine (``self``) and the engine holds its death, so
    with the frames kept a dead engine, and on the card its graph family,
    would be freed only when the cyclic garbage collector finds the cycle:
    a supervisor's rebuilds would pile dead families up. The note is
    printed with the exception, so no line of the stack is lost."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if exc.__traceback__ is not None:
            exc.add_note("worker stack:\n" + "".join(
                traceback.format_tb(exc.__traceback__)).rstrip())
            exc.__traceback__ = None
        exc = exc.__cause__ or exc.__context__


def _on(stream):
    """``torch.cuda.stream(stream)``, or nothing on the CPU."""
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()


@dataclasses.dataclass(eq=False)
class Shard:
    """One mesh device's part of a sharded engine: slots [lo, hi), their
    rows of the state, the device's item memory, a stream and a graph
    family (None on the CPU, and the family None with ``jit=False``)."""
    device: torch.device
    lo: int
    hi: int
    state: TorrState
    im: ItemMemory
    stream: torch.cuda.Stream | None
    graphs: capture.GraphFamily | None
    pad: tuple | None = None    # pad lanes on the device

    def on(self):
        """The shard's device and stream as the current ones (nothing on
        the CPU)."""
        stack = contextlib.ExitStack()
        if self.stream is not None:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self.stream))
        return stack


class AsyncStreamEngine(StreamEngine):
    """Dispatch/collect split over the slot scheduler; futures per window."""

    _ENGINE = "async"

    def __init__(self, cfg: TorrConfig, im: ItemMemory, n_slots: int = 16,
                 jit: bool = True, serial: bool = False,
                 fused: str | None = None, bucket_cap: int | None = None,
                 decide: str | None = None, mesh=None,
                 pipeline_depth: int = 2,
                 tracker: DeadlineTracker | None = None, governor=None,
                 paused: bool = False, metrics=None, flight=None,
                 tracer=None, store=None, snapshot_every: int = 1,
                 fault_plan=None, *, device=None):
        if governor is not None and tracker is None:
            raise ValueError(
                "the QoS governor is slack-driven: pass a DeadlineTracker "
                "alongside governor=")
        sharded = mesh is not None and np.size(mesh.devices) > 1
        if sharded and serial:
            raise ValueError(
                "the serial lowering runs the slots one after another and "
                "cannot shard the stream axis; use serial=False with a mesh")
        self._mesh = mesh if sharded else None
        self._shards = None
        devs = None
        if sharded:
            devs = [torch.device(d) for d in mesh.devices]
            kinds = {d.type for d in devs}
            if device is not None:
                kinds.add(torch.device(device).type)
            if len(kinds) != 1:
                raise ValueError(f"the mesh's devices {devs} and device="
                                 f"{device} are of different kinds")
            device = devs[0]
            n_slots = shd.pad_stream_slots(n_slots, mesh)
        device = resolve_device(device)
        self._stream = (torch.cuda.Stream(device)
                        if device.type == "cuda" and not sharded else None)
        if self._stream is not None:
            # the item memory, the state and any tensor the caller made
            # before are ready before the dispatcher's stream reads them
            self._stream.wait_stream(torch.cuda.current_stream(device))
        with _on(self._stream):
            super().__init__(cfg, im, n_slots=n_slots, jit=jit,
                             serial=serial, fused=fused,
                             bucket_cap=bucket_cap, decide=decide,
                             metrics=metrics, flight=flight, tracer=tracer,
                             store=store, snapshot_every=snapshot_every,
                             fault_plan=fault_plan, device=device)
        if sharded:
            self._split(devs, jit)
        # async phase spans (the sync step() spans are unused here); each
        # runs on exactly one daemon thread
        sp = (lambda name: span(name, metrics)) \
            if metrics is not None or tracer is not None \
            else (lambda name: NULL_SPAN)
        self._sp_decide = sp("host_decide")
        self._sp_device = sp("device_step")
        self._sp_drain = sp("collector_drain")
        self._last_slack = None
        self._tracker = tracker
        self._governor = governor

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)     # backlog arrived
        self._settled = threading.Condition(self._lock)  # a window resolved
        self._inflight = 0      # submitted windows not yet resolved
        self._stop = False
        self._error: BaseException | None = None
        self._collect_q: queue.Queue = queue.Queue(
            maxsize=max(1, pipeline_depth))
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="torr-dispatch", daemon=True)
        self._collector = threading.Thread(
            target=self._collect_loop, name="torr-collect", daemon=True)
        self._started = False
        if not paused:
            self.start()

    # -- shards -------------------------------------------------------------

    def _split(self, devs, jit: bool) -> None:
        """Give each mesh device its shard: its rows of the state made by
        the base class, the item memory copied once a device, a stream and
        a graph family of its own."""
        states = shd.split_streams(self._state, self._mesh)
        del self._state         # the shards own the rows from here on
        ims = {self.device: self.im}
        self.graphs = None
        self._shards = []
        for (lo, hi), dev, state in zip(
                shd.stream_rows(self.n_slots, self._mesh), devs, states):
            if dev not in ims:
                ims[dev] = self.im.to(dev)
            stream = None
            if dev.type == "cuda":
                # the rows and the item memory were copied on the caller's
                # stream: the shard's stream reads them after
                stream = torch.cuda.Stream(dev)
                stream.wait_stream(torch.cuda.current_stream(dev))
            self._shards.append(Shard(
                dev, lo, hi, state, ims[dev], stream,
                capture.GraphFamily() if jit and stream is not None
                else None))

    @property
    def shards(self) -> list | None:
        """The engine's :class:`Shard` s (None without a mesh of several
        devices)."""
        return self._shards

    def _shard_of(self, slot: int) -> int:
        return slot // (self.n_slots // len(self._shards))

    @property
    def state(self) -> TorrState:
        """The whole state; with shards, their rows joined on the first
        shard's device (a copy, for callers: never on the hot path)."""
        if self._shards is None:
            return self._state
        with self._lock:
            shards = [(sh, sh.state) for sh in self._shards]
        for sh, _ in shards:
            if sh.stream is not None:
                torch.cuda.current_stream(sh.device).wait_stream(sh.stream)
        return shd.join_streams([st for _, st in shards], self.device)

    def _reset_slot(self, slot: int, task_w, snapshot) -> None:
        if self._shards is None:
            super()._reset_slot(slot, task_w, snapshot)
            return
        k, state, row = self._rows_of(slot)
        sh = self._shards[k]
        with sh.on():
            sh.state = self._reset_row(state, row, task_w, snapshot)

    def _rows_of(self, slot: int):
        if self._shards is None:
            return super()._rows_of(slot)
        k = self._shard_of(slot)
        sh = self._shards[k]
        return k, sh.state, slot - sh.lo

    def _window(self, stream_id, q_packed, valid, boxes) -> tuple:
        """One submitted window's leaves (``window_leaves``) on its slot's
        device. A tensor on the card was made on the caller's stream and
        is read on the dispatcher's (or its shard's): the reads are
        ordered after the writes, and its memory kept from reuse until
        that stream is past them; with shards it is first copied to its
        shard's card when it was made on another."""
        if self._shards is None:
            dev, stream = self.device, self._stream
        else:
            with self._lock:
                sh = self._shards[self._shard_of(self._slot_of[stream_id])]
            dev, stream = sh.device, sh.stream
        leaves = window_leaves(dev, q_packed, valid, boxes)
        if not any(isinstance(x, torch.Tensor) for x in leaves):
            return leaves
        if self._shards is not None:
            leaves = tuple(x.to(dev) if isinstance(x, torch.Tensor) else x
                           for x in leaves)
        stream.wait_stream(torch.cuda.current_stream(dev))
        for x in leaves:
            if isinstance(x, torch.Tensor):
                x.record_stream(stream)
        return leaves

    def _gather(self, i, lanes, buf):
        """With shards and a lane on the card: one stack a shard, on its
        device (a list); else the base class's gather."""
        if self._shards is None or not any(
                isinstance(x, torch.Tensor) for x in lanes.values()):
            return super()._gather(i, lanes, buf)
        out = []
        for sh in self._shards:
            with sh.on():
                if sh.pad is None:
                    sh.pad = self._pad_lanes(sh.device)
                out.append(self._stack_lanes(lanes, range(sh.lo, sh.hi),
                                             sh.pad[i], sh.device))
        return out

    def _launch(self, q, v, b, qd) -> list:
        """Dispatch one assembled batch: ``[((out, tel), ready)]``, one
        entry a shard (one without shards), ``ready`` the event after the
        shard's step (None on the CPU)."""
        if self._shards is None:
            out, tel = self._dispatch(q, v, b, qd)
            return [((out, tel), self._ready_event())]
        fused, bucket_cap, decide = self._resolve_fused()
        self._last_resolved = (fused, bucket_cap, decide)
        batches = []
        for k, sh in enumerate(self._shards):
            with sh.on():
                batches.append(StreamBatch(*(
                    x[k] if isinstance(x, list) else
                    x[sh.lo:sh.hi].to(sh.device, non_blocking=True)
                    for x in (q, v, b, qd))))
        results, readys = self._step_shards(batches, fused, bucket_cap,
                                            decide)
        for sh, (state, _out, _tel) in zip(self._shards, results):
            sh.state = state
        return [((out, tel), ready)
                for (_state, out, tel), ready in zip(results, readys)]

    def _step_shards(self, batches, fused, bucket_cap, decide):
        """One step on every shard in turns; each shard's (state, out,
        tel) and the event after its step."""
        steps = [pipeline.stream_batch_phases(
            sh.state, sh.im, batch, self.cfg, serial=self._serial,
            plan=self._plan, fused=fused, bucket_cap=bucket_cap,
            decide=decide, graphs=sh.graphs,
            cap_rows=self.n_slots * self.cfg.N_max)
            for sh, batch in zip(self._shards, batches)]
        results = pipeline.run_in_turns(steps,
                                        [sh.on for sh in self._shards])
        readys = [None if sh.stream is None else sh.stream.record_event()
                  for sh in self._shards]
        return results, readys

    def _warm(self) -> None:
        """The base class's warm-up, or with shards one all-pad step on
        every shard (a state no-op), its outputs copied to the host."""
        if self._shards is None:
            super().warmup()
            return
        fused, bucket_cap, decide = self._resolve_fused()
        batches = []
        for sh in self._shards:
            with sh.on():
                batches.append(self._empty_batch(sh.hi - sh.lo, sh.device))
        results, readys = self._step_shards(batches, fused, bucket_cap,
                                            decide)
        self._rows_to_host([(out, tel) for _st, out, tel in results],
                           readys)
        self.sync()

    def sync(self) -> None:
        """Block until the work launched on the engine's streams has
        finished (every shard's, with shards)."""
        if self._shards is None:
            super().sync()
            return
        for sh in self._shards:
            if sh.stream is not None:
                sh.stream.synchronize()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Start the dispatch/collect threads (no-op if already running)."""
        if not self._started:
            self._started = True
            self._dispatcher.start()
            self._collector.start()

    def close(self, drain: bool = True) -> None:
        """Stop the runtime; drain (default) or cancel the backlog first.

        Threads are always joined; a drain failure (worker death) is
        re-raised after shutdown completes."""
        if not self._started:
            return
        drain_err: BaseException | None = None
        if drain:
            try:
                self.flush()
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                drain_err = e
        cancelled = []
        with self._work:
            if not drain:
                for dq in self._pending:
                    while dq:
                        cancelled.append(dq.popleft()[3])
                        self._inflight -= 1
                self._settled.notify_all()
            self._stop = True
            self._work.notify_all()
        for fut in cancelled:   # done-callbacks must not run under the lock
            fut.cancel()
        self._dispatcher.join()
        self._collect_q.put(None)
        self._collector.join()
        self._started = False
        if drain_err is not None:
            raise drain_err

    def abandon(self) -> None:
        """Stop signal without joining the worker threads.

        The supervisor's recovery path runs under its own lock, which a
        collector in the middle of a delivery may be waiting on inside a
        done-callback: ``close()``'s joins would deadlock there. Workers
        see the stop flag and exit on their own; windows queued but not
        delivered stay pending on the supervisor's journal and are
        replayed by the replacement engine, and a late delivery from this
        engine is either bit-equal
        (the same snapshot lineage replayed) or dropped by the
        supervisor's epoch and status guards. A late snapshot cannot
        regress the store (its ``put`` is monotonic in ``window_seq``)."""
        if not self._started:
            return
        with self._work:
            self._stop = True
            self._work.notify_all()
        # unblock a dispatcher parked on a full collect queue (collector
        # death) and wake a collector parked on an empty one
        try:
            while True:
                self._collect_q.get_nowait()
        except queue.Empty:
            pass
        self._collect_q.put(None)
        self._started = False

    def __enter__(self) -> "AsyncStreamEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    def _check_error(self) -> None:
        if self._error is not None:
            # a fresh instance per caller (shared tracebacks across threads
            # mutate) with the same cause/inflight/thread payload
            dead = self._error
            raise EngineDead(cause=dead.cause, inflight=dead.inflight,
                             thread=dead.thread) from dead.cause

    # -- admission / submission (caller threads) ----------------------------

    def admit(self, stream_id, task_w, snapshot=None) -> int:
        with self._lock, _on(self._stream):
            return super().admit(stream_id, task_w, snapshot=snapshot)

    def retire(self, stream_id) -> None:
        """Drop the stream's backlog (cancelling its futures) and free its
        slot. Windows already dispatched to the device still resolve.

        Futures are cancelled *after* the lock is released: Future.cancel
        runs done-callbacks synchronously, and a callback that re-enters
        the engine (submit/flush) must not find the lock held."""
        with self._work:
            slot = self._slot_of[stream_id]
            cancelled = [w[3] for w in self._pending[slot]]
            self._inflight -= len(cancelled)
            super().retire(stream_id)
            self._settled.notify_all()
        for fut in cancelled:
            fut.cancel()

    def submit(self, stream_id, q_packed, valid, boxes) -> Future:
        """Enqueue one window; the future resolves to host-resident
        ``(WindowOutput, WindowTelemetry)`` numpy trees, or raises
        :class:`WindowShed` if admission control drops the window."""
        self._check_error()
        fut: Future = Future()
        arrival = self._tracker.now() if self._tracker else time.monotonic()
        ctx = (self._tracer.mint(stream_id, self._ENGINE)
               if self._tracer is not None else None)
        window = self._window(stream_id, q_packed, valid, boxes) + (
            fut, arrival, ctx)
        with self._work:
            self._pending[self._slot_of[stream_id]].append(window)
            self._inflight += 1
            self._work.notify()
        return fut

    def backlog(self, stream_id) -> int:
        with self._lock:
            return super().backlog(stream_id)

    def flush(self, timeout: float | None = None) -> None:
        """Block until every submitted window has resolved (result, shed or
        cancel). Raises on worker death; TimeoutError on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._settled:
            while self._inflight > 0:
                self._check_error()
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"flush timed out with {self._inflight} windows in "
                        "flight")
                self._settled.wait(timeout=left)
            self._check_error()

    # the synchronous one-step-at-a-time API is owned by the dispatcher here
    def step(self):
        raise NotImplementedError(
            "AsyncStreamEngine dispatches internally; use submit() futures")

    def drain(self):
        raise NotImplementedError(
            "AsyncStreamEngine dispatches internally; use flush()")

    # -- dispatcher ---------------------------------------------------------

    @staticmethod
    def _ctx_of(extra):
        # submit's trailing payload here is (future, arrival, ctx)
        return extra[2]

    def _assemble_admitted(self, deferred):
        """``StreamEngine._assemble`` under the RT admission gate.

        Must run under the lock. Shed windows are popped and replaced by the
        next queued window of the same slot; escalated windows get their
        queue-depth lane forced to >= cfg.q_hi; both mechanics live in
        ``StreamEngine._assemble``, this supplies the decision and the shed
        bookkeeping. Shed futures are appended to ``deferred`` as
        ``(future, exception)`` and resolved by the caller *outside* the
        lock (set_exception runs done-callbacks synchronously, and a
        callback may re-enter the engine)."""
        if self._tracker is None:
            return self._assemble()
        now = self._tracker.now()

        def gate(stream_id, backlog, extra):
            fut, arrival, ctx = extra
            decision = self._tracker.decide_head(arrival, backlog, now)
            if decision == Decision.SHED:
                self.stats.shed += 1
                if self._obs is not None:
                    self._obs.on_shed()
                # resolved, and taken off the in-flight count, by the
                # dispatch loop once the lock is released
                deferred.append((fut, WindowShed(
                    stream_id, self._tracker.lateness(arrival, now),
                    retry_after_s=self._tracker.retry_after_hint(backlog))))
                if ctx is not None:
                    # shed windows never reach a step: retire the context
                    # here so the tracer ring still accounts for them
                    ctx.decision = "shed"
                    self._tracer.complete(ctx)
            return decision

        return self._assemble(gate)

    def set_plan(self, plan) -> None:
        if self._governor is not None:
            raise RuntimeError(
                "the plan latch is owned by the armed QoS governor (it is "
                "re-latched every dispatched step); construct the engine "
                "without governor= to pin plans manually")
        super().set_plan(plan)

    def _govern(self, served) -> None:
        """Latch the governor's plan for the step about to dispatch.

        Must run under the lock. Slack is the *tightest* head window's
        remaining time to deadline; backlog is the deepest per-slot queue
        (each batched step drains one window per slot, so that is the
        number of steps still owed), read from the pending queues, not the
        batch's qd lanes, which the admission gate floors to cfg.q_hi for
        escalated windows."""
        if self._governor is None or not served:
            return
        now = self._tracker.now()
        wait = max(now - arrival for _sid, _slot, (_f, arrival, _c) in served)
        slack = self._tracker.policy.budget_s - wait
        backlog = max(len(self._pending[slot]) for _sid, slot, _x in served)
        self._plan = self._governor.update(
            slack, self._tracker.step_ema_s, backlog=backlog,
            n_windows=len(served))
        self._last_slack = slack

    def _fold_telemetry(self) -> None:
        # the dispatcher never waits on device telemetry; the collector
        # holds host-resident traces and feeds _observe_path_mix (and the
        # observer) from there
        pass

    def warmup(self) -> None:
        """Run the all-pad step outside any timed region (a state no-op);
        with a governor armed, at every ladder level, so each level's
        current key is captured before serving."""
        with self._lock, _on(self._stream):
            if self._governor is None:
                self._warm()
                return
            latched = self._plan
            try:
                for plan in self._governor.ladder:
                    self._plan = plan
                    self._warm()
            finally:
                self._plan = latched

    def _dispatch_loop(self) -> None:
        with _on(self._stream):
            self._dispatch_steps()

    def _dispatch_steps(self) -> None:
        deferred = []   # (future, exception) of windows shed under the lock
        served = []     # the windows of the step in hand
        try:
            while True:
                deferred = []
                served = []
                step_ctxs = None
                with self._work:
                    while not self._stop and not self.busy:
                        self._work.wait()
                    if self._stop:
                        break
                    if self._fault is not None:
                        # chaos injection: die at the planned step boundary
                        # with real backlog in flight
                        self._fault.maybe_fire("dispatcher", self.stats.steps)
                    # traced steps open a trace_scope over the decide and
                    # dispatch spans: _assemble populates step_ctxs with
                    # the admitted windows' contexts, and each span stamps
                    # its interval onto them at exit
                    scope = NULL_SPAN
                    if self._tracer is not None:
                        step_ctxs = self._step_ctxs = []
                        scope = trace_scope(step_ctxs)
                    try:
                        with scope:
                            with self._sp_decide:
                                q, v, b, qd, served = \
                                    self._assemble_admitted(deferred)
                                if served:
                                    self._govern(served)
                            if served:
                                # dispatch under the lock: admit/retire must
                                # not rewrite the state between assemble
                                # and the state's advance
                                with self._sp_dispatch:
                                    t0 = time.monotonic()
                                    parts = self._launch(q, v, b, qd)
                    finally:
                        self._step_ctxs = None
                    if served:
                        self.stats.steps += 1
                        self.stats.windows += len(served)
                        self.stats.pad_slots += self.n_slots - len(served)
                        # references to the post-step state; the collector
                        # copies and writes them after the step's windows
                        # are delivered
                        snaps = self._collect_snaps(served) \
                            if self._store is not None else None
                        rec = None
                        if self._obs is not None:
                            gov = None
                            if self._governor is not None:
                                gov = {
                                    "level": self._governor.level,
                                    "slack": self._last_slack,
                                    "energy_ewma_mj":
                                        self._governor.energy_ewma_mj,
                                }
                            rec = self._obs.on_dispatch(
                                len(served), self.n_slots - len(served),
                                requested=self._last_resolved,
                                plan=self._plan, gov=gov,
                                full_ewma=(self._full_ewma if self._auto
                                           else None))
                            if rec is not None and self._tracer is not None:
                                rec["ts_us"] = now_us()
                                rec["queue_depth"] = int(qd.max())
                for fut, exc in deferred:   # callbacks run lock-free here
                    fut.set_exception(exc)
                if deferred:
                    # a flush returns only after the shed futures resolved
                    with self._settled:
                        if self._error is None:
                            self._inflight -= len(deferred)
                        self._settled.notify_all()
                if not served:      # whole backlog shed this pass
                    continue
                # bounded queue = pipeline depth: block here (not holding
                # the lock) instead of racing ahead of the device
                self._collect_q.put(
                    (served, parts, t0, rec, step_ctxs, snaps))
                if self._error is not None:
                    # the collector died while we were blocked in put():
                    # _fail's drain ran before our item landed, so nobody
                    # will ever resolve it; fail it ourselves
                    self._drain_collect_failing(self._error)
                    break
        except BaseException as e:  # noqa: BLE001 (surfaced via futures)
            self._fail(e)
            # windows shed this pass were popped from _pending before the
            # crash, so _fail can't see them; resolve them here with their
            # intended shed exception, and fail the step in hand (a capture
            # or replay error) with the engine's death
            for fut, exc in deferred:
                if not fut.done():
                    fut.set_exception(exc)
            for _sid, _slot, (fut, _arrival, _ctx) in served:
                if not fut.done():
                    fut.set_exception(self._error)

    # -- collector ----------------------------------------------------------

    def _collect_loop(self) -> None:
        n_collected = 0
        try:
            while True:
                item = self._collect_q.get()
                if item is None:
                    break
                if self._fault is not None:
                    # chaos injection: die with this step's windows still
                    # unresolved (their futures fail via _fail)
                    self._fault.maybe_fire("collector", n_collected)
                n_collected += 1
                served, parts, t0, rec, ctxs, snaps = item
                # traced steps re-open their context scope on the collector
                # thread: the device/drain spans stamp onto the same
                # windows the dispatcher's spans did
                scope = trace_scope(ctxs) if ctxs else NULL_SPAN
                with scope:
                    with self._sp_device:
                        for _trees, ready in parts:
                            if ready is not None:
                                ready.synchronize()
                    dur = time.monotonic() - t0
                    with self._sp_drain:
                        digest = self._drain_item(served, parts, rec, dur,
                                                  snaps)
                # finish *after* the drain span exits so collector_drain is
                # part of the serialized per-window event list
                if ctxs:
                    self._trace_finish(ctxs, rec, digest)
        except BaseException as e:  # noqa: BLE001
            self._fail(e)

    def _drain_item(self, served, parts, rec, dur, snaps=None):
        """Move one retired step (``parts``: each shard's ((out, tel),
        ready)) to the host and resolve its windows; returns the step's
        telemetry digest (for trace completion), or None when nothing
        downstream needs it."""
        trees, readys = [t for t, _ in parts], [r for _, r in parts]
        # one device-to-host copy per leaf and shard, then numpy slicing
        out_h, tel_h = self._rows_to_host(trees, readys)
        if self._auto:
            # feed the load-aware dispatcher's path-mix EWMA from the
            # host-resident trace (never blocks the dispatcher)
            self._observe_path_mix(tel_h.path, tel_h.n_valid)
        digest = None
        if self._obs is not None:
            digest = self._obs.observe_step(tel_h, rec, step_latency_s=dur)
        elif self._tracer is not None:
            digest = telemetry_digest(tel_h)
        if self._tracker is not None:
            self._tracker.observe_step(dur)
        now = (self._tracker.now() if self._tracker
               else time.monotonic())
        for stream_id, slot, (fut, arrival, _ctx) in served:
            tel_w = map_tensors(lambda x: x[slot], tel_h)
            if self._governor is not None:
                # close the energy loop: price the plan the window actually
                # ran with (recorded in its telemetry); window_scale follows
                # the cycle model's convention (1.0 @ RT-60, 2.0 @ RT-30)
                budget_s = self._tracker.policy.budget_s
                wc = telemetry_cost(tel_w, self.cfg, budget_s,
                                    window_scale=60.0 * budget_s)
                self._governor.observe_energy(wc.energy_j * 1e3)
            if fut.cancelled():
                # orphaned mid-flight (stream retired): nobody consumes
                # it; count the loss and keep it out of the deadline
                # envelope too
                self.stats.telemetry_dropped += 1
                if self._obs is not None:
                    self._obs.drop(1)
                continue
            result = (map_tensors(lambda x: x[slot], out_h), tel_w)
            if self._tracker is not None:
                self._tracker.complete(arrival, now)
            fut.set_result(result)
        with self._settled:
            self._inflight -= len(served)
            self._settled.notify_all()
        if snaps:
            # written strictly after the set_result loop above: a snapshot
            # whose window_seq covers a window implies that window's result
            # was delivered, which keeps the cross-process resume (skip the
            # first latest_seq windows) gap-free; duplicates on a replay are
            # fine (at-least-once)
            self._put_snaps(snaps, readys)
        return digest

    def _drain_collect(self) -> list:
        """Empty the collect queue; returns the drained windows' futures."""
        futs = []
        while True:
            try:
                item = self._collect_q.get_nowait()
            except queue.Empty:
                return futs
            if item is not None:
                # these steps were served on the device, but their
                # telemetry never reached the fold: the silent loss the
                # telemetry_dropped counter exists for
                self.stats.telemetry_dropped += len(item[0])
                if self._obs is not None:
                    self._obs.drop(len(item[0]))
                futs.extend(f for _sid, _slot, (f, _arr, _c) in item[0])

    def _drain_collect_failing(self, exc: BaseException) -> None:
        for fut in self._drain_collect():
            if not fut.cancelled():
                fut.set_exception(exc)

    def _fail(self, exc: BaseException) -> None:
        """Worker died: fail every queued future and wake all waiters.

        The raw exception is wrapped into a typed :class:`EngineDead`
        carrying the cause, the in-flight window count at the moment of
        death, and which worker died. Futures are resolved after the lock
        is released: set_exception runs done-callbacks synchronously, and
        one may re-enter the engine."""
        tname = threading.current_thread().name
        role = {"torr-dispatch": "dispatcher",
                "torr-collect": "collector"}.get(tname, tname)
        _detach_frames(exc.cause if isinstance(exc, EngineDead) else exc)
        doomed = []
        with self._work:
            dead = exc if isinstance(exc, EngineDead) else EngineDead(
                cause=exc, inflight=self._inflight, thread=role)
            self._error = dead
            self._stop = True
            for dq in self._pending:
                while dq:
                    doomed.append(dq.popleft()[3])
            # if the collector died, drain its queue so a back-pressured
            # dispatcher blocked in put() unblocks; the dispatcher re-drains
            # after its put in case its in-flight item landed post-drain
            doomed.extend(self._drain_collect())
            self._inflight = 0
            self._settled.notify_all()
            self._work.notify_all()
        for fut in doomed:
            if not fut.cancelled():
                fut.set_exception(dead)

    # -- telemetry ----------------------------------------------------------

    @property
    def tracker(self) -> DeadlineTracker | None:
        return self._tracker

    @property
    def governor(self):
        return self._governor

    def deadline_summary(self) -> Dict | None:
        """Jitter/miss-rate envelope (cycle-model-compatible keys)."""
        return self._tracker.summary() if self._tracker else None

    def governor_summary(self) -> Dict | None:
        """Plan level / switch / energy telemetry of the QoS governor."""
        return self._governor.summary() if self._governor else None
