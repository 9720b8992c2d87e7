"""Async multi-stream serving runtime: the dispatch/collect split (port of
``repro.serving.async_engine`` on one card).

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

One card: ``mesh=`` takes None or a mesh of one device (anything with a
one-element ``devices``); the port does not shard the stream slots.

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
import queue
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Dict

import numpy as np
import torch

from ..core.item_memory import ItemMemory
from ..core.types import TorrConfig, map_tensors
from ..device import resolve_device
from ..obs.bridge import telemetry_digest
from ..obs.spans import NULL_SPAN, span
from ..obs.trace import now_us, trace_scope
from ..perf.cycle_model import telemetry_cost
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
        if mesh is not None and np.size(getattr(mesh, "devices", ())) != 1:
            raise ValueError(
                "the port serves one card: mesh= takes None or a mesh of "
                "one device")
        device = resolve_device(device)
        self._stream = (torch.cuda.Stream(device)
                        if device.type == "cuda" else None)
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
        leaves = window_leaves(self.device, q_packed, valid, boxes)
        cuda = [x for x in leaves if isinstance(x, torch.Tensor)]
        if cuda:
            # made on the caller's stream, read on the dispatcher's: order
            # the reads after the writes, and keep the memory from reuse
            # until the dispatcher's stream is past them
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            for x in cuda:
                x.record_stream(self._stream)
        window = leaves + (fut, arrival, ctx)
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
                super().warmup()
                return
            latched = self._plan
            try:
                for plan in self._governor.ladder:
                    self._plan = plan
                    super().warmup()
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
                                    out, tel = self._dispatch(q, v, b, qd)
                                    ready = self._ready_event()
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
                    (served, out, tel, t0, rec, step_ctxs, ready, snaps))
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
                served, out, tel, t0, rec, ctxs, ready, snaps = item
                # traced steps re-open their context scope on the collector
                # thread: the device/drain spans stamp onto the same
                # windows the dispatcher's spans did
                scope = trace_scope(ctxs) if ctxs else NULL_SPAN
                with scope:
                    with self._sp_device:
                        if ready is not None:
                            ready.synchronize()
                    dur = time.monotonic() - t0
                    with self._sp_drain:
                        digest = self._drain_item(served, out, tel, rec,
                                                  dur, ready, snaps)
                # finish *after* the drain span exits so collector_drain is
                # part of the serialized per-window event list
                if ctxs:
                    self._trace_finish(ctxs, rec, digest)
        except BaseException as e:  # noqa: BLE001
            self._fail(e)

    def _drain_item(self, served, out, tel, rec, dur, ready, snaps=None):
        """Move one retired step to the host and resolve its windows;
        returns the step's telemetry digest (for trace completion), or None
        when nothing downstream needs it."""
        # one device-to-host copy per leaf, then cheap numpy slicing
        out_h, tel_h = self._to_host((out, tel), ready)
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
            self._put_snaps(snaps, ready)
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
