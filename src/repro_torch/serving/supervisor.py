"""Supervised serving: engine restart, warm-start re-admission, replay
(port of ``repro.serving.supervisor``).

A :class:`ServeSupervisor` wraps either engine family behind the same
admit/submit/flush surface and turns worker death from a terminal event
into a bounded recovery:

1. **Detect**: any engine failure surfaces as a typed
   :class:`~repro_torch.runtime.fault.EngineDead` (cause-carrying,
   in-flight count at death). Pending futures fail with it, never with a
   bare RuntimeError, so clients tell a crash (replayable) from a
   :class:`~repro_torch.serving.deadline.WindowShed` (admission policy).
2. **Restart**: the supervisor rebuilds a fresh engine with the caller's
   ``factory`` under exponential backoff (``backoff_s * 2**(n-1)``,
   capped), bounded by ``max_restarts``.
3. **Warm-start re-admission**: every live stream re-admits into the new
   engine with its cache rows, task weights and ``acc_tag``s restored from
   the :class:`~repro_torch.serving.state_store.StateStore` snapshot the
   old engine wrote through; the engine's path-mix EWMA restores from the
   newest snapshot's meta.
4. **Replay**: the supervisor journals every submitted window until a
   store snapshot covers it. On recovery, journaled windows *after* the
   snapshot re-run in submission order: resolved ones rebuild the cache
   state silently (their outer futures stay resolved; shed windows are
   skipped, they never advanced state), unresolved ones re-dispatch into
   their original futures. At snapshot cadence 1 no silent re-run is
   needed; at coarser cadences the re-run prefix restores bit-identity as
   long as admission control cannot re-decide a replayed window.
5. **Crash-loop breaker**: ``breaker_restarts`` deaths inside
   ``breaker_window_s`` latch a cheap
   :class:`~repro_torch.control.plan.KnobPlan` (the bottom of
   ``control.governor.build_ladder`` unless ``degrade_plan`` overrides) on
   the rebuilt engine. Engines owned by a live governor keep their
   governor (the trip is then only recorded).

Observability: ``torr_engine_restarts_total``,
``torr_windows_replayed_total``, a ``torr_recovery_duration_seconds``
histogram, and ``engine_crash`` / ``engine_recovered`` epoch events in the
flight recorder.

On the card
===========

* **A rebuilt engine captures its graphs again.** Each engine owns its
  ``GraphFamily``; the rebuilt one is never handed the dead engine's,
  because the abandoned dispatcher may still be replaying one of its
  graphs, and two concurrent replays of one graph race on its static
  buffers. Every capture goes through ``core.capture.GraphFamily``, on
  whichever thread captures (the rebuilt async engine's dispatcher, a
  factory that warms its engine up on the thread that recovers, the
  thread that drives a sync engine's ``flush``): it holds the cyclic
  garbage collector off while it captures (``collection_paused``: a dead
  engine's graphs freed by a collection on a capturing thread would break
  the capture), and captures take turns across threads (entering one
  empties the caching allocator, which must not run beside another
  thread's capture). A dead async engine keeps no frame of its workers
  (``async_engine._detach_frames``), so it is freed, its graph family
  with it, as soon as its workers end. :attr:`recoveries` records, per
  rebuild, the seconds from the death to the first window the rebuilt
  engine resolved, and its captures.
* **Threads and streams.** A sync engine is stepped by the thread that
  calls :meth:`flush`, on that thread's stream; an async engine's device
  work stays on its dispatcher's stream. The journal may hold window
  tensors on the card, made on the submitting thread's stream: each
  carries an event recorded there at ``submit``, and a replay makes the
  stream of the thread that replays wait for it before the engine's
  ``submit``, which orders the engine's stream after it as every submit
  does.
* **Late deliveries.** An abandoned engine may still resolve a step or
  write a snapshot after its replacement starts. Its deliveries are kept
  only while the window is still pending (they are bit-equal to the
  replay's), its death flags are dropped by the epoch guard, and its
  snapshots cannot regress the store (``put`` is monotonic in
  ``window_seq``). Its worker threads end on their own;
  :meth:`join_abandoned` waits for them.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.capture import tree_map
from ..runtime.fault import EngineDead
from .async_engine import AsyncStreamEngine
from .deadline import WindowShed
from .state_store import StateStore
from .stream_engine import window_leaves

# window status in the replay journal
_PENDING, _DONE, _SHED = "pending", "done", "shed"


@dataclasses.dataclass
class _Window:
    seq: int                    # per-stream submission index (0-based)
    q: object                   # int32 words: host array or card tensor
    valid: object
    boxes: object
    outer: Future
    status: str = _PENDING
    ready: object = None        # event after the card leaves were made


@dataclasses.dataclass
class _Stream:
    sid: object
    task_w: np.ndarray
    next_seq: int = 0
    journal: collections.deque = dataclasses.field(
        default_factory=collections.deque)
    # sync engines return results positionally (FIFO per slot, no futures):
    # one entry per engine-submitted window, in submission order: the
    # _Window a result resolves, or None for a silent warm-start re-run
    # whose output is discarded. Rebuilt from scratch on every recovery.
    expect: collections.deque = dataclasses.field(
        default_factory=collections.deque)


def _host(tree):
    """A result tree as host numpy arrays (the sync engine's per-window
    slices; the async engine's results are host arrays already)."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


class ServeSupervisor:
    """Crash-supervised facade over a (re-buildable) stream engine.

    ``factory()`` must return a *fresh* engine each call, wired to the
    same :class:`StateStore` (and snapshot cadence) the supervisor reads
    on recovery, with no admitted streams; an async engine must be built
    ``paused=True`` (the supervisor starts it after the replay).
    """

    def __init__(
        self,
        factory: Callable[[], object],
        store: StateStore,
        *,
        max_restarts: int = 5,
        backoff_s: float = 0.02,
        backoff_cap_s: float = 1.0,
        breaker_restarts: int = 3,
        breaker_window_s: float = 30.0,
        degrade_plan=None,
        metrics=None,
        flight=None,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        self._factory = factory
        self.store = store
        self.max_restarts = max_restarts
        self._backoff_s = backoff_s
        self._backoff_cap_s = backoff_cap_s
        self._breaker_restarts = breaker_restarts
        self._breaker_window_s = breaker_window_s
        self._degrade_plan = degrade_plan
        self._flight = flight
        self._clock = clock
        self._sleep = sleep
        self.restarts = 0
        self.windows_replayed = 0
        self.windows_rerun = 0
        self.degraded = False
        # lock-free health flags: the gateway fast-fails requests on
        # `recovering` without queueing threads on self._lock, and
        # `terminal` marks a supervisor past max_restarts
        self.recovering = False
        self.terminal = False
        # one dict per rebuild: "dead_at" (the clock when the death was
        # handled), "rebuilt_s" (to the end of the re-admission and the
        # replay's submissions), "first_window_s" (to the first window the
        # rebuilt engine resolved), "replayed", "rerun", and "captures":
        # the rebuilt engine's captures as (segment, seconds) up to that
        # first window, or up to its own death if it resolved none
        self.recoveries: List[dict] = []
        self._abandoned: List[threading.Thread] = []
        self._recent_crashes: collections.deque = collections.deque()
        self._streams: Dict[object, _Stream] = {}
        self._lock = threading.RLock()
        self._dead: Optional[EngineDead] = None  # flagged by callbacks
        self._epoch = 0   # bumped per rebuild; stale callbacks are ignored
        self._m_restarts = self._m_replayed = self._h_recovery = None
        self._m_dropped = None
        if metrics is not None:
            from ..obs.metrics import LATENCY_BUCKETS_S
            self._m_restarts = metrics.counter(
                "torr_engine_restarts_total",
                "Supervised engine rebuilds after worker death.")
            self._m_replayed = metrics.counter(
                "torr_windows_replayed_total",
                "Unresolved in-flight windows re-dispatched after a "
                "restart.")
            self._h_recovery = metrics.histogram(
                "torr_recovery_duration_seconds",
                "Crash detection to replay-complete recovery latency.",
                buckets=LATENCY_BUCKETS_S)
            self._m_dropped = metrics.counter(
                "torr_telemetry_dropped_total",
                "Observed steps/windows lost before telemetry was folded.")
        self.engine = factory()
        self._async = isinstance(self.engine, AsyncStreamEngine)

    # -- stream lifecycle ----------------------------------------------------

    def admit(self, stream_id, task_w) -> int:
        """Admit a stream, warm-starting it if the store already holds a
        snapshot (a previous *process* served it and died: cross-process
        resume). The journal's sequence numbers continue from the
        snapshot's ``window_seq``, so the caller must skip that many
        already-served windows of its (deterministic) input stream."""
        with self._lock:
            self._heal_if_dead()
            task_w = np.asarray(task_w, np.float32)
            snap = self.store.get(stream_id)
            slot = self._call_engine(
                lambda: self.engine.admit(stream_id, task_w, snapshot=snap))
            rec = _Stream(sid=stream_id, task_w=task_w)
            if snap is not None:
                rec.next_seq = int(snap.window_seq)
            self._streams[stream_id] = rec
            return slot

    def retire(self, stream_id) -> None:
        """Retire a stream cleanly: slot freed, session state deleted."""
        with self._lock:
            self._heal_if_dead()
            self._streams.pop(stream_id, None)
            try:
                self.engine.retire(stream_id)
            except EngineDead:
                pass    # the rebuilt engine will simply not re-admit it
            self.store.delete(stream_id)

    def submit(self, stream_id, q_packed, valid, boxes) -> Future:
        """Enqueue one window; the returned future survives engine death:
        it resolves once the window is served (possibly by a rebuilt
        engine) or fails with ``WindowShed`` / terminal ``EngineDead``."""
        with self._lock:
            self._heal_if_dead()
            rec = self._streams[stream_id]
            dev = self.engine.device
            q, valid, boxes = window_leaves(dev, q_packed, valid, boxes)
            ready = None
            if any(isinstance(x, torch.Tensor) for x in (q, valid, boxes)):
                # the leaves were made on this thread's stream; a replay
                # from another thread waits for this event
                ready = torch.cuda.current_stream(dev).record_event()
            win = _Window(seq=rec.next_seq, q=q, valid=valid, boxes=boxes,
                          outer=Future(), ready=ready)
            rec.next_seq += 1
            rec.journal.append(win)
            self._call_engine(
                lambda: self._submit_inner(stream_id, rec, win))
            return win.outer

    def flush(self, timeout: float | None = None) -> None:
        """Serve until every submitted window has resolved, recovering
        through any number of worker deaths up to ``max_restarts``."""
        deadline = None if timeout is None else self._clock() + timeout
        while True:
            try:
                if self._async:
                    left = (None if deadline is None
                            else max(deadline - self._clock(), 0.0))
                    self.engine.flush(timeout=left)
                else:
                    self._drive_sync()
            except EngineDead as e:
                with self._lock:
                    self._recover(e)
                continue
            with self._lock:
                if self._dead is not None:
                    self._heal_if_dead()
                    continue
                if self._n_pending() == 0:
                    return
            if deadline is not None and self._clock() >= deadline:
                raise TimeoutError(f"flush timed out with "
                                   f"{self._n_pending()} windows pending")
            # pending windows but a clean, idle engine: a replay handed to
            # the engine is still settling; yield and re-enter the drain
            self._sleep(0.001)

    def close(self, drain: bool = True) -> None:
        if drain:
            self.flush()
        if self._async:
            try:
                self.engine.close(drain=False)
            except EngineDead:
                pass

    def __enter__(self) -> "ServeSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    def join_abandoned(self, timeout: float | None = None) -> bool:
        """Wait for the worker threads of every engine abandoned by a
        recovery to end; True when all have (a stray thread must not slow
        what runs next)."""
        deadline = None if timeout is None else self._clock() + timeout
        for t in list(self._abandoned):
            left = None if deadline is None else \
                max(0.0, deadline - self._clock())
            t.join(left)
        self._abandoned = [t for t in self._abandoned if t.is_alive()]
        return not self._abandoned

    # -- engine call guard ---------------------------------------------------

    def _call_engine(self, fn):
        """Run one engine call, recovering (and retrying) on EngineDead."""
        while True:
            try:
                return fn()
            except EngineDead as e:
                self._recover(e)

    def _heal_if_dead(self) -> None:
        if self._dead is not None:
            dead, self._dead = self._dead, None
            self._recover(dead)

    def heal(self) -> None:
        """Run any pending recovery *now*. The engine's death is only
        noticed inside submit/admit/flush; a network front with no
        traffic would otherwise sit on a dead engine until the next
        request pays the whole recovery latency: the gateway's pump
        thread calls this instead. Raises the terminal
        :class:`EngineDead` once ``max_restarts`` is exhausted."""
        with self._lock:
            self._heal_if_dead()

    # -- health (lock-free: read by the gateway's hot path) ------------------

    def health(self) -> dict:
        """Readiness snapshot for ``/readyz`` and gateway fast-fail."""
        return {
            "ready": not self.recovering and not self.terminal,
            "recovering": self.recovering,
            "terminal": self.terminal,
            "restarts": self.restarts,
            "degraded": self.degraded,
        }

    def retry_after_s(self) -> float:
        """Recovery-aware client backoff: the next restart's backoff
        sleep plus replay headroom; what a 503 during recovery carries
        as its Retry-After."""
        n = min(self.restarts + 1, 16)
        return min(self._backoff_s * (2.0 ** (n - 1)),
                   self._backoff_cap_s) + 0.05

    def _n_pending(self) -> int:
        return sum(1 for rec in self._streams.values()
                   for w in rec.journal if w.status == _PENDING)

    # -- submission plumbing -------------------------------------------------

    def _engine_submit(self, sid, win: _Window):
        """``engine.submit`` of a journaled window; a window on the card
        first orders this thread's stream after the stream that made it
        (the engine's submit orders its own stream after this thread's)."""
        if win.ready is not None:
            torch.cuda.current_stream(self.engine.device).wait_event(
                win.ready)
        return self.engine.submit(sid, win.q, win.valid, win.boxes)

    def _submit_inner(self, stream_id, rec: _Stream, win: _Window) -> None:
        if self._async:
            fut = self._engine_submit(stream_id, win)
            fut.add_done_callback(
                lambda f, w=win, r=rec, e=self._epoch:
                self._on_done(r, w, f, e))
        else:
            self._engine_submit(stream_id, win)
            rec.expect.append(win)

    def _on_done(self, rec: _Stream, win: _Window, fut: Future,
                 epoch: int = 0) -> None:
        """Inner-future resolution (collector thread). Engine death and
        cancellation leave the window pending for replay; everything else
        propagates to the caller-facing outer future. ``epoch`` is the
        engine generation that issued the inner future: an abandoned
        engine's collector may deliver late; its results are accepted
        only while the window is still pending (they are bit-equal to
        what the replay will produce), and its death flags are ignored so
        a stale crash cannot restart a healthy replacement."""
        if fut.cancelled():
            return
        exc = fut.exception()
        if isinstance(exc, EngineDead):
            with self._lock:
                if epoch == self._epoch and self._dead is None:
                    self._dead = exc
            return
        with self._lock:
            if win.status != _PENDING:
                return  # duplicate delivery (abandoned engine vs replay)
            win.status = _SHED if isinstance(exc, WindowShed) else _DONE
            self._trim(rec)
            if epoch == self._epoch:
                self._note_resolved()
        self._deliver(win, fut.result() if exc is None else None, exc)

    def _note_resolved(self) -> None:
        """Stamp the newest recovery's first window resolved by the rebuilt
        engine, and the captures it made to get there (under the lock)."""
        if self.recoveries and "first_window_s" not in self.recoveries[-1]:
            r = self.recoveries[-1]
            r["first_window_s"] = self._clock() - r["dead_at"]
            r["captures"] = _captures(self.engine)

    def _deliver(self, win: _Window, result, exc) -> None:
        """Resolve the caller-facing future, tolerating a gateway-side
        cancellation (client disconnected mid-flight): the window's state
        advance is kept, only the delivery is dropped, accounted in
        ``torr_telemetry_dropped_total``."""
        try:
            if exc is None:
                win.outer.set_result(result)
            else:
                win.outer.set_exception(exc)
        except BaseException:   # cancelled outer: InvalidStateError
            if self._m_dropped is not None:
                self._m_dropped.inc()

    def _trim(self, rec: _Stream) -> None:
        """Drop the journal prefix that is both resolved and covered by a
        store snapshot: those windows can never need replay."""
        if not rec.journal:
            return
        covered = self.store.latest_seq(rec.sid)
        while rec.journal and rec.journal[0].status != _PENDING \
                and rec.journal[0].seq < covered:
            rec.journal.popleft()

    # -- sync drive ----------------------------------------------------------

    def _drive_sync(self) -> None:
        """Step the sync engine until its backlog drains, resolving outer
        futures per served window; any step-time failure surfaces as a
        typed EngineDead for the shared recovery path. The engine runs on
        this thread's stream; results are copied to the host here."""
        eng = self.engine
        try:
            while eng.busy:
                results = eng.step()
                with self._lock:
                    for sid, out_tel in results.items():
                        rec = self._streams.get(sid)
                        if rec is None:
                            continue
                        win = rec.expect.popleft() if rec.expect else None
                        if win is None or win.status != _PENDING:
                            continue    # a silent warm-start re-run
                        win.status = _DONE
                        self._trim(rec)
                        self._note_resolved()
                        self._deliver(win, _host(out_tel), None)
            eng.flush_telemetry()  # fold deferred snapshots/telemetry through
        except EngineDead:
            raise
        except Exception as e:
            raise EngineDead(cause=e, inflight=self._n_pending(),
                             thread="dispatcher") from e

    # -- recovery ------------------------------------------------------------

    def _recover(self, dead: EngineDead) -> None:
        """Rebuild the engine, warm-start every stream, replay the journal.

        Caller must hold the lock (or be the only thread, pre-start)."""
        t0 = self._clock()
        self.restarts += 1
        self._dead = None
        self.recovering = True
        try:
            self._recover_locked(dead, t0)
        finally:
            self.recovering = False

    def _recover_locked(self, dead: EngineDead, t0: float) -> None:
        if self._m_restarts is not None:
            self._m_restarts.inc()
        if self._flight is not None:
            self._flight.record(
                event="engine_crash", ts_us=_now_us(),
                cause=f"{type(dead.cause).__name__}: {dead.cause}"
                if dead.cause is not None else None,
                thread=dead.thread, inflight=dead.inflight,
                restarts=self.restarts)
        if self.restarts > self.max_restarts:
            self.terminal = True
            self._fail_pending(dead)
            raise dead
        # crash-loop breaker bookkeeping (before the backoff sleep so the
        # window measures crash arrivals, not our own sleeps)
        self._recent_crashes.append(t0)
        while self._recent_crashes and \
                t0 - self._recent_crashes[0] > self._breaker_window_s:
            self._recent_crashes.popleft()
        trip = len(self._recent_crashes) >= self._breaker_restarts
        n = min(self.restarts, 16)
        self._sleep(min(self._backoff_s * (2.0 ** (n - 1)),
                        self._backoff_cap_s))
        old, self.engine = self.engine, None
        if self.recoveries and "captures" not in self.recoveries[-1]:
            self.recoveries[-1]["captures"] = _captures(old)
        if self._async and old is not None:
            try:
                # stop WITHOUT joining: a collector in mid-delivery may be
                # blocked on self._lock inside _on_done, so close()'s joins
                # would deadlock here. Its late deliveries are handled by
                # the epoch/status guards in _on_done.
                old.abandon()
            except BaseException:   # noqa: BLE001 (the old engine is gone)
                pass
            self._abandoned.extend(
                t for t in (old._dispatcher, old._collector) if t.is_alive())
        # the dead engine and its graph family are freed once its abandoned
        # workers end, on their own threads, which capture nothing
        del old
        self._epoch += 1
        # a new engine with a graph family of its own: every key is
        # captured again (never the dead engine's family, whose graphs the
        # abandoned dispatcher may still replay)
        self.engine = self._factory()
        self._async = isinstance(self.engine, AsyncStreamEngine)
        if trip and not self.degraded:
            self.degraded = True
            self._apply_degrade()
        elif self.degraded:
            self._apply_degrade()   # keep the cheap plan across rebuilds
        n_replayed = n_rerun = 0
        full_ewma = None
        for sid, rec in self._streams.items():
            snap = self.store.get(sid)
            self.engine.admit(sid, rec.task_w, snapshot=snap)
            base = snap.window_seq if snap is not None else 0
            if snap is not None and "full_ewma" in snap.meta:
                full_ewma = snap.meta["full_ewma"]
            rec.expect.clear()  # dead engine's positional results are gone
            # windows at or before the snapshot boundary are fully covered
            while rec.journal and rec.journal[0].seq < base \
                    and rec.journal[0].status != _PENDING:
                rec.journal.popleft()
            for win in rec.journal:
                if win.seq < base and win.status != _PENDING:
                    continue        # resolved & snapshotted (mixed prefix)
                if win.status == _SHED:
                    continue        # never advanced state: skip on replay
                if win.status == _DONE:
                    # silent re-run: rebuilds cache state between the
                    # snapshot boundary and the crash; output discarded
                    n_rerun += 1
                    self._engine_submit(sid, win)
                    if not self._async:
                        rec.expect.append(None)
                else:
                    n_replayed += 1
                    self._submit_inner(sid, rec, win)
        if full_ewma is not None:
            self.engine._full_ewma = float(full_ewma)
        dur = self._clock() - t0
        self.recoveries.append({"dead_at": t0, "rebuilt_s": dur,
                                "replayed": n_replayed, "rerun": n_rerun})
        if self._async:
            # a paused factory engine is started here, and only after the
            # replay submissions above, so the rebuilt dispatcher sees the
            # full replay backlog at once (the same drain schedule a
            # fault-free run would have used)
            self.engine.start()
        self.windows_replayed += n_replayed
        self.windows_rerun += n_rerun
        if self._m_replayed is not None and n_replayed:
            self._m_replayed.inc(n_replayed)
        if self._h_recovery is not None:
            self._h_recovery.observe(dur)
        if self._flight is not None:
            self._flight.record(
                event="engine_recovered", ts_us=_now_us(),
                duration_s=dur, replayed=n_replayed, rerun=n_rerun,
                restarts=self.restarts, degraded=self.degraded)

    def _apply_degrade(self) -> None:
        """Crash-loop graceful degradation: latch a cheap plan on the fresh
        engine. Governor-owned engines keep their governor: set_plan is
        refused there by design, so the trip is record-only."""
        if getattr(self.engine, "_governor", None) is not None:
            return
        plan = self._degrade_plan
        if plan is None:
            from ..control.governor import build_ladder
            plan = build_ladder(self.engine.cfg)[-1]
        self.engine.set_plan(plan)

    def _fail_pending(self, dead: EngineDead) -> None:
        for rec in self._streams.values():
            for win in rec.journal:
                if win.status == _PENDING and not win.outer.done():
                    win.status = _DONE
                    win.outer.set_exception(dead)

    # -- telemetry -----------------------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            return {
                "restarts": self.restarts,
                "windows_replayed": self.windows_replayed,
                "windows_rerun": self.windows_rerun,
                "degraded": self.degraded,
                "recovering": self.recovering,
                "terminal": self.terminal,
                "pending": self._n_pending(),
                "streams": len(self._streams),
            }


def _captures(engine) -> list:
    """The captures an engine's graph family made so far, as (segment,
    seconds); empty without a family (the CPU, ``jit=False``)."""
    graphs = getattr(engine, "graphs", None)
    return [] if graphs is None else list(graphs.captures)


def _now_us() -> float:
    from ..obs.trace import now_us
    return now_us()


def recovery_events(records) -> List[dict]:
    """The crash/recovery epoch events of a flight record stream, in
    order: the reconciliation source for ``torr_engine_restarts_total``
    and ``torr_windows_replayed_total``."""
    return [r for r in records
            if r.get("event") in ("engine_crash", "engine_recovered")]
