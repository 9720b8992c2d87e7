"""Per-window causal trace contexts: the serving stack's timeline tier
(port of ``repro.obs.trace``).

Metrics and the flight ring are aggregates (histograms, counters, one
record a step), so a single slow window cannot be *attributed*: was it admission queueing,
the host decide pass, the device step, or the collector drain? This module
adds the causal layer. A :class:`TraceContext` is minted per submitted
window (monotone window ``seq``, stream id, slot, engine family) and
threaded through the engines' dispatcher → device → collector path; every
phase the engines already wrap in a :class:`~repro_torch.obs.spans.span` stamps
a ``(phase, ts_us, dur_us, thread)`` event onto the windows in flight, so
the span histograms' anonymous samples become causally-linked per-window
events — including across the async engine's dispatcher/collector thread
boundary, which is what lets :mod:`repro_torch.obs.trace_export` draw Perfetto
flow arrows between the two threads.

Mechanics
=========

* :class:`Tracer` mints contexts (one lock hit per ``submit``) and keeps
  the completed ones in a bounded ring (``dropped`` counts falls off the
  old end, surfaced as ``torr_trace_windows_dropped_total``).
* :class:`trace_scope` attaches a *list* of contexts to the current
  thread. A :class:`~repro_torch.obs.spans.span` exiting while a scope is
  active calls :func:`record_span`, which stamps the span's interval onto
  every context in the scope. The list may be populated *during* the
  scope (the dispatcher's decide span opens before admission picks the
  step's windows) — stamping happens at span exit, when the step's
  composition is known.
* Timestamps are microseconds on a process-wide ``perf_counter`` epoch
  (:func:`now_us`), so events from different threads order correctly and
  Chrome-trace ``ts`` fields need no further normalization.

Cost model: with no tracer armed the only addition to the span hot path
is one thread-local ``getattr`` per span exit (:func:`record_span`'s
empty-scope early-out), which keeps the instrumented engines' overhead small. With a tracer armed the cost
is one list append per (span, in-flight window) pair per step — never on
a per-proposal path.

The per-window dict shape (:meth:`TraceContext.to_dict`) is embedded into
flight records under ``"trace"`` (see ``docs/observability.md``), which
is the input :mod:`repro_torch.obs.trace_export` renders to Chrome trace-event
JSON.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

TRACE_SCHEMA_VERSION = 1

# process-wide epoch: every trace timestamp is microseconds since import,
# comparable across threads (perf_counter is a single monotonic clock)
_EPOCH = time.perf_counter()


def now_us() -> float:
    """Microseconds since the process-wide trace epoch."""
    return (time.perf_counter() - _EPOCH) * 1e6


class TraceContext:
    """One window's causal timeline: identity, verdicts, phase events.

    Mutable by design — the dispatcher fills identity and the admission
    verdict, span exits append phase events (possibly from the collector
    thread), and the drain stamps the resolved plan/lowering read back
    off the step's telemetry. Single-writer per field: each field is
    owned by exactly one engine phase, so no lock is needed beyond the
    Tracer's mint/complete counters.
    """

    __slots__ = ("seq", "stream_id", "slot", "engine", "arrival_us",
                 "step", "decision", "plan", "lowering", "events",
                 "complete_us")

    def __init__(self, seq: int, stream_id, engine: str, arrival_us: float):
        self.seq = seq
        self.stream_id = stream_id
        self.engine = engine
        self.arrival_us = arrival_us
        self.slot: Optional[int] = None
        self.step: Optional[int] = None       # flight-record step index
        self.decision: Optional[str] = None   # admit / escalate / shed
        self.plan: Optional[dict] = None      # resolved (banks, planes[, level])
        self.lowering: Optional[dict] = None  # resolved (fused, decide, tier)
        self.events: List[dict] = []          # {phase, ts_us, dur_us, thread}
        self.complete_us: Optional[float] = None

    def stamp(self, phase: str, ts_us: float, dur_us: float,
              thread: Optional[str] = None) -> None:
        """Append one phase interval (``thread`` defaults to the caller's)."""
        self.events.append({
            "phase": phase, "ts_us": ts_us, "dur_us": dur_us,
            "thread": thread if thread is not None
            else threading.current_thread().name,
        })

    def to_dict(self) -> dict:
        """JSONL-ready dict — the flight record's ``"trace"`` entry shape."""
        return {
            "v": TRACE_SCHEMA_VERSION,
            "seq": self.seq,
            "stream": self.stream_id,
            "slot": self.slot,
            "engine": self.engine,
            "step": self.step,
            "decision": self.decision,
            "arrival_us": self.arrival_us,
            "complete_us": self.complete_us,
            "plan": self.plan,
            "lowering": self.lowering,
            "events": list(self.events),
        }


class Tracer:
    """Mints per-window contexts; keeps completed ones in a bounded ring.

    ``capacity`` bounds host memory exactly like the flight ring does
    (default 65536 windows ≈ tens of minutes of 60 FPS serving across 16
    streams); ``dropped`` counts contexts that fell off the old end,
    surfaced as ``torr_trace_windows_dropped_total`` when a registry is
    wired.
    """

    def __init__(self, capacity: int = 65536, metrics=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._seq = 0
        self._ring: deque = deque(maxlen=capacity)
        self.dropped = 0
        self._c_minted = self._c_dropped = None
        if metrics is not None:
            self._c_minted = metrics.counter(
                "torr_trace_windows_total",
                "Windows minted a causal trace context at submission.")
            self._c_dropped = metrics.counter(
                "torr_trace_windows_dropped_total",
                "Completed trace contexts that fell off the bounded ring.")

    def mint(self, stream_id, engine: str) -> TraceContext:
        """New context with the next window sequence number."""
        with self._lock:
            seq = self._seq
            self._seq += 1
        if self._c_minted is not None:
            self._c_minted.inc()
        return TraceContext(seq, stream_id, engine, now_us())

    @property
    def minted(self) -> int:
        with self._lock:
            return self._seq

    def complete(self, ctx: TraceContext) -> None:
        """Retire one context into the bounded ring (drain/shed time)."""
        if ctx.complete_us is None:
            ctx.complete_us = now_us()
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
                if self._c_dropped is not None:
                    self._c_dropped.inc()
            self._ring.append(ctx)

    def completed(self) -> List[TraceContext]:
        """Snapshot of the completed-window ring, oldest first."""
        with self._lock:
            return list(self._ring)


# -- span → context stamping --------------------------------------------------

_scope_tls = threading.local()


def _scope_stack() -> list:
    stack = getattr(_scope_tls, "stack", None)
    if stack is None:
        stack = _scope_tls.stack = []
    return stack


class trace_scope:
    """Attach a list of contexts to this thread for the enclosed region.

    Spans exiting inside the scope stamp their interval onto every
    context in ``ctxs`` *at exit time* — so a scope may be entered with
    an initially-empty list that the enclosed code populates (the
    dispatcher's decide span covers admission itself). Scopes nest; only
    the innermost receives span events (matching span nesting semantics:
    each level records independently).
    """

    __slots__ = ("ctxs",)

    def __init__(self, ctxs: List[TraceContext]):
        self.ctxs = ctxs

    def __enter__(self) -> "trace_scope":
        _scope_stack().append(self.ctxs)
        return self

    def __exit__(self, *exc) -> bool:
        stack = _scope_stack()
        if stack and stack[-1] is self.ctxs:
            stack.pop()
        return False


def record_span(name: str, t0_s: float, dur_s: float) -> None:
    """Stamp one finished span onto the innermost active scope's contexts.

    Called by :class:`repro_torch.obs.spans.span` on every exit; with no active
    scope this is one thread-local ``getattr`` and a truthiness check —
    the price untraced engines pay.
    """
    stack = getattr(_scope_tls, "stack", None)
    if not stack:
        return
    ts_us = (t0_s - _EPOCH) * 1e6
    dur_us = dur_s * 1e6
    thread = threading.current_thread().name
    for ctx in stack[-1]:
        ctx.stamp(name, ts_us, dur_us, thread)
