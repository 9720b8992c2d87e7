"""Profiling spans: nestable wall-clock timers feeding latency histograms
(port of ``repro.obs.spans``).

``span("device_step")`` times a region and observes the duration into the
``torr_span_duration_seconds{span="device_step"}`` histogram of a
:class:`~repro_torch.obs.metrics.MetricsRegistry`. The engines wrap their four
phases with these — dispatcher enqueue, device step, collector drain, and
the host decide/observe work — so the sync-vs-async overlap and the
host/device time split are readable live off ``/metrics``.

Spans nest: a thread-local stack tracks the active chain, and
:func:`current_span` exposes the innermost name (used by tests and handy
for debugging instrumentation placement). Nesting records each level
independently — parent durations *include* child durations, matching what
a sampling profiler would attribute.

Cost model: one ``perf_counter`` pair + one histogram observe per enter/
exit. With no registry wired (``registry=None``) entering a span is a
no-op stack push, so instrumented code paths stay below the 3% overhead
gate even when observability is off.

Causal linking: every span exit additionally offers its interval to
:func:`repro_torch.obs.trace.record_span` — when a :class:`~repro_torch.obs.trace.
trace_scope` is active on the thread, the span is stamped onto the
in-flight windows' :class:`~repro_torch.obs.trace.TraceContext`\\ s, turning the
histogram's anonymous samples into causally-linked per-window events.
With no scope active the hook is one thread-local ``getattr``.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Optional

from .metrics import LATENCY_BUCKETS_S, MetricsRegistry
from .trace import record_span

SPAN_METRIC = "torr_span_duration_seconds"

_tls = threading.local()


class _NullSpan:
    """Do-nothing span for uninstrumented engines: the hot path pays two
    empty method calls per phase, nothing else (no stack push, no clock)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def _stack():
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current_span() -> Optional[str]:
    """Name of the innermost active span on this thread, if any."""
    stack = _stack()
    return stack[-1] if stack else None


def span_stack() -> tuple:
    """The active span chain on this thread, outermost first."""
    return tuple(_stack())


class span:
    """Context manager / decorator timing one named region.

    ``with span("collector_drain", registry): ...`` or::

        @span("host_decide", registry)
        def decide(...): ...

    The decorator form is thread-safe (per-call start times live on the
    call frame). A context-manager *instance* holds its start time, so
    don't share one instance across threads — construct per use, or keep
    one per single-threaded phase (what the engines do); construction
    after the first call is just a dict hit in the registry.
    """

    __slots__ = ("name", "_hist", "_t0")

    def __init__(self, name: str, registry: Optional[MetricsRegistry] = None):
        self.name = name
        if registry is None:
            self._hist = None
        else:
            self._hist = registry.histogram(
                SPAN_METRIC,
                "Wall-clock duration of instrumented serving phases.",
                ["span"], buckets=LATENCY_BUCKETS_S,
            ).labels(span=name)
        self._t0 = 0.0

    def __enter__(self):
        _stack().append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        stack = _stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        if self._hist is not None:
            self._hist.observe(dur)
        record_span(self.name, self._t0, dur)
        return False

    def __call__(self, fn):
        # decorator form: a fresh enter/exit per call, shared histogram
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            _stack().append(self.name)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dur = time.perf_counter() - t0
                stack = _stack()
                if stack and stack[-1] == self.name:
                    stack.pop()
                if self._hist is not None:
                    self._hist.observe(dur)
                record_span(self.name, t0, dur)
        return wrapper
