"""RT-deadline admission control for the serving runtime (Sec. 4.6; port of
``repro.serving.deadline``).

The paper's QoS controller guarantees RT-30/RT-60 per-window deadlines as
object counts vary. On the serving side that becomes *admission control*:
every submitted window carries an arrival time and inherits the operating
point's budget (``configs.torr_edge.rt_budget_s``); at dispatch time the
controller projects the window's completion from how long it has already
waited plus the engine's measured per-step latency (EMA), and picks one of

  * **ADMIT**     — projected completion makes the deadline; serve as-is.
  * **ESCALATE**  — at risk (projected lateness within the escalate margin,
    or the backlog behind it projects over budget): serve it, but force the
    queue-depth input of Alg. 1's load gate ``H(N, q)`` high so the policy
    escalates cheap bypass/delta paths and the queue drains faster.
  * **SHED**      — already unsalvageably late: drop the window and fail its
    future with :class:`WindowShed`, freeing the slot-step for fresher work.

:func:`decide` is a pure function of ``(wait, backlog, step_ema, policy)``
so the decision table is unit-testable without threads or clocks;
:class:`DeadlineTracker` owns the mutable bookkeeping (arrival stamps, the
step-latency EMA, miss/shed/escalate counters) and emits a latency summary
through ``perf.cycle_model.latency_summary`` — the same key vocabulary the
cycle-accurate model reports, so measured and simulated RT envelopes diff
directly.

``metrics=`` takes a :class:`~repro_torch.obs.metrics.MetricsRegistry` and
``slo=`` a :class:`~repro_torch.obs.slo.SLOMonitor` (any object with
``observe(missed)``).
"""
from __future__ import annotations

import dataclasses
import enum
import time

import numpy as np

from ..configs.torr_edge import rt_budget_s
from ..obs.metrics import LATENCY_BUCKETS_S
from ..perf.cycle_model import latency_summary


class Decision(enum.IntEnum):
    ADMIT = 0
    ESCALATE = 1
    SHED = 2


class WindowShed(Exception):
    """Set on a window's future when admission control sheds it.

    ``retry_after_s`` (when the shedding engine has a tracker projection)
    is the earliest resubmission delay for which the pure :func:`decide`
    table would return ADMIT again, assuming the backlog drains at the
    projected step cadence — supervised clients back off by it instead of
    hammering a saturated engine. None when no projection is available.
    """

    def __init__(self, stream_id, lateness_s: float, reason: str = "deadline",
                 retry_after_s: float | None = None):
        self.stream_id = stream_id
        self.lateness_s = lateness_s
        self.reason = reason
        self.retry_after_s = retry_after_s
        hint = "" if retry_after_s is None else \
            f"; retry after {retry_after_s * 1e3:.2f} ms"
        super().__init__(
            f"window for stream {stream_id!r} shed ({reason}; "
            f"projected {lateness_s * 1e3:.2f} ms past deadline{hint})"
        )


@dataclasses.dataclass(frozen=True)
class DeadlinePolicy:
    """Static thresholds for the pure decision function."""

    budget_s: float              # per-window deadline: arrival + budget_s
    escalate_margin_s: float     # lateness <= margin -> still salvageable
    allow_shed: bool = True      # False -> never drop, only escalate
    step_ema_alpha: float = 0.25 # EMA weight of the newest step latency
    step_init_s: float = 0.0     # optimistic prior before any step completes


def policy_for(rt: str = "RT-60", **overrides) -> DeadlinePolicy:
    """Policy for one of the paper's RT operating points (RT-30 / RT-60)."""
    budget = rt_budget_s(rt)
    base = DeadlinePolicy(budget_s=budget, escalate_margin_s=0.5 * budget)
    return dataclasses.replace(base, **overrides) if overrides else base


def decide(
    wait_s: float,
    backlog: int,
    step_s: float,
    policy: DeadlinePolicy,
) -> Decision:
    """Pure admission decision for the head window of one stream's queue.

    ``wait_s`` is how long the window has already queued since arrival,
    ``backlog`` is how many windows remain behind it, and ``step_s`` is the
    engine's projected per-step latency. The window's projected completion
    is ``wait_s + step_s``; its successors' is ``wait_s + (i+1) * step_s``.
    """
    lateness = wait_s + step_s - policy.budget_s
    if lateness > policy.escalate_margin_s and policy.allow_shed:
        return Decision.SHED
    if lateness > 0.0:
        return Decision.ESCALATE
    # on time itself, but a deep backlog projects the successors over budget
    if backlog > 0 and wait_s + (backlog + 1) * step_s > policy.budget_s:
        return Decision.ESCALATE
    return Decision.ADMIT


def retry_after_s(backlog: int, step_s: float, policy: DeadlinePolicy) -> float:
    """Earliest resubmission delay after a shed for which :func:`decide`
    would ADMIT a fresh window, under the drain model the decision table
    itself projects with (one window per ``step_s`` per slot, no new
    arrivals). A fresh window behind ``backlog`` others completes at
    ``(backlog + 1) * step_s``; whatever exceeds the budget is the wait:

        ``max(0, (backlog + 1) * step_s - budget_s)``

    After backing off by this, the remaining backlog projects exactly to
    the budget boundary and the table returns ADMIT (the property
    tests/test_deadline.py pins against :func:`decide` directly)."""
    return max(0.0, (backlog + 1) * step_s - policy.budget_s)


class DeadlineTracker:
    """Mutable deadline bookkeeping around the pure :func:`decide` table.

    A dispatcher consults :meth:`decide_head` per popped window; the code
    that waits for each step feeds :meth:`observe_step` (device step latency,
    EMA'd into the projection) and :meth:`complete` (per-window latency,
    miss accounting). ``clock`` is injectable for deterministic tests.

    ``slo`` optionally wires an SLO monitor (``observe(missed)``): every
    completion feeds it one hit/miss event, which is what turns the raw
    miss counter into multi-window burn rates against the RT miss budget.
    """

    def __init__(self, policy: DeadlinePolicy, clock=time.monotonic,
                 metrics=None, slo=None):
        self.policy = policy
        self._clock = clock
        self._slo = slo
        self._step_s = policy.step_init_s
        self._lat: list[float] = []
        self.completed = 0
        self.missed = 0
        self.shed = 0
        self.escalated = 0
        # optional metrics wiring: pre-created handles so the per-window
        # path is a dict hit + one unlocked increment
        self._m_dec = None
        if metrics is not None:
            dec = metrics.counter(
                "torr_deadline_decisions_total",
                "RT admission verdicts per popped head window.",
                ["decision"])
            self._m_dec = {d: dec.labels(decision=d.name.lower())
                           for d in Decision}
            self._m_miss = metrics.counter(
                "torr_deadline_miss_total",
                "Served windows that completed past their RT budget.")
            self._m_lat = metrics.histogram(
                "torr_window_latency_seconds",
                "Arrival to results-ready latency of served windows.",
                buckets=LATENCY_BUCKETS_S)

    def now(self) -> float:
        return self._clock()

    # -- projection inputs --------------------------------------------------

    @property
    def step_ema_s(self) -> float:
        return self._step_s

    def observe_step(self, dur_s: float) -> None:
        """Fold one measured dispatch->results-ready step latency into the EMA."""
        a = self.policy.step_ema_alpha
        self._step_s = dur_s if self._step_s <= 0.0 else \
            (1.0 - a) * self._step_s + a * dur_s

    # -- decisions / accounting ---------------------------------------------

    def decide_head(self, arrival_s: float, backlog: int,
                    now: float | None = None) -> Decision:
        now = self.now() if now is None else now
        d = decide(now - arrival_s, backlog, self._step_s, self.policy)
        if d == Decision.ESCALATE:
            self.escalated += 1
        elif d == Decision.SHED:
            self.shed += 1
        if self._m_dec is not None:
            self._m_dec[d].inc()
        return d

    def lateness(self, arrival_s: float, now: float | None = None) -> float:
        now = self.now() if now is None else now
        return (now - arrival_s) + self._step_s - self.policy.budget_s

    def retry_after_hint(self, backlog: int) -> float:
        """The :func:`retry_after_s` backoff for the current step EMA."""
        return retry_after_s(backlog, self._step_s, self.policy)

    def complete(self, arrival_s: float, now: float | None = None) -> float:
        """Record one served window's arrival->results latency."""
        now = self.now() if now is None else now
        lat = now - arrival_s
        self._lat.append(lat)
        self.completed += 1
        missed = lat > self.policy.budget_s
        if missed:
            self.missed += 1
            if self._m_dec is not None:
                self._m_miss.inc()
        if self._m_dec is not None:
            self._m_lat.observe(lat)
        if self._slo is not None:
            self._slo.observe(missed)
        return lat

    # -- telemetry ----------------------------------------------------------

    def summary(self) -> dict:
        """Latency/jitter/miss envelope, cycle-model-compatible keys."""
        s = latency_summary(np.asarray(self._lat), self.policy.budget_s)
        s.update({
            "completed": self.completed,
            "miss_count": self.missed,
            "shed": self.shed,
            "escalated": self.escalated,
            "step_ema_ms": self._step_s * 1e3,
        })
        return s
