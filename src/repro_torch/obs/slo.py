"""RT-SLO burn-rate engine: multi-window alerting over the miss budget
(port of ``repro.obs.slo``).

TorR's headline serving claim is *temporal* — RT-30/RT-60 deadlines held
as object counts vary — so the observability tier needs to watch whether
the miss budget is actually *burning*, not just count misses. This module
implements the standard multi-window burn-rate construction (the SRE
workbook's alerting-on-SLOs recipe) adapted to window-count rolling
windows, which keeps the engine clock-free and unit-testable:

* The **SLO** is an objective fraction of served windows that must
  complete inside their RT budget (default 99%); the **miss budget** is
  ``1 - objective``.
* **Burn rate** over a rolling window of the last ``N`` completions is
  ``miss_rate / miss_budget`` — burn 1.0 consumes the budget exactly at
  the sustainable rate; burn 14.4 exhausts a 30-day budget in ~2 days.
* Alerting is **multi-window**: a threshold trips only when *both* the
  fast window (reacts quickly, noisy alone) and the slow window
  (confirms the burn is sustained) exceed it. Two levels:

    level  | condition (fast AND slow burn)  | default threshold
    ------ | ------------------------------- | -----------------
    PAGE=2 | ``>= page_burn``                | 14.4
    WARN=1 | ``>= warn_burn``                | 6.0
    OK=0   | otherwise                       |

:class:`SLOMonitor.observe` is fed one boolean per completed window by
:class:`~repro_torch.serving.deadline.DeadlineTracker.complete` (shed windows
never complete and are *not* SLO events — admission already paid for
them). State is exported three ways:

* gauges ``torr_slo_burn_rate{window=fast|slow}``, ``torr_slo_alert``
  (the level) and ``torr_slo_miss_budget_remaining`` (slow window);
* a flight event on every alert-level *transition* (an ``"slo"`` record
  in the flight ring, so the causal timeline shows when the budget
  started burning relative to plan/lowering changes);
* an optional ``on_alert(level, state)`` hook — the first concrete step
  toward the ROADMAP's trace-driven governor: ``Governor(..., slo=mon)``
  consults :attr:`alert_level` per update (WARN freezes plan recovery,
  PAGE forces one extra degrade step).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable, Optional

SLO_OK, SLO_WARN, SLO_PAGE = 0, 1, 2
ALERT_NAMES = ("ok", "warn", "page")


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Static thresholds for the burn-rate engine (all clock-free)."""

    objective: float = 0.99      # fraction of windows that must make the RT
    fast_window: int = 64        # completions in the fast rolling window
    slow_window: int = 512       # completions in the slow rolling window
    warn_burn: float = 6.0       # fast AND slow burn >= -> WARN
    page_burn: float = 14.4      # fast AND slow burn >= -> PAGE
    min_events: int = 8          # completions before the fast window alerts

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if self.fast_window < 1 or self.slow_window < self.fast_window:
            raise ValueError("need 1 <= fast_window <= slow_window")
        if self.warn_burn > self.page_burn:
            raise ValueError("warn_burn must not exceed page_burn")

    @property
    def miss_budget(self) -> float:
        return 1.0 - self.objective


def burn_rate(misses: int, total: int, miss_budget: float) -> float:
    """Burn of one rolling window: observed miss rate over the budget."""
    if total <= 0:
        return 0.0
    return (misses / total) / miss_budget


class SLOMonitor:
    """Mutable rolling-window state around the pure burn-rate math.

    Thread-safe: ``observe`` is called from the async collector while
    ``summary``/gauge scrapes happen on caller threads; one small lock
    per completed *window* (never per proposal).
    """

    def __init__(self, policy: SLOPolicy = SLOPolicy(), metrics=None,
                 flight=None,
                 on_alert: Optional[Callable[[int, dict], None]] = None):
        self.policy = policy
        self._flight = flight
        self._on_alert = on_alert
        self._lock = threading.Lock()
        self._fast: deque = deque(maxlen=policy.fast_window)
        self._slow: deque = deque(maxlen=policy.slow_window)
        self._fast_miss = 0
        self._slow_miss = 0
        self.completed = 0
        self.missed = 0
        self.alert_transitions = 0
        self._level = SLO_OK
        self._g_burn = None
        if metrics is not None:
            burn = metrics.gauge(
                "torr_slo_burn_rate",
                "Miss-budget burn rate over the rolling windows.", ["window"])
            self._g_burn = {"fast": burn.labels(window="fast"),
                            "slow": burn.labels(window="slow")}
            self._g_alert = metrics.gauge(
                "torr_slo_alert",
                "RT-SLO alert level (0 = ok, 1 = warn, 2 = page).")
            self._g_budget = metrics.gauge(
                "torr_slo_miss_budget_remaining",
                "Fraction of the slow-window miss budget still unspent.")

    # -- feed ---------------------------------------------------------------

    def observe(self, missed: bool) -> int:
        """Fold one completed window; returns the (possibly new) level."""
        with self._lock:
            if len(self._fast) == self._fast.maxlen:
                self._fast_miss -= self._fast[0]
            if len(self._slow) == self._slow.maxlen:
                self._slow_miss -= self._slow[0]
            m = 1 if missed else 0
            self._fast.append(m)
            self._slow.append(m)
            self._fast_miss += m
            self._slow_miss += m
            self.completed += 1
            self.missed += m
            fast, slow = self._burns_locked()
            level = self._level_for(fast, slow)
            transition = level != self._level
            if transition:
                self._level = level
                self.alert_transitions += 1
        if self._g_burn is not None:
            self._g_burn["fast"].set(fast)
            self._g_burn["slow"].set(slow)
            self._g_alert.set(level)
            self._g_budget.set(max(0.0, 1.0 - slow))
        if transition:
            state = {"level": level, "alert": ALERT_NAMES[level],
                     "burn_fast": fast, "burn_slow": slow,
                     "completed": self.completed}
            if self._flight is not None:
                self._flight.record(slo=state)
            if self._on_alert is not None:
                self._on_alert(level, state)
        return level

    # -- read side ----------------------------------------------------------

    def _burns_locked(self) -> tuple:
        budget = self.policy.miss_budget
        return (burn_rate(self._fast_miss, len(self._fast), budget),
                burn_rate(self._slow_miss, len(self._slow), budget))

    def _level_for(self, fast: float, slow: float) -> int:
        # multi-window: a level trips only when both windows agree, and
        # never before the fast window has seen min_events completions
        if len(self._fast) < self.policy.min_events:
            return SLO_OK
        if fast >= self.policy.page_burn and slow >= self.policy.page_burn:
            return SLO_PAGE
        if fast >= self.policy.warn_burn and slow >= self.policy.warn_burn:
            return SLO_WARN
        return SLO_OK

    @property
    def alert_level(self) -> int:
        with self._lock:
            return self._level

    def burn_rates(self) -> tuple:
        """(fast, slow) burn over the current rolling windows."""
        with self._lock:
            return self._burns_locked()

    def summary(self) -> dict:
        with self._lock:
            fast, slow = self._burns_locked()
            return {
                "objective": self.policy.objective,
                "completed": self.completed,
                "missed": self.missed,
                "burn_fast": fast,
                "burn_slow": slow,
                "alert": ALERT_NAMES[self._level],
                "alert_level": self._level,
                "alert_transitions": self.alert_transitions,
            }
