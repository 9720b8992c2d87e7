"""Fault tolerance (port of ``repro.runtime.fault``): the serving engines'
failure types and deterministic chaos injection, and the supervised
training loop with its straggler watchdog.

Training: :class:`TrainSupervisor` catches a step-time fault (an injected
:class:`InjectedFault`), restores the newest checkpoint (onto any device),
fast-forwards the data stream deterministically, and resumes; with a
deterministic step the result equals a run without the fault.

Straggler mitigation: on a synchronous fleet a slow host delays every
collective. The watchdog tracks a robust step-time median; a step exceeding
``straggler_factor`` x median raises a :class:`StragglerEvent`, and the
policy either (a) records-and-continues (jitter absorption), or (b) after
``max_consecutive_stragglers``, triggers a checkpoint and an eviction
callback (a restart without the slow host).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import numpy as np

from ..checkpoint.manager import CheckpointManager


class InjectedFault(RuntimeError):
    """Simulated node failure."""


class EngineDead(RuntimeError):
    """A serving engine's worker (dispatcher/collector thread) died.

    Carries the original cause and the number of in-flight windows at the
    moment of death, so callers can distinguish a crash from admission-control
    shedding (``WindowShed``) and know how much work needs replay. The
    message keeps the ``"worker died"`` phrasing of ``repro``'s, and the
    class subclasses RuntimeError as ``repro``'s does.
    """

    def __init__(self, cause: BaseException | None = None, inflight: int = 0,
                 thread: str | None = None):
        self.cause = cause
        self.inflight = inflight
        self.thread = thread
        where = f" ({thread})" if thread else ""
        why = f": {type(cause).__name__}: {cause}" if cause is not None else ""
        super().__init__(
            f"async engine worker died{where} with {inflight} windows "
            f"in flight{why}")


@dataclasses.dataclass
class FaultPlan:
    """Deterministic chaos injection for the serving engines.

    One fault, fired exactly once: on the named engine thread
    (``"dispatcher"`` or ``"collector"``; the sync ``StreamEngine`` plays
    both roles inside ``step()``), at the first step whose index is
    ``>= at_step``. The engines call :meth:`maybe_fire` at their step
    boundaries; firing raises :class:`InjectedFault`, which propagates
    through the engine's normal failure path (``_fail`` → futures fail
    with :class:`EngineDead`). ``kind`` is a free-form label stamped into
    the exception message.
    """

    at_step: int
    thread: str = "dispatcher"
    kind: str = "injected"
    fired: bool = False

    _THREADS = ("dispatcher", "collector")

    def __post_init__(self):
        if self.thread not in self._THREADS:
            raise ValueError(
                f"FaultPlan.thread must be one of {self._THREADS}, "
                f"got {self.thread!r}")

    def maybe_fire(self, thread: str, step: int) -> None:
        """Raise the planned fault if (thread, step) matches; else no-op."""
        if not self.fired and thread == self.thread and step >= self.at_step:
            self.fired = True
            raise InjectedFault(
                f"chaos[{self.kind}]: injected {self.thread} fault "
                f"@ step {step}")


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_every: int = 20
    max_restarts: int = 5
    straggler_factor: float = 3.0
    straggler_window: int = 32
    max_consecutive_stragglers: int = 3


class StragglerWatchdog:
    def __init__(self, cfg: SupervisorConfig):
        self.cfg = cfg
        self.times: list[float] = []
        self.consecutive = 0
        self.events: list[StragglerEvent] = []

    def observe(self, step: int, dt: float) -> str:
        """Returns 'ok' | 'straggler' | 'evict'."""
        med = float(np.median(self.times)) if self.times else dt
        self.times.append(dt)
        if len(self.times) > self.cfg.straggler_window:
            self.times.pop(0)
        if self.times and dt > self.cfg.straggler_factor * med and \
                len(self.times) > 4:
            self.consecutive += 1
            self.events.append(StragglerEvent(step, dt, med))
            if self.consecutive >= self.cfg.max_consecutive_stragglers:
                self.consecutive = 0
                return "evict"
            return "straggler"
        self.consecutive = 0
        return "ok"


class TrainSupervisor:
    """Run a step function with checkpoint/restart under injected faults.

    ``state`` is a nested dict of tensors (parameters, optimizer state,
    ...). ``data_stream(start)`` must be deterministic and resumable from
    an arbitrary step — the skip-ahead contract every production loader
    implements. ``on_evict(state) -> (state, device)`` handles a straggler
    eviction; restores then place the state on that device.

    As in the reference, a fault before the first checkpoint restarts
    from ``start_step`` with the state the fault left.
    """

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 cfg: SupervisorConfig = SupervisorConfig(),
                 on_evict: Callable | None = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.cfg = cfg
        self.watchdog = StragglerWatchdog(cfg)
        self.on_evict = on_evict
        self.restarts = 0

    def run(self, state, data_stream: Callable[[int], Iterator],
            n_steps: int, start_step: int = 0,
            fault_at: int | None = None, device=None):
        step = start_step
        while step < n_steps:
            try:
                stream = data_stream(step)
                for batch in stream:
                    if step >= n_steps:
                        break
                    t0 = time.perf_counter()
                    if fault_at is not None and step == fault_at:
                        fault_at = None  # fire once
                        raise InjectedFault(
                            f"simulated node loss @ step {step}")
                    state = self.step_fn(state, batch)
                    dt = time.perf_counter() - t0
                    verdict = self.watchdog.observe(step, dt)
                    if verdict == "evict" and self.on_evict is not None:
                        self.ckpt.save(step + 1, state)
                        state, device = self.on_evict(state)
                    step += 1
                    if step % self.cfg.ckpt_every == 0:
                        self.ckpt.save(step, state)
            except InjectedFault:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                latest = self.ckpt.latest_step()
                if latest is None:
                    step = start_step  # cold restart
                    continue
                state, step = self.ckpt.restore(state, device=device)
            else:
                break
        self.ckpt.save(step, state)
        return state, step
