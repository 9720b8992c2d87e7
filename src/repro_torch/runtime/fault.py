"""Serving faults: the engines' failure types and deterministic chaos
injection (port of the serving part of ``repro.runtime.fault``).

``repro.runtime.fault`` also holds the training supervisor and the
straggler watchdog; they serve the LM framework and are not ported here.
"""
from __future__ import annotations

import dataclasses


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
