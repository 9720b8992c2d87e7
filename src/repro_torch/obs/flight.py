"""Flight recorder: a bounded ring of structured per-step serving records
(port of ``repro.obs.flight``).

Every dispatched engine step appends one record capturing *everything the
control plane decided and observed* for that step:

* the resolved static lowering (``fused``/``decide``/``bucket_tier``) the
  executable actually ran with;
* the governor's latched plan (banks/planes/level), measured slack ratio
  and energy EWMA at dispatch time;
* the deadline tracker's admit/escalate/shed verdicts for the step's
  windows;
* the host-side :class:`~repro_torch.core.types.WindowTelemetry` digest once the
  step retires (path mix, delta totals, rho quantiles, per-window
  banks/planes as traced);
* wall-clock step latency.

The ring is bounded (``capacity`` records; default 4096 ≈ a couple minutes
of 60 FPS serving) so a long-running host's memory stays flat — when it
wraps, the *oldest* records fall off and ``dropped`` counts them.
:meth:`FlightRecorder.dump_jsonl` spills the live window to JSONL;
:func:`load_jsonl` + :func:`replay` reconstruct the governor/auto-dispatch
decision timeline offline, which is the input the ROADMAP's
governor-autotuning item fits plan ladders from.

Schema is versioned (``FLIGHT_SCHEMA_VERSION``, stamped into every record
as ``"v"``); bump it on any key rename/removal. Catalog in
``docs/observability.md``.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import warnings
from collections import deque
from typing import Iterable, List, Optional, Sequence

FLIGHT_SCHEMA_VERSION = 1


def _jsonable(x):
    """Coerce numpy/torch scalars and containers to plain JSON types."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (str, bool, int, float)) or x is None:
        return x
    item = getattr(x, "item", None)   # numpy / torch zero-d scalars
    if callable(item):
        try:
            return _jsonable(item())
        except (TypeError, ValueError):
            pass
    tolist = getattr(x, "tolist", None)  # numpy / torch arrays
    if callable(tolist):
        return _jsonable(tolist())
    return repr(x)


class FlightRecorder:
    """Bounded ring buffer of per-step flight records.

    Thread-safe: the async engine's dispatcher opens a record while the
    collector completes it, so both :meth:`record` and the read side take
    the recorder lock (cheap — one deque append per *step*, not per
    window; never on a per-proposal path).
    """

    def __init__(self, capacity: int = 4096, metrics=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0   # records that fell off the ring's old end
        # wraparound is a real observability gap — a spill after the ring
        # wrapped silently misses the oldest steps — so surface it: a
        # counter when a registry is wired, and a one-line warning on the
        # *first* drop either way (warnings dedupe repeats by default)
        self._c_dropped = None
        if metrics is not None:
            self._c_dropped = metrics.counter(
                "torr_flight_dropped_total",
                "Flight records that fell off the bounded ring's old end.")

    def record(self, **fields) -> dict:
        """Append one step record; returns the (mutable) dict so the
        caller can complete it later (e.g. collector fills the telemetry
        digest after the device step retires). ``v`` and ``step`` keys are
        stamped automatically."""
        rec = {"v": FLIGHT_SCHEMA_VERSION}
        rec.update(fields)
        with self._lock:
            rec["step"] = self._seq
            self._seq += 1
            wrapped = len(self._ring) == self.capacity
            if wrapped:
                self.dropped += 1
            first_drop = wrapped and self.dropped == 1
            self._ring.append(rec)
        if wrapped and self._c_dropped is not None:
            self._c_dropped.inc()
        if first_drop:
            warnings.warn(
                f"FlightRecorder ring wrapped at capacity={self.capacity}: "
                f"oldest step records are being dropped (a later dump_jsonl "
                f"spill will miss them); size the capacity to the run or "
                f"spill periodically", RuntimeWarning, stacklevel=2)
        return rec

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def records(self) -> List[dict]:
        """Snapshot of the live window, oldest first (records still being
        completed by a collector may gain keys after this returns)."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def dump_jsonl(self, path: str) -> int:
        """Spill the live window to JSONL (one record per line, numpy/torch
        scalars coerced to JSON types). Returns the record count."""
        recs = self.records()
        with open(path, "w") as f:
            for rec in recs:
                f.write(json.dumps(_jsonable(rec)) + "\n")
        return len(recs)


def load_jsonl(path: str) -> List[dict]:
    """Load a spilled flight log (skipping blank lines)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


@dataclasses.dataclass(frozen=True)
class ReplayStep:
    """One step of the reconstructed control-plane timeline."""

    step: int
    banks: Optional[int]
    planes: Optional[int]
    level: Optional[int]
    fused: Optional[str]
    decide: Optional[str]
    bucket_tier: Optional[int]
    slack: Optional[float]
    energy_ewma_mj: Optional[float]

    @property
    def plan(self):
        """(banks, planes, level) — the governor's per-update log entry."""
        return (self.banks, self.planes, self.level)


def replay(records: Iterable[dict]) -> List[ReplayStep]:
    """Reconstruct the governor/auto-dispatch decision timeline.

    Input is :meth:`FlightRecorder.records` or :func:`load_jsonl` output;
    records without a schema version or from a different major version are
    skipped (a spilled log may interleave versions across a restart). The
    output is ordered by step and is the offline twin of the governor's
    own plan log — ``tests/test_torch_async_engine.py`` asserts they bit-match on a
    governed run, which is the property that makes trace-driven ladder
    fitting trustworthy.
    """
    steps = []
    for rec in records:
        if rec.get("v") != FLIGHT_SCHEMA_VERSION:
            continue
        plan = rec.get("plan") or {}
        low = rec.get("lowering") or {}
        gov = rec.get("governor") or {}
        steps.append(ReplayStep(
            step=int(rec.get("step", len(steps))),
            banks=plan.get("banks"),
            planes=plan.get("planes"),
            level=gov.get("level"),
            fused=low.get("fused"),
            decide=low.get("decide"),
            bucket_tier=low.get("bucket_tier"),
            slack=gov.get("slack"),
            energy_ewma_mj=gov.get("energy_ewma_mj"),
        ))
    steps.sort(key=lambda s: s.step)
    return steps


def plan_timeline(records: Iterable[dict]) -> List[tuple]:
    """The (banks, planes, level) sequence — governor plan-log shape."""
    return [s.plan for s in replay(records)]
