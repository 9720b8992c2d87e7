"""StepObserver: the engines' single attachment point for observability
(port of ``repro.obs.bridge``).

One :class:`StepObserver` instance per engine bundles the metric handles
(pre-created once, so the per-step path is pure counter increments), the
optional :class:`~repro_torch.obs.flight.FlightRecorder`, and the
``WindowTelemetry`` → digest reduction shared by the sync fold, the async
collector, and the benchmark overhead gate. Either pillar may be absent:
``registry=None`` turns every metric update into a no-op attribute check,
``flight=None`` skips record construction.

Per-step protocol (both engines):

1. ``rec = obs.on_dispatch(...)`` right after the step launches —
   counts the step/windows/pad lanes and opens a flight record carrying
   the requested lowering, the latched plan, and the governor's state at
   dispatch time (``None`` without a flight recorder).
2. ``obs.observe_step(tel_host, rec, step_latency_s)`` once the step's
   telemetry is host-resident (the sync engine's deferred fold; the async
   collector) — reduces the [S]-batched trace to a digest, feeds the
   path-mix/deadline/latency metrics, and completes the flight record.
3. ``obs.drop(n)`` whenever observed windows are lost before step 2
   (collector drain on worker death, futures cancelled mid-flight) —
   the ``torr_telemetry_dropped_total`` counter is the audit trail for
   the silent-loss bug class this subsystem closes.

The digest's key names deliberately match ``perf.cycle_model``'s
vocabulary (``path`` names from ``core.types.PATH_NAMES``, ``banks``/
``planes``/``fused``/``decide``/``bucket_tier`` as in ``window_cost``)
so measured and modeled envelopes diff directly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.types import (DECIDE_NAMES, FUSED_NAMES, PATH_BYPASS, PATH_DELTA,
                          PATH_FULL, PATH_NAMES)
from .flight import FlightRecorder
from .metrics import LATENCY_BUCKETS_S, MetricsRegistry


def telemetry_digest(tel_h) -> dict:
    """Reduce a host-resident [S]-batched ``WindowTelemetry`` to a digest.

    The telemetry carries no per-lane valid mask (and valid lanes need not
    be prefix-packed), so lane accounting leans on the pipeline's pad
    invariant (``pipeline._finish_window``): invalid/pad lanes report
    bypass with ``delta_count == 0`` and ``rho == 0.0``, and
    ``reasoner_active`` is valid-masked at the source. Delta/full counts
    are therefore exact unmasked sums, the bypass count falls out by
    subtraction from ``n_valid``, and the rho quantiles drop exactly the
    pad lanes' zeros. Returns plain Python types — directly JSONL-able
    into a flight record.
    """
    path = np.asarray(tel_h.path)
    nv = np.asarray(tel_h.n_valid).astype(np.int64)
    n_valid = int(nv.sum())
    n_delta = int(np.sum(path == PATH_DELTA))
    n_full = int(np.sum(path == PATH_FULL))
    counts = {PATH_BYPASS: n_valid - n_delta - n_full,
              PATH_DELTA: n_delta, PATH_FULL: n_full}
    # pad lanes are exactly 0.0: strip their zeros, keep any genuine ones
    rho_all = np.asarray(tel_h.rho).ravel()
    rho_nz = rho_all[rho_all != 0.0]
    rho = np.concatenate(
        [rho_nz, np.zeros(max(n_valid - rho_nz.size, 0), rho_all.dtype)])
    fused_id = int(np.asarray(tel_h.fused_mode).reshape(-1)[0])
    decide_id = int(np.asarray(tel_h.decide_mode).reshape(-1)[0])
    digest = {
        "n_windows": int(np.sum(nv > 0)),
        "n_valid": n_valid,
        "path": {name: counts[i] for i, name in enumerate(PATH_NAMES)},
        "delta_dims": int(np.sum(
            np.asarray(tel_h.delta_count) * (path == PATH_DELTA))),
        "rho_p50": float(np.median(rho)) if rho.size else None,
        "rho_p90": float(np.quantile(rho, 0.9)) if rho.size else None,
        "reasoner_active": int(np.sum(np.asarray(tel_h.reasoner_active))),
        "high_load": int(np.sum(np.asarray(tel_h.high_load))),
        "banks": int(np.max(np.asarray(tel_h.banks))),
        "planes": int(np.max(np.asarray(tel_h.planes))),
        # resolved static lowering (identical across slots by construction:
        # fused/decide/bucket_cap are static arguments of the whole step)
        "fused": FUSED_NAMES[fused_id],
        "decide": DECIDE_NAMES[decide_id] if decide_id >= 0 else None,
        "bucket_tier": int(np.asarray(tel_h.bucket_tier).reshape(-1)[0]),
    }
    return digest


class StepObserver:
    """Metric handles + flight recorder behind one per-engine facade."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 flight: Optional[FlightRecorder] = None):
        self.registry = registry
        self.flight = flight
        r = registry
        if r is None:
            self._c_steps = None
            return
        self._c_steps = r.counter(
            "torr_steps_total", "Batched engine steps dispatched.")
        self._c_windows = r.counter(
            "torr_windows_total", "Non-pad windows served through steps.")
        self._c_pad = r.counter(
            "torr_pad_slots_total", "Idle slot-steps (wasted vmap lanes).")
        self._c_shed = r.counter(
            "torr_windows_shed_total",
            "Windows dropped by RT admission control.")
        self._c_admit = r.counter(
            "torr_streams_admitted_total", "Streams bound to slots.")
        self._c_retire = r.counter(
            "torr_streams_retired_total", "Streams released from slots.")
        self._c_dropped_windows = r.counter(
            "torr_windows_dropped_total",
            "Backlog windows discarded by retire().")
        path_c = r.counter(
            "torr_path_total",
            "Valid proposals by resolved Alg. 1 path.", ["path"])
        self._c_path = {i: path_c.labels(path=name)
                        for i, name in enumerate(PATH_NAMES)}
        self._c_delta = r.counter(
            "torr_delta_dims_total",
            "Summed |Delta| dimensions corrected via Eq. 6.")
        self._c_reasoner = r.counter(
            "torr_reasoner_active_total",
            "Proposals whose relational reasoner was not gated off.")
        self._c_high = r.counter(
            "torr_high_load_windows_total",
            "Windows whose load gate H(N, q) evaluated high.")
        self._c_tel_drop = r.counter(
            "torr_telemetry_dropped_total",
            "Observed steps/windows lost before telemetry was folded.")
        self._h_step = r.histogram(
            "torr_step_latency_seconds",
            "Dispatch to results-ready latency of one batched step.",
            buckets=LATENCY_BUCKETS_S)
        self._g_ewma = r.gauge(
            "torr_full_path_ewma",
            "Auto-dispatch full-path-fraction EWMA (compact tier input).")

    # -- scheduling events ---------------------------------------------------

    def on_admit(self) -> None:
        if self._c_steps is not None:
            self._c_admit.inc()

    def on_retire(self, dropped_windows: int) -> None:
        if self._c_steps is not None:
            self._c_retire.inc()
            if dropped_windows:
                self._c_dropped_windows.inc(dropped_windows)

    def on_shed(self, n: int = 1) -> None:
        if self._c_steps is not None:
            self._c_shed.inc(n)

    def drop(self, n: int) -> None:
        """Observed windows lost before their telemetry was folded."""
        if self._c_steps is not None:
            self._c_tel_drop.inc(n)

    # -- per-step protocol ---------------------------------------------------

    def on_dispatch(self, n_served: int, n_pad: int, requested=None,
                    plan=None, gov=None, full_ewma=None) -> Optional[dict]:
        """Record one launched step; returns the open flight record.

        ``requested`` is the ``(fused, bucket_cap, decide)`` static args
        the host dispatched with (the resolved lowering lands from the
        telemetry in :meth:`observe_step`); ``plan`` the latched
        ``KnobPlan`` (or None); ``gov`` a dict of the governor's state at
        dispatch (``level``/``slack``/``energy_ewma_mj``).
        """
        if self._c_steps is not None:
            self._c_steps.inc()
            self._c_windows.inc(n_served)
            self._c_pad.inc(n_pad)
            if full_ewma is not None:
                self._g_ewma.set(full_ewma)
        if self.flight is None:
            return None
        fields = {"n_windows": n_served}
        if requested is not None:
            fused, bucket_cap, decide = requested
            fields["requested"] = {
                "fused": fused, "bucket_cap": bucket_cap, "decide": decide}
        if plan is not None:
            fields["plan"] = {"banks": int(plan.banks),
                              "planes": int(plan.planes)}
        if gov is not None:
            fields["governor"] = gov
        return self.flight.record(**fields)

    def observe_step(self, tel_h, rec: Optional[dict] = None,
                     step_latency_s: Optional[float] = None) -> dict:
        """Fold one step's host-resident telemetry into metrics + record."""
        digest = telemetry_digest(tel_h)
        if self._c_steps is not None:
            for i, n in enumerate(digest["path"].values()):
                if n:
                    self._c_path[i].inc(n)
            if digest["delta_dims"]:
                self._c_delta.inc(digest["delta_dims"])
            if digest["reasoner_active"]:
                self._c_reasoner.inc(digest["reasoner_active"])
            if digest["high_load"]:
                self._c_high.inc(digest["high_load"])
            if step_latency_s is not None:
                self._h_step.observe(step_latency_s)
        if rec is not None:
            rec["telemetry"] = digest
            rec["lowering"] = {"fused": digest["fused"],
                               "decide": digest["decide"],
                               "bucket_tier": digest["bucket_tier"]}
            if step_latency_s is not None:
                rec["step_latency_s"] = step_latency_s
        return digest
