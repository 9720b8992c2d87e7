"""Chrome trace-event JSON (Perfetto-loadable) from enriched flight records
(port of ``repro.obs.trace_export``).

The flight recorder's per-step records, once enriched with per-window
:class:`~repro_torch.obs.trace.TraceContext` dicts (the ``"trace"`` key the
engines attach when a :class:`~repro_torch.obs.trace.Tracer` is armed), carry
everything a timeline UI needs: per-window phase intervals with the
thread that executed them, admission verdicts, resolved plan/lowering,
and the governor's state at dispatch. :func:`chrome_trace` renders that
into the Chrome trace-event format — ``chrome://tracing`` and
https://ui.perfetto.dev both load it directly:

* one **complete event** (``ph: "X"``) per (window, phase) interval,
  placed on the thread row that executed the phase (``host_decide`` /
  ``dispatch_enqueue`` on the dispatcher, ``device_step`` /
  ``collector_drain`` on the collector, the queue wait on a virtual
  ``admission_queue`` row), args carrying the window identity and its
  resolved plan/lowering;
* one **async flow** per window (``ph: "s"`` → ``ph: "f"``, ``id`` =
  window seq): the arrow leaves the dispatcher at its last
  dispatcher-side phase and binds to the collector's first phase —
  Perfetto draws the dispatcher→collector hand-off per window;
* **counter tracks** (``ph: "C"``) per dispatched step for the governor
  plan level, the energy EWMA (mJ) and the queue depth, so plan ladder
  moves line up visually with the windows that caused them;
* **instant markers** (``ph: "i"``, global scope) for the supervisor's
  ``engine_crash`` / ``engine_recovered`` epoch records, so a recovery
  window is visible as a bracketed gap in the timeline.

``ts``/``dur`` are microseconds on the process-wide trace epoch
(:func:`repro_torch.obs.trace.now_us`), the unit the format specifies.
``python -m repro_torch.launch.serve --trace-json out.json`` writes this
shape; ``tests/test_torch_obs.py`` holds it to ``repro``'s export.
"""
from __future__ import annotations

import json
from typing import Iterable, List, Optional

PROCESS_NAME = "torr-serve"
QUEUE_THREAD = "admission_queue"

# stable row ordering in the UI: queue on top, then the engine threads in
# causal order; unknown thread names sort after these
_THREAD_ORDER = (QUEUE_THREAD, "MainThread", "torr-dispatch", "torr-collect")

# phases whose executing thread is the dispatch side of the flow arrow
_DISPATCH_PHASES = ("host_decide", "host_assemble", "dispatch_enqueue")


def _tid_table(records: Iterable[dict]) -> dict:
    """Deterministic thread-name → tid assignment over the record set."""
    names = [QUEUE_THREAD]
    for rec in records:
        for w in rec.get("trace") or ():
            for ev in w.get("events", ()):
                t = ev.get("thread")
                if t and t not in names:
                    names.append(t)
    names.sort(key=lambda n: (_THREAD_ORDER.index(n)
                              if n in _THREAD_ORDER else len(_THREAD_ORDER),
                              n))
    return {name: i + 1 for i, name in enumerate(names)}


def _window_args(w: dict) -> dict:
    args = {"seq": w.get("seq"), "stream": w.get("stream"),
            "slot": w.get("slot"), "step": w.get("step"),
            "decision": w.get("decision"), "engine": w.get("engine")}
    if w.get("plan"):
        args["plan"] = w["plan"]
    if w.get("lowering"):
        args["lowering"] = w["lowering"]
    return args


def chrome_trace(records: Iterable[dict], pid: int = 1) -> dict:
    """Render enriched flight records to a Chrome trace-event document.

    Records without a ``"trace"`` key (untraced runs, pure SLO event
    records) contribute nothing but their counter samples; per-window
    events, flows and counters all come from the same record set, so one
    flight JSONL spill is the complete export input.
    """
    records = list(records)
    tids = _tid_table(records)
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": PROCESS_NAME},
    }]
    for name, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": name}})
        events.append({"name": "thread_sort_index", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"sort_index": tid}})

    for rec in records:
        step_ts: Optional[float] = rec.get("ts_us")
        if rec.get("event") in ("engine_crash", "engine_recovered") \
                and step_ts is not None:
            args = {k: v for k, v in rec.items()
                    if k not in ("event", "ts_us", "trace")}
            events.append({
                "name": rec["event"], "ph": "i", "s": "g", "cat": "recovery",
                "ts": step_ts, "pid": pid, "tid": 0, "args": args,
            })
            continue
        for w in rec.get("trace") or ():
            args = _window_args(w)
            seq = w.get("seq")
            evs = sorted(w.get("events", ()), key=lambda e: e["ts_us"])
            # queue wait: arrival → first engine phase, on the virtual row
            if evs and w.get("arrival_us") is not None:
                wait = max(evs[0]["ts_us"] - w["arrival_us"], 0.0)
                events.append({
                    "name": "queue_wait", "ph": "X", "cat": "window",
                    "ts": w["arrival_us"], "dur": wait, "pid": pid,
                    "tid": tids[QUEUE_THREAD], "args": args,
                })
            dispatch_end = collect_start = None
            collect_tid = None
            for ev in evs:
                tid = tids.get(ev.get("thread"), tids[QUEUE_THREAD])
                events.append({
                    "name": ev["phase"], "ph": "X", "cat": "window",
                    "ts": ev["ts_us"], "dur": ev["dur_us"], "pid": pid,
                    "tid": tid, "args": args,
                })
                if ev["phase"] in _DISPATCH_PHASES:
                    dispatch_end = (ev["ts_us"] + ev["dur_us"], tid)
                elif collect_start is None:
                    collect_start, collect_tid = ev["ts_us"], tid
            if step_ts is None and evs:
                step_ts = evs[0]["ts_us"]
            # flow arrow across the thread hand-off (async engine); a
            # same-thread run (sync engine) has no collector-side phase
            # after its last dispatch phase, so no arrow is emitted
            if (seq is not None and dispatch_end is not None
                    and collect_start is not None
                    and collect_tid != dispatch_end[1]):
                events.append({
                    "name": "window", "ph": "s", "cat": "flow", "id": seq,
                    "ts": dispatch_end[0], "pid": pid,
                    "tid": dispatch_end[1], "args": {"seq": seq},
                })
                events.append({
                    "name": "window", "ph": "f", "bp": "e", "cat": "flow",
                    "id": seq, "ts": max(collect_start, dispatch_end[0]),
                    "pid": pid, "tid": collect_tid, "args": {"seq": seq},
                })
        if step_ts is None:
            continue
        gov = rec.get("governor") or {}
        if gov.get("level") is not None:
            events.append({"name": "plan_level", "ph": "C", "ts": step_ts,
                           "pid": pid, "args": {"level": gov["level"]}})
        if gov.get("energy_ewma_mj") is not None:
            events.append({"name": "energy_ewma_mj", "ph": "C",
                           "ts": step_ts, "pid": pid,
                           "args": {"mj": gov["energy_ewma_mj"]}})
        if rec.get("queue_depth") is not None:
            events.append({"name": "queue_depth", "ph": "C", "ts": step_ts,
                           "pid": pid,
                           "args": {"windows": rec["queue_depth"]}})

    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.obs.trace_export"}}


def write_chrome_trace(records: Iterable[dict], path: str) -> int:
    """Write the Chrome trace JSON; returns the event count."""
    doc = chrome_trace(records)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return len(doc["traceEvents"])
