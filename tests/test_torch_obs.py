"""Port parity: the observability package (``repro_torch.obs``, a copy of
``repro.obs`` re-pointed at the port's types) and the engines' use of it.

The copied modules, fed the same operations, give the same Prometheus
text, JSON snapshot, flight JSONL, replayed plan timeline, SLO state,
telemetry digest and Chrome trace as ``repro``'s. On the engines: the
port's sync engine folds the same flight digests as ``repro``'s on the
same inputs, its metrics reconcile with its ``summary()``, a traced sync
run completes every window, and a traced governed async run traces every
window exactly once across the dispatcher/collector hand-off (as
``tests/test_obs.py`` and ``tests/test_trace.py`` hold ``repro``'s).
"""
import json
import re
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.types import WindowTelemetry as JTel
from repro.serving.stream_engine import StreamEngine as JEngine
from repro_torch import obs
from repro_torch.control import Governor, GovernorPolicy
from repro_torch.core.types import FUSED_NAMES, WindowTelemetry
from repro_torch.serving.async_engine import AsyncStreamEngine
from repro_torch.serving.deadline import DeadlinePolicy, DeadlineTracker
from repro_torch.serving.stream_engine import StreamEngine

from _torch_parity import assert_same
from test_torch_engine import JCFG, TCFG, _make_inputs, _memories

FLUSH_S = 120
SPAN = "torr_span_duration_seconds"   # wall-clock spans differ run to run


def _scenario(m, tmp, tag):
    """Drive one package's obs modules through a fixed sequence of
    operations; returns every text and JSON output they produce."""
    reg = m.MetricsRegistry()
    c = reg.counter("torr_widgets_total", "Widgets made.", ["kind"])
    c.labels(kind="a").inc()
    c.labels(kind='we"ird\\').inc(2)
    reg.gauge("torr_temp", "Temp.\nsecond line").set(1.5)
    h = reg.histogram("torr_lat_seconds", "Lat.", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 2.0, 0.1):
        h.observe(v)
    hd = reg.histogram("torr_default_seconds", "Default buckets.",
                       ["phase"])
    for i, v in enumerate((1e-4, 3e-3, 0.2, 7.0, 11.0)):
        hd.labels(phase=f"p{i % 2}").observe(v)
    snap = reg.snapshot()
    quant = [m.quantile(snap["torr_lat_seconds"]["series"][0], q)
             for q in (0.0, 0.25, 0.5, 0.99, 1.0)]
    quant.append(m.snapshot_quantile(snap, "torr_default_seconds", 0.9,
                                     {"phase": "p0"}))
    fl = m.FlightRecorder(capacity=8, metrics=reg)
    slo = m.SLOMonitor(m.SLOPolicy(fast_window=4, slow_window=8,
                                   min_events=2), metrics=reg, flight=fl)
    levels = [slo.observe(x) for x in
              (False, True, True, True, False, True, True, False)]
    # steps through the observer, the async engine's per-step protocol
    ob = m.StepObserver(reg, fl)
    ob.on_admit()
    ob.on_shed(2)
    ob.drop(1)
    ob.on_retire(3)
    tel = _host_telemetry()
    digests = []
    for step in range(3):
        rec = ob.on_dispatch(
            3, 1, requested=("compact", 64, None),
            gov={"level": step, "slack": 0.01 * step,
                 "energy_ewma_mj": np.float32(40.0 + step)},
            full_ewma=0.5)
        rec["ts_us"] = 100.0 * step
        rec["queue_depth"] = np.int32(step)
        rec["trace"] = [_window_trace(step, w) for w in range(2)]
        digests.append(ob.observe_step(tel(m), rec,
                                       step_latency_s=0.002 * (step + 1)))
    recs = fl.records()
    path = str(tmp / f"{tag}.jsonl")
    fl.dump_jsonl(path)
    loaded = m.load_jsonl(path)
    jpath = str(tmp / f"{tag}.json")
    m.write_json_snapshot(reg, jpath)
    doc = m.chrome_trace(recs)
    producer = doc["otherData"].pop("producer")
    return {
        "prometheus": m.prometheus_text(reg),
        "prometheus_snapshot": m.prometheus_text(reg.snapshot()),
        "json_snapshot": Path(jpath).read_text(),
        "quantiles": quant,
        "slo": (levels, slo.summary(), slo.burn_rates()),
        "flight_jsonl": Path(path).read_text(),
        "replay": [tuple(vars(s).values()) for s in m.replay(loaded)],
        "plan_timeline": m.plan_timeline(loaded),
        "digests": digests,
        "chrome": json.dumps(doc, sort_keys=True, default=lambda x: x.item()),
        "producer": producer,
        "health": [m.health_response(x) for x in
                   (None, True, False, lambda: {"ready": False, "why": 1},
                    lambda: 1 / 0)],
    }


def _window_trace(step, w):
    """A completed window's trace dict, as an engine embeds it."""
    base = 1000.0 * step + 10.0 * w
    return {"v": 1, "seq": 2 * step + w, "stream": f"cam{w}", "slot": w,
            "engine": "async", "step": step, "decision": "admit",
            "arrival_us": base, "complete_us": base + 9.0,
            "plan": {"banks": 8, "planes": 4, "level": step},
            "lowering": {"fused": "compact", "decide": "batched",
                         "bucket_tier": 64},
            "events": [
                {"phase": "host_decide", "ts_us": base + 1.0, "dur_us": 1.0,
                 "thread": "torr-dispatch"},
                {"phase": "dispatch_enqueue", "ts_us": base + 2.0,
                 "dur_us": 2.0, "thread": "torr-dispatch"},
                {"phase": "device_step", "ts_us": base + 5.0, "dur_us": 2.0,
                 "thread": "torr-collect"},
                {"phase": "collector_drain", "ts_us": base + 7.0,
                 "dur_us": 1.0, "thread": "torr-collect"}]}


def _host_telemetry():
    """A [3]-batched host telemetry with pad lanes (bypass, rho 0), valid
    lanes on every path and a genuine rho of 0, as either package's
    dataclass."""
    rng = np.random.default_rng(0)
    S, N = 3, TCFG.N_max
    path = rng.integers(0, 3, (S, N)).astype(np.int32)
    n_valid = np.array([N, 5, 0], np.int32)
    pad = np.arange(N)[None, :] >= n_valid[:, None]
    path[pad] = 0
    rho = rng.uniform(0.1, 1.0, (S, N)).astype(np.float32)
    rho[pad] = 0.0
    rho[0, 0] = 0.0
    fields = dict(
        path=path, delta_count=rng.integers(0, 50, (S, N)).astype(np.int32),
        banks=np.array([8, 3, 1], np.int32), rho=rho, n_valid=n_valid,
        reasoner_active=~pad & (rng.random((S, N)) < 0.5),
        queue_depth=np.array([0, 4, 0], np.int32),
        high_load=np.array([True, False, False]),
        planes=np.array([4, 2, 4], np.int32),
        fused_mode=np.full(S, 3, np.int32),
        decide_mode=np.full(S, 1, np.int32),
        bucket_tier=np.full(S, 64, np.int32))
    return lambda m: (JTel if m is jobs else WindowTelemetry)(**fields)


def test_copied_modules_give_repro_outputs(tmp_path):
    got = _scenario(obs, tmp_path, "port")
    want = _scenario(jobs, tmp_path, "jax")
    assert got.pop("producer") == "repro_torch.obs.trace_export"
    assert want.pop("producer") == "repro.obs.trace_export"
    for key in want:
        assert got[key] == want[key], key
    assert got["prometheus"] == got["prometheus_snapshot"]
    lines = got["flight_jsonl"].splitlines()
    assert any(json.loads(line).get("slo") for line in lines)
    assert [p for p in got["plan_timeline"] if p[2] is not None] == \
        [(None, None, 0), (None, None, 1), (None, None, 2)]


def test_span_and_trace_scope_stamp_contexts():
    """Spans feed their histogram and stamp the innermost scope's
    contexts, as ``repro``'s do; NULL_SPAN records nothing."""
    reg, tr = obs.MetricsRegistry(), obs.Tracer(capacity=2)
    ctxs = [tr.mint("a", "sync"), tr.mint("b", "sync")]
    with obs.trace_scope(ctxs):
        with obs.span("outer", reg):
            assert obs.current_span() == "outer"
            with obs.span("inner", reg):
                assert obs.span_stack() == ("outer", "inner")
    with obs.NULL_SPAN:
        assert obs.current_span() is None
    series = {s["labels"]["span"]: s["count"] for s in
              reg.snapshot()[SPAN]["series"]}
    assert series == {"outer": 1, "inner": 1}
    for ctx in ctxs:
        assert [e["phase"] for e in ctx.events] == ["inner", "outer"]
        tr.complete(ctx)
    tr.complete(tr.mint("c", "sync"))
    assert tr.dropped == 1 and [c.seq for c in tr.completed()] == [1, 2]


def _serve_sync(cls, im, steps, S, **kw):
    eng = cls(JCFG if cls is JEngine else TCFG, im, n_slots=S, **kw)
    task_w = np.random.default_rng(1).uniform(0, 1, (S, TCFG.M)) \
        .astype(np.float32)
    for s in range(S):
        eng.admit(f"cam{s}", task_w[s])
        for q, valid, boxes, _qd in steps:
            eng.submit(f"cam{s}", q[s], valid[s], boxes[s])
    eng.drain()
    return eng


def _without_spans(text):
    return "\n".join(l for l in text.splitlines() if SPAN not in l)


@pytest.mark.parametrize("fused", [None, "auto"])
def test_sync_engine_flight_and_metrics_match_jax(fused):
    """The port's sync engine and ``repro``'s, each with a registry and a
    flight recorder, on the same inputs: every step's record (requested and
    resolved lowering, telemetry digest) and every metric but the
    wall-clock spans are equal, and the counters reconcile with
    ``summary()``."""
    S, T = 3, 4
    im, jm = _memories()
    steps = _make_inputs(TCFG, S, T)
    runs = {}
    for name, cls, m, memory in (("port", StreamEngine, obs, im),
                                 ("jax", JEngine, jobs, jm)):
        reg, fl = m.MetricsRegistry(), m.FlightRecorder()
        kw = {"device": "cpu"} if cls is StreamEngine else {}
        eng = _serve_sync(cls, memory, steps, S, fused=fused, metrics=reg,
                          flight=fl, **kw)
        summ = eng.summary()
        runs[name] = (reg, fl.records(), summ)
    (reg, recs, summ), (jreg, jrecs, jsumm) = runs["port"], runs["jax"]
    assert summ == jsumm
    assert len(recs) == len(jrecs) == T
    for r, jr in zip(recs, jrecs):
        assert r == jr
    assert _without_spans(obs.prometheus_text(reg)) == \
        _without_spans(jobs.prometheus_text(jreg))
    snap = reg.snapshot()

    def total(name):
        return sum(s["value"] for s in snap[name]["series"])

    assert summ["telemetry_dropped"] == 0
    assert total("torr_steps_total") == summ["steps"] == T
    assert total("torr_windows_total") == summ["windows"] == S * T
    assert total("torr_streams_admitted_total") == S
    assert total("torr_path_total") == sum(
        int(np.sum(v[:S])) for _q, v, _b, _qd in steps)
    assert sum(r["telemetry"]["n_windows"] for r in recs) == S * T
    spans = {s["labels"]["span"] for s in snap[SPAN]["series"]}
    assert spans == {"host_assemble", "dispatch_enqueue", "host_observe"}


def test_sync_engine_traced_run_completes_every_window():
    S, T = 3, 4
    im, _ = _memories()
    steps = _make_inputs(TCFG, S, T)
    reg, fl, tr = obs.MetricsRegistry(), obs.FlightRecorder(), obs.Tracer()
    eng = _serve_sync(StreamEngine, im, steps, S, metrics=reg, flight=fl,
                      tracer=tr, device="cpu")
    eng.flush_telemetry()   # fold the double-buffered newest step too
    assert tr.minted == S * T
    done = tr.completed()
    assert len(done) == S * T
    for ctx in done:
        assert ctx.engine == "sync" and ctx.decision == "admit"
        assert ctx.plan is not None and ctx.lowering["fused"] == "prefix"
        assert ctx.complete_us is not None
        assert {e["phase"] for e in ctx.events} >= {"host_assemble",
                                                    "dispatch_enqueue"}
    recs = fl.records()
    assert len(recs) == T
    for rec in recs:
        assert len(rec["trace"]) == S
        assert rec["ts_us"] >= 0 and rec["queue_depth"] >= 0
        assert all(w["step"] == rec["step"] for w in rec["trace"])
    # one thread: no cross-thread flow arrows
    doc = obs.chrome_trace(recs)
    assert not [e for e in doc["traceEvents"] if e["ph"] in ("s", "f")]


def test_untraced_flight_records_carry_no_trace_keys():
    S, T = 2, 2
    im, _ = _memories()
    fl = obs.FlightRecorder()
    _serve_sync(StreamEngine, im, _make_inputs(TCFG, S, T), S, flight=fl,
                device="cpu")
    for rec in fl.records():
        assert "trace" not in rec
        assert "ts_us" not in rec and "queue_depth" not in rec


def test_async_governed_traced_run_every_window_once():
    """A traced governed async run: every window traced exactly once,
    phases ordered across the dispatcher/collector threads, per-window
    plans equal to the governor's log, and one flow arrow per window in
    the Chrome trace."""
    S, T = 3, 5
    im, _ = _memories()
    steps = _make_inputs(TCFG, S, T)
    reg = obs.MetricsRegistry()
    fl, tr = obs.FlightRecorder(), obs.Tracer(metrics=reg)
    tracker = DeadlineTracker(
        DeadlinePolicy(budget_s=30.0, escalate_margin_s=15.0,
                       allow_shed=False), metrics=reg)
    gov = Governor(TCFG, GovernorPolicy(budget_s=30.0), metrics=reg)
    task_w = np.random.default_rng(1).uniform(0, 1, (S, TCFG.M)) \
        .astype(np.float32)
    eng = AsyncStreamEngine(TCFG, im, n_slots=S, tracker=tracker,
                            governor=gov, paused=True, metrics=reg,
                            flight=fl, tracer=tr, device="cpu")
    try:
        futs = []
        for s in range(S):
            eng.admit(f"cam{s}", task_w[s])
            for q, valid, boxes, _qd in steps:
                futs.append(eng.submit(f"cam{s}", q[s], valid[s], boxes[s]))
        eng.start()
        eng.flush(timeout=FLUSH_S)
        for f in futs:
            f.result(timeout=30)
    finally:
        eng.close()
    recs = fl.records()
    seqs = sorted(w["seq"] for rec in recs for w in rec["trace"])
    assert seqs == list(range(S * T)) and tr.minted == S * T
    order = ("host_decide", "dispatch_enqueue", "device_step",
             "collector_drain")
    for rec in recs:
        banks, planes, level = gov.plan_log[rec["step"]]
        for w in rec["trace"]:
            evs = sorted(w["events"], key=lambda e: e["ts_us"])
            assert [e["phase"] for e in evs] == list(order)
            threads = [e["thread"] for e in evs]
            assert threads == ["torr-dispatch"] * 2 + ["torr-collect"] * 2
            assert (w["plan"]["banks"], w["plan"]["planes"],
                    w["plan"]["level"]) == (banks, planes, level)
            assert w["lowering"]["fused"] in FUSED_NAMES
    doc = obs.chrome_trace(recs)
    starts = {e["id"] for e in doc["traceEvents"] if e["ph"] == "s"}
    finishes = {e["id"] for e in doc["traceEvents"] if e["ph"] == "f"}
    assert starts == finishes == set(range(S * T))


def test_metrics_server_serves_text_json_and_probes():
    reg = obs.MetricsRegistry()
    reg.counter("torr_c_total", "c").inc(3)
    ready = {"ready": True}
    srv = obs.MetricsServer(reg, port=0, ready=lambda: ready)
    port = srv.start()
    try:
        def get(path):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()

        status, text = get("/metrics")
        assert status == 200 and text == obs.prometheus_text(reg)
        assert json.loads(get("/metrics.json")[1])["torr_c_total"]
        assert get("/healthz")[0] == 200 and get("/readyz")[0] == 200
        ready["ready"] = False
        assert get("/readyz")[0] == 503
        assert get("/nope")[0] == 404
    finally:
        srv.close()


def test_telemetry_digest_of_port_tensors_matches_numpy():
    """The digest reads host arrays; the port's tensors on the CPU give the
    same digest as their numpy copies (the sync fold hands it numpy)."""
    tel = _host_telemetry()(obs)
    as_tensors = WindowTelemetry(**{k: torch.from_numpy(np.asarray(v))
                                    for k, v in vars(tel).items()})
    assert obs.telemetry_digest(as_tensors) == obs.telemetry_digest(tel)
    assert_same(np.asarray(tel.path), as_tensors.path)
    assert re.match(r"^[a-z]+$", obs.telemetry_digest(tel)["fused"])
