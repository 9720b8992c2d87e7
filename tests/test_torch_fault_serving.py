"""Port parity: supervised, fault-tolerant serving
(``repro_torch.serving.supervisor``) against ``repro.serving.supervisor``.

Mirrors ``tests/test_fault_serving.py``: the chaos plan fires once; a
worker death is a typed ``EngineDead``; an injected dispatcher or collector
death under the supervisor recovers with every window served, bit-equal to
a fault-free run and to ``repro``'s supervisor on the same inputs and
``FaultPlan``, with the same ``restarts`` and ``windows_replayed`` (async at
snapshot cadences 1 and 3, and the sync engine); metrics and flight events
reconcile; retire deletes the stream's state; the crash-loop breaker
latches the degrade plan; the shed hint survives a restart; a terminal
death fails every pending future; and a SIGKILLed ``python -m
repro_torch.launch.serve --device cpu`` resumes from its JSONL store with
a ledger equal to a fault-free run's, record for record.

Every ``result``, ``flush`` and subprocess has a timeout, and every
supervisor is closed in a ``finally``.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro.runtime.fault import FaultPlan as JFaultPlan
from repro.serving.async_engine import AsyncStreamEngine as JAsync
from repro.serving.state_store import InMemoryStateStore as JStore
from repro.serving.stream_engine import StreamEngine as JEngine
from repro.serving.supervisor import ServeSupervisor as JSupervisor
from repro_torch.control import build_ladder
from repro_torch.obs import FlightRecorder, MetricsRegistry
from repro_torch.runtime.fault import EngineDead, FaultPlan, InjectedFault
from repro_torch.serving.async_engine import AsyncStreamEngine
from repro_torch.serving.deadline import (DeadlinePolicy, DeadlineTracker,
                                          WindowShed)
from repro_torch.serving.state_store import InMemoryStateStore
from repro_torch.serving.stream_engine import StreamEngine
from repro_torch.serving.supervisor import ServeSupervisor, recovery_events

from _torch_parity import assert_dataclass_same
from test_torch_engine import JCFG, TCFG, _make_inputs, _memories

SRC = str(Path(__file__).resolve().parents[1] / "src")
FLUSH_S = 120
RESULT_S = 30


def _task_w(S):
    return np.random.default_rng(1).uniform(0, 1, (S, TCFG.M)) \
        .astype(np.float32)


def _drive(sup, steps, S):
    """Admit S streams through the supervisor, submit every window, start
    an async engine, flush; the outer futures keyed (stream, seq)."""
    task_w = _task_w(S)
    futs = {}
    for s in range(S):
        sup.admit(f"cam{s}", task_w[s])
        for t, (q, valid, boxes, _qd) in enumerate(steps):
            futs[(s, t)] = sup.submit(f"cam{s}", q[s], valid[s], boxes[s])
    if hasattr(sup.engine, "start"):
        sup.engine.start()
    sup.flush(timeout=FLUSH_S)
    return futs


def _outputs(futs):
    return {k: f.result(timeout=RESULT_S)[0] for k, f in futs.items()}


def _fault_free(S, T):
    """The port's fault-free, unsupervised async outputs."""
    im, _ = _memories()
    steps = _make_inputs(TCFG, S, T)
    with AsyncStreamEngine(TCFG, im, n_slots=S, paused=True,
                           device="cpu") as eng:
        futs = {}
        task_w = _task_w(S)
        for s in range(S):
            eng.admit(f"cam{s}", task_w[s])
            for t, (q, valid, boxes, _qd) in enumerate(steps):
                futs[(s, t)] = eng.submit(f"cam{s}", q[s], valid[s],
                                          boxes[s])
        eng.start()
        eng.flush(timeout=FLUSH_S)
        return _outputs(futs)


def _assert_outputs_equal(got, want, what=""):
    assert set(got) == set(want)
    for k in want:
        assert_dataclass_same(got[k], want[k], (what, k))


def _supervised(kind, fault, cadence, S, T, jax_side=False, **sup_kw):
    """One supervised run of either package over the shared inputs:
    (outputs, supervisor summary); ``kind`` is "async" or "sync"."""
    im, jm = _memories()
    steps = _make_inputs(TCFG, S, T)
    if jax_side:
        store = JStore()

        def make():
            if kind == "sync":
                return JEngine(JCFG, jm, n_slots=S, store=store,
                               snapshot_every=cadence, fault_plan=fault)
            return JAsync(JCFG, jm, n_slots=S, paused=True, store=store,
                          snapshot_every=cadence, fault_plan=fault)
        sup = JSupervisor(make, store, **sup_kw)
    else:
        store = InMemoryStateStore(metrics=sup_kw.get("metrics"))

        def make():
            if kind == "sync":
                return StreamEngine(TCFG, im, n_slots=S, store=store,
                                    snapshot_every=cadence,
                                    fault_plan=fault, device="cpu")
            return AsyncStreamEngine(TCFG, im, n_slots=S, paused=True,
                                     store=store, snapshot_every=cadence,
                                     fault_plan=fault, device="cpu")
        sup = ServeSupervisor(make, store, **sup_kw)
    try:
        outs = _outputs(_drive(sup, steps, S))
        summary = sup.summary()
    finally:
        sup.close(drain=False)
    if not jax_side:
        assert sup.join_abandoned(timeout=30)
    return outs, summary


# --- typed EngineDead + chaos plan ------------------------------------------

def test_fault_plan_fires_once_per_thread():
    plan = FaultPlan(at_step=2, thread="collector")
    plan.maybe_fire("dispatcher", 5)        # wrong thread: no-op
    plan.maybe_fire("collector", 1)         # before at_step: no-op
    with pytest.raises(InjectedFault, match="chaos"):
        plan.maybe_fire("collector", 2)
    plan.maybe_fire("collector", 3)         # fired: never again
    with pytest.raises(ValueError):
        FaultPlan(at_step=0, thread="scheduler")


def test_engine_dead_is_typed_with_context():
    S, T = 2, 4
    im, _ = _memories()
    steps = _make_inputs(TCFG, S, T)
    eng = AsyncStreamEngine(TCFG, im, n_slots=S, paused=True, device="cpu",
                            fault_plan=FaultPlan(at_step=1,
                                                 thread="dispatcher"))
    futs = []
    try:
        task_w = _task_w(S)
        for s in range(S):
            eng.admit(f"cam{s}", task_w[s])
            for q, valid, boxes, _qd in steps:
                futs.append(eng.submit(f"cam{s}", q[s], valid[s], boxes[s]))
        eng.start()
        with pytest.raises(EngineDead, match="worker died") as ei:
            eng.flush(timeout=FLUSH_S)
    finally:
        eng.close(drain=False)
    assert isinstance(ei.value, RuntimeError)
    assert ei.value.thread == "dispatcher"
    assert ei.value.inflight > 0
    assert isinstance(ei.value.cause, InjectedFault)
    failed = [f for f in futs if f.done() and f.exception() is not None]
    assert failed, "worker death must fail in-flight futures"
    assert all(isinstance(f.exception(), EngineDead) for f in failed)


def test_abandon_stops_the_workers_without_joining():
    im, _ = _memories()
    eng = AsyncStreamEngine(TCFG, im, n_slots=1, device="cpu")
    try:
        eng.abandon()
        for worker in (eng._dispatcher, eng._collector):
            worker.join(timeout=30)
            assert not worker.is_alive()
    finally:
        eng.close(drain=False)


# --- supervised recovery ----------------------------------------------------

@pytest.mark.parametrize("kind", ["dispatcher", "collector"])
@pytest.mark.parametrize("cadence", [1, 3])
def test_async_recovery_bit_identical_and_equal_to_repro(kind, cadence):
    S, T = 3, 6
    ref = _fault_free(S, T)
    reg, flight = MetricsRegistry(), FlightRecorder(1024)
    outs, summary = _supervised("async", FaultPlan(at_step=2, thread=kind),
                                cadence, S, T, metrics=reg, flight=flight)
    _assert_outputs_equal(outs, ref, "fault-free")
    assert summary["restarts"] == 1 and summary["pending"] == 0
    assert summary["windows_replayed"] > 0
    jouts, jsummary = _supervised("async", JFaultPlan(at_step=2, thread=kind),
                                  cadence, S, T, jax_side=True)
    _assert_outputs_equal(outs, jouts, "repro")
    assert summary["restarts"] == jsummary["restarts"] == 1
    assert summary["pending"] == jsummary["pending"] == 0
    if kind == "collector":
        # steps 0 and 1 were delivered before the collector died at step 2:
        # what is replayed and re-run follows from the fault alone
        for k in ("windows_replayed", "windows_rerun"):
            assert summary[k] == jsummary[k], k
    else:
        # a dispatcher dying at step 2 leaves steps 0 and 1 to a collector
        # that may or may not have delivered them when the death is
        # handled, in either package: the count replayed lies between the
        # windows never dispatched and all of them
        for got in (summary, jsummary):
            assert S * (T - 2) <= got["windows_replayed"] <= S * T, got

    # metric/flight reconciliation: the counters and the epoch events
    # describe the same recovery
    snap = reg.snapshot()

    def counter(name):
        return snap[name]["series"][0]["value"]

    evs = recovery_events(flight.records())
    assert [e["event"] for e in evs] == ["engine_crash", "engine_recovered"]
    assert evs[0]["thread"] == kind
    assert counter("torr_engine_restarts_total") == 1 == evs[1]["restarts"]
    assert counter("torr_windows_replayed_total") == evs[1]["replayed"] > 0
    assert counter("torr_state_store_writes_total") > 0


@pytest.mark.parametrize("cadence", [1, 3])
def test_sync_engine_recovery_bit_identical_and_equal_to_repro(cadence):
    S, T = 3, 6
    ref = _fault_free(S, T)
    outs, summary = _supervised(
        "sync", FaultPlan(at_step=3, thread="dispatcher"), cadence, S, T)
    _assert_outputs_equal(outs, ref, "fault-free")
    assert summary["restarts"] == 1
    jouts, jsummary = _supervised(
        "sync", JFaultPlan(at_step=3, thread="dispatcher"), cadence, S, T,
        jax_side=True)
    _assert_outputs_equal(outs, jouts, "repro")
    for k in ("restarts", "windows_replayed", "windows_rerun"):
        assert summary[k] == jsummary[k], k


def test_recovery_records_its_first_window_and_captures():
    S, T = 2, 4
    store = InMemoryStateStore()
    im, _ = _memories()
    fault = FaultPlan(at_step=1, thread="dispatcher")

    def make():
        return AsyncStreamEngine(TCFG, im, n_slots=S, paused=True,
                                 store=store, fault_plan=fault, device="cpu")

    sup = ServeSupervisor(make, store, backoff_s=0.001)
    try:
        _drive(sup, _make_inputs(TCFG, S, T), S)
    finally:
        sup.close(drain=False)
    (rec,) = sup.recoveries
    assert rec["replayed"] > 0
    assert 0 <= rec["rebuilt_s"] <= rec["first_window_s"]
    assert rec["captures"] == []        # the CPU captures no graph
    assert sup.join_abandoned(timeout=30)


@pytest.mark.parametrize("kind", ["dispatcher", "collector"])
def test_a_dead_engine_is_freed_without_the_cyclic_collector(kind):
    """Once its workers end, an abandoned engine is freed by reference
    counting alone (on the card it holds a graph family): its stored
    death does not keep it alive through the worker's frame."""
    import gc
    import weakref

    S, T = 2, 4
    im, _ = _memories()
    store = InMemoryStateStore()
    fault = FaultPlan(at_step=1, thread=kind)
    built = []

    def make():
        eng = AsyncStreamEngine(TCFG, im, n_slots=S, paused=True,
                                store=store, fault_plan=fault, device="cpu")
        built.append(weakref.ref(eng))
        return eng

    enabled = gc.isenabled()
    gc.disable()
    try:
        sup = ServeSupervisor(make, store, backoff_s=0.001)
        try:
            _drive(sup, _make_inputs(TCFG, S, T), S)
        finally:
            sup.close(drain=False)
        assert sup.join_abandoned(timeout=30)
        assert len(built) == 2
        assert built[0]() is None, "the dead engine is still referenced"
        assert built[1]() is sup.engine
    finally:
        if enabled:
            gc.enable()


def test_retire_deletes_session_state():
    S = 2
    im, _ = _memories()
    store = InMemoryStateStore()

    def make():
        return AsyncStreamEngine(TCFG, im, n_slots=S, paused=True,
                                 store=store, snapshot_every=1, device="cpu")

    sup = ServeSupervisor(make, store)
    try:
        _drive(sup, _make_inputs(TCFG, S, 2), S)
        assert sorted(store.keys()) == ["cam0", "cam1"]
        sup.retire("cam0")
        assert store.keys() == ["cam1"]
    finally:
        sup.close(drain=False)


def test_sync_engine_retire_deletes_session_state():
    im, _ = _memories()
    store = InMemoryStateStore()
    eng = StreamEngine(TCFG, im, n_slots=1, store=store, device="cpu")
    q, valid, boxes, _ = _make_inputs(TCFG, 1, 1)[0]
    eng.admit("cam0", _task_w(1)[0])
    eng.submit("cam0", q[0], valid[0], boxes[0])
    eng.drain()
    eng.flush_telemetry()
    assert store.latest_seq("cam0") == 1
    eng.retire("cam0")
    assert store.keys() == []


def test_crash_loop_breaker_degrades_plan():
    S, T = 2, 5
    ref = _fault_free(S, T)
    im, _ = _memories()
    store = InMemoryStateStore()
    built = [0]

    def make():
        # engines 1 and 2 die at once; engine 3 is healthy: two crashes
        # inside the breaker window trip graceful degradation
        built[0] += 1
        fault = FaultPlan(at_step=0, thread="dispatcher") \
            if built[0] <= 2 else None
        return AsyncStreamEngine(TCFG, im, n_slots=S, paused=True,
                                 store=store, snapshot_every=1,
                                 fault_plan=fault, device="cpu")

    sup = ServeSupervisor(make, store, breaker_restarts=2, backoff_s=0.001)
    try:
        outs = _outputs(_drive(sup, _make_inputs(TCFG, S, T), S))
        assert sup.summary()["restarts"] == 2
        assert sup.summary()["degraded"] is True
        assert sup.engine.plan == build_ladder(TCFG)[-1]
        # every window resolved exactly once
        assert set(outs) == set(ref)
        assert len(sup.recoveries) == 2
    finally:
        sup.close(drain=False)
    assert sup.join_abandoned(timeout=30)


def test_shed_retry_hint_survives_supervised_restart():
    """The ``WindowShed.retry_after_s`` hint is still attached to sheds
    raised after a supervised restart: the tracker outlives the engine."""
    S, T = 1, 4
    im, _ = _memories()
    steps = _make_inputs(TCFG, S, T)
    store = InMemoryStateStore()
    tracker = DeadlineTracker(DeadlinePolicy(budget_s=1e-12,
                                             escalate_margin_s=1e-12,
                                             step_init_s=0.004))
    built = [0]

    def make():
        built[0] += 1
        fault = FaultPlan(at_step=0, thread="dispatcher") \
            if built[0] == 1 else None
        return AsyncStreamEngine(TCFG, im, n_slots=S, paused=True,
                                 store=store, snapshot_every=1,
                                 tracker=tracker, fault_plan=fault,
                                 device="cpu")

    sup = ServeSupervisor(make, store, backoff_s=0.001)
    try:
        sup.admit("cam0", _task_w(S)[0])
        futs = [sup.submit("cam0", q[0], valid[0], boxes[0])
                for q, valid, boxes, _qd in steps]
        sup.engine.start()
        sup.flush(timeout=FLUSH_S)
        assert sup.summary()["restarts"] == 1
        assert built[0] == 2
        hints = []
        for f in futs:
            exc = f.exception(timeout=RESULT_S)
            assert isinstance(exc, WindowShed), exc
            hints.append(exc.retry_after_s)
        assert all(h is not None and h > 0 for h in hints), hints
        assert tracker.shed == T
    finally:
        sup.close(drain=False)


def test_max_restarts_terminal_death_fails_pending():
    S, T = 2, 3
    im, _ = _memories()
    steps = _make_inputs(TCFG, S, T)
    store = InMemoryStateStore()

    def make():
        return AsyncStreamEngine(TCFG, im, n_slots=S, paused=True,
                                 store=store, device="cpu",
                                 fault_plan=FaultPlan(
                                     at_step=0, thread="dispatcher"))

    sup = ServeSupervisor(make, store, max_restarts=2, backoff_s=0.001)
    futs = []
    try:
        task_w = _task_w(S)
        for s in range(S):
            sup.admit(f"cam{s}", task_w[s])
            for q, valid, boxes, _qd in steps:
                futs.append(sup.submit(f"cam{s}", q[s], valid[s], boxes[s]))
        sup.engine.start()
        with pytest.raises(EngineDead):
            sup.flush(timeout=FLUSH_S)
        assert sup.summary()["restarts"] == sup.max_restarts + 1
        assert sup.health()["terminal"] is True
        for f in futs:
            assert isinstance(f.exception(timeout=RESULT_S), EngineDead)
    finally:
        sup.close(drain=False)
    assert sup.join_abandoned(timeout=30)


# --- cross-process SIGKILL resume (the launcher end to end) ------------------

def _read_ledger(path):
    recs = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue        # torn trailing write from the SIGKILL
            recs[(r["stream"], r["seq"])] = r
    return recs


def test_serve_sigkill_resume_bit_identical(tmp_path):
    """SIGKILL a supervised launcher run mid-wave; the resumed process
    covers every window, record for record equal to a fault-free
    ledger."""
    S, T = 2, 10
    env = dict(os.environ, PYTHONPATH=SRC)
    ref, out, store = (tmp_path / "ref.jsonl", tmp_path / "out.jsonl",
                       tmp_path / "state.jsonl")
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
            "cpu", "--torr-streams", str(S), "--torr-frames", str(T),
            "--async"]

    r = subprocess.run(base + ["--outputs-jsonl", str(ref)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    want = _read_ledger(ref)
    assert len(want) == S * T

    cmd = base + ["--supervise", "--state-store", str(store),
                  "--outputs-jsonl", str(out)]
    p = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            if p.poll() is not None:
                break           # finished before the kill landed: still a
                #                 valid (vacuous-resume) run, asserted below
            if out.exists() and len(_read_ledger(out)) >= 3:
                p.kill()        # SIGKILL: no cleanup, no flush
                p.wait(timeout=60)
                break
            time.sleep(0.01)
        else:
            pytest.fail("serve run neither progressed nor finished")
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=60)

    covered = _read_ledger(out)
    r2 = subprocess.run(cmd, env=env, capture_output=True, text=True,
                        timeout=300)
    assert r2.returncode == 0, r2.stderr
    if p.returncode != 0:       # the kill landed mid-run
        assert "resumed" in r2.stdout

    merged = _read_ledger(out)
    assert set(merged) == set(want), "lost windows across SIGKILL"
    for k, rec in want.items():
        assert merged[k] == rec, k
    # windows the first process had already shipped stay shipped
    assert set(covered) <= set(merged)


def test_launcher_fault_run_recovers_in_process(tmp_path, capsys):
    """``run_torr_streams`` with an injected collector death: one restart,
    every window served, the outputs ledger equal to a fault-free run's."""
    from repro_torch.launch import serve

    ref, out = tmp_path / "ref.jsonl", tmp_path / "out.jsonl"
    serve.run_torr_streams(2, 4, use_async=True, outputs_jsonl=str(ref),
                           device="cpu")
    res = serve.run_torr_streams(
        2, 4, fault_at=1, fault_kind="collector", outputs_jsonl=str(out),
        metrics_json=str(tmp_path / "m.json"), device="cpu")
    assert res["supervisor"]["restarts"] == 1
    assert res["lost"] == 0 and res["served"] == res["submitted"] == 8
    assert _read_ledger(out) == _read_ledger(ref)
    assert "supervisor: restarts=1" in capsys.readouterr().out
