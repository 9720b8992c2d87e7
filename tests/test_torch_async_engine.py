"""Port parity: the async serving runtime (``repro_torch.serving.async_engine``)
against the port's sync engine and ``repro``'s ``AsyncStreamEngine``.

Mirrors ``tests/test_async_engine.py`` (one device): with admission control
off and the same submission order, the dispatch/collect engine is
bit-identical to the sync engine and to ``repro``'s async engine, paused or
live; shed windows fail their futures with ``WindowShed``; escalated
windows run with the load gate forced high; retire cancels the backlog;
callbacks may re-enter; a worker error becomes ``EngineDead``. From
``tests/test_obs.py``: a governed run's flight plan timeline is the
governor's ``plan_log``, and a cancelled future counts as
``telemetry_dropped``.

Every ``result``/``flush`` carries a timeout and every engine is closed in
a ``finally`` (or a ``with``), so a deadlocked worker fails its test
instead of hanging the suite.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.serving.async_engine import AsyncStreamEngine as JAsync
from repro_torch.control import Governor, GovernorPolicy
from repro_torch.core import pipeline
from repro_torch.obs.flight import FlightRecorder, plan_timeline
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.fault import EngineDead
from repro_torch.serving.async_engine import AsyncStreamEngine
from repro_torch.serving.deadline import (DeadlinePolicy, DeadlineTracker,
                                          WindowShed)
from repro_torch.serving.stream_engine import StreamEngine

from _torch_parity import assert_dataclass_same, assert_same
from test_torch_engine import JCFG, TCFG, _make_inputs, _memories

FLUSH_S = 120
RESULT_S = 30
TELEM = ("path", "delta_count", "banks", "rho", "n_valid", "reasoner_active",
         "queue_depth", "high_load", "planes", "fused_mode", "decide_mode",
         "bucket_tier")


def _task_w(S):
    return np.random.default_rng(1).uniform(0, 1, (S, TCFG.M)) \
        .astype(np.float32)


def _submit_all(eng, task_w, steps, S):
    """Admit S streams and enqueue every window; per-stream futures."""
    futs = {s: [] for s in range(S)}
    for s in range(S):
        eng.admit(f"cam{s}", task_w[s])
        for q, valid, boxes, _qd in steps:
            futs[s].append(eng.submit(f"cam{s}", q[s], valid[s], boxes[s]))
    return futs


def _assert_window_same(got, want, what):
    (gout, gtel), (wout, wtel) = got, want
    assert_dataclass_same(gout, wout, what)
    for f in TELEM:
        assert_same(getattr(gtel, f), getattr(wtel, f), (what, f))


@functools.lru_cache(maxsize=None)
def _jax_async_results(S, T):
    """``repro``'s AsyncStreamEngine, paused, on the shared inputs."""
    _, jm = _memories()
    steps = _make_inputs(TCFG, S, T)
    with JAsync(JCFG, jm, n_slots=S, paused=True) as eng:
        futs = _submit_all(eng, _task_w(S), steps, S)
        eng.start()
        eng.flush(timeout=FLUSH_S)
        return {s: [f.result(timeout=RESULT_S) for f in futs[s]]
                for s in range(S)}


@pytest.mark.parametrize("fused", [None, "compact"])
@pytest.mark.parametrize("S", [1, 3])
def test_async_matches_sync_and_jax_bitwise(S, fused):
    """Same submission order => identical batches => the port's async
    engine equals its sync engine and ``repro``'s async engine in every
    output and telemetry field, and the final caches are equal."""
    T = 4
    im, _ = _memories()
    task_w = _task_w(S)
    steps = _make_inputs(TCFG, S, T)
    sync = StreamEngine(TCFG, im, n_slots=S, fused=fused, device="cpu")
    for s in range(S):
        sync.admit(f"cam{s}", task_w[s])
        for q, valid, boxes, _qd in steps:
            sync.submit(f"cam{s}", q[s], valid[s], boxes[s])
    res_sync = sync.drain()
    # paused: the dispatcher sees the full backlog, reproducing the sync
    # drain schedule (and its queue-depth trace) exactly
    eng = AsyncStreamEngine(TCFG, im, n_slots=S, fused=fused, paused=True,
                            device="cpu")
    try:
        futs = _submit_all(eng, task_w, steps, S)
        eng.start()
        eng.flush(timeout=FLUSH_S)
        res = {s: [f.result(timeout=RESULT_S) for f in futs[s]]
               for s in range(S)}
    finally:
        eng.close()
    jres = _jax_async_results(S, T)
    for s in range(S):
        for t in range(T):
            got = res[s][t]
            assert isinstance(got[0].scores, np.ndarray)   # host trees
            _assert_window_same(got, res_sync[f"cam{s}"][t], (s, t))
            for f in TELEM[:-3]:   # the lowering encodings differ by fused
                assert_same(getattr(got[1], f), getattr(jres[s][t][1], f),
                            (s, t, f))
            assert_dataclass_same(got[0], jres[s][t][0], (s, t))
    assert_dataclass_same(eng.state, sync.state, "final state")
    assert eng.stats.windows == S * T and eng.stats.steps == T


def test_async_matches_sync_live_submission():
    """Un-paused engine (windows race the dispatcher): each stream's
    outputs still equal a sequential replay through the single-window step,
    on the port and on ``repro``, fed the queue depths the engine saw."""
    S, T = 3, 5
    im, jm = _memories()
    task_w = _task_w(S)
    steps = _make_inputs(TCFG, S, T)
    eng = AsyncStreamEngine(TCFG, im, n_slots=S, device="cpu")
    try:
        futs = _submit_all(eng, task_w, steps, S)
        eng.flush(timeout=FLUSH_S)
        results = {s: [f.result(timeout=RESULT_S) for f in futs[s]]
                   for s in range(S)}
    finally:
        eng.close()
    jstep = jax.jit(jpipe.torr_window_step, static_argnames="cfg")
    for s in range(S):
        st = pipeline.init_state(TCFG, torch.from_numpy(task_w[s]), "cpu")
        jst = jpipe.init_state(JCFG, jnp.asarray(task_w[s]))
        for t, (q, valid, boxes, _qd) in enumerate(steps):
            aout, atel = results[s][t]
            st, out, _ = pipeline.torr_window_step(
                st, im, torch.from_numpy(q[s].view(np.int32)), valid[s],
                boxes[s], int(atel.queue_depth), TCFG, fused="prefix")
            jst, jout, _ = jstep(jst, jm, jnp.asarray(q[s]),
                                 jnp.asarray(valid[s]), jnp.asarray(boxes[s]),
                                 jnp.asarray(atel.queue_depth), JCFG)
            assert_dataclass_same(out, jout, (s, t))
            assert_dataclass_same(aout, jout, (s, t))


def test_deadline_shed_fails_futures():
    """An impossible budget sheds every window with WindowShed; nothing is
    dispatched to the device."""
    S, T = 2, 3
    im, _ = _memories()
    steps = _make_inputs(TCFG, S, T)
    pol = DeadlinePolicy(budget_s=1e-12, escalate_margin_s=1e-12)
    with AsyncStreamEngine(TCFG, im, n_slots=S, paused=True,
                           tracker=DeadlineTracker(pol), device="cpu") as eng:
        futs = _submit_all(eng, _task_w(S), steps, S)
        eng.start()
        eng.flush(timeout=FLUSH_S)
        for s in range(S):
            for fut in futs[s]:
                with pytest.raises(WindowShed):
                    fut.result(timeout=RESULT_S)
    assert eng.stats.shed == S * T
    assert eng.stats.windows == 0 and eng.stats.steps == 0
    assert eng.tracker.shed == S * T
    assert eng.deadline_summary()["n_windows"] == 0


def test_deadline_escalate_forces_load_gate():
    """allow_shed=False turns hopeless lateness into escalation: the served
    window's telemetry shows queue_depth >= q_hi and H(N, q) high."""
    S, T = 2, 3
    im, _ = _memories()
    steps = _make_inputs(TCFG, S, T)
    pol = DeadlinePolicy(budget_s=1e-12, escalate_margin_s=1e-12,
                         allow_shed=False)
    with AsyncStreamEngine(TCFG, im, n_slots=S, paused=True,
                           tracker=DeadlineTracker(pol), device="cpu") as eng:
        futs = _submit_all(eng, _task_w(S), steps, S)
        eng.start()
        eng.flush(timeout=FLUSH_S)
        for s in range(S):
            for fut in futs[s]:
                _out, tel = fut.result(timeout=RESULT_S)
                assert int(tel.queue_depth) >= TCFG.q_hi
                assert bool(tel.high_load)
    assert eng.stats.windows == S * T
    assert eng.tracker.escalated == S * T
    summary = eng.deadline_summary()
    assert summary["completed"] == S * T
    assert summary["miss_rate"] == 1.0   # everything blew the 1 ps budget


def test_retire_cancels_backlog_and_readmits_clean():
    """retire() drops the un-popped backlog (cancelling futures); the slot
    re-admits with an empty queue and a cold cache."""
    im, _ = _memories()
    task_w = np.zeros((TCFG.M,), np.float32)
    steps = _make_inputs(TCFG, 1, 3)
    with AsyncStreamEngine(TCFG, im, n_slots=1, paused=True,
                           device="cpu") as eng:
        eng.admit("a", task_w)
        futs = [eng.submit("a", q[0], v[0], b[0]) for q, v, b, _ in steps]
        eng.retire("a")          # engine paused: nothing was dispatched
        assert all(f.cancelled() for f in futs)
        assert eng.stats.dropped == 3
        eng.start()
        eng.admit("b", task_w)   # the recycled slot must be clean
        fut = eng.submit("b", *[a[0] for a in steps[0][:3]])
        _out, tel = fut.result(timeout=FLUSH_S)
        # cold cache: every valid proposal takes the full path
        assert (np.asarray(tel.path)[steps[0][1][0]] == 2).all()
        eng.flush(timeout=FLUSH_S)
    assert eng.stats.windows == 1


def test_future_callbacks_may_reenter_engine():
    """Done-callbacks fire without the engine lock held: a callback that
    calls back into the engine must not deadlock the dispatcher, for shed
    futures and for cancelled ones alike."""
    im, _ = _memories()
    task_w = np.zeros((TCFG.M,), np.float32)
    steps = _make_inputs(TCFG, 1, 2)
    pol = DeadlinePolicy(budget_s=1e-12, escalate_margin_s=1e-12)
    reentered = []
    with AsyncStreamEngine(TCFG, im, n_slots=1, paused=True,
                           tracker=DeadlineTracker(pol), device="cpu") as eng:
        eng.admit("a", task_w)
        for q, v, b, _qd in steps:
            fut = eng.submit("a", q[0], v[0], b[0])
            fut.add_done_callback(
                lambda _f: reentered.append(eng.backlog("a")))
        eng.start()
        eng.flush(timeout=FLUSH_S)   # a deadlock here is the regression
        assert len(reentered) == 2
    # retire()'s cancel path must be lock-free for callbacks too
    with AsyncStreamEngine(TCFG, im, n_slots=1, paused=True,
                           device="cpu") as eng:
        eng.admit("a", task_w)
        fut = eng.submit("a", steps[0][0][0], steps[0][1][0], steps[0][2][0])
        fut.add_done_callback(lambda _f: reentered.append(eng.stats.dropped))
        eng.retire("a")
        assert fut.cancelled() and len(reentered) == 3
        eng.start()   # the context's close() joins started threads


def test_worker_error_surfaces_as_engine_dead():
    """A poisoned submission kills the dispatcher: flush, the futures and
    close raise EngineDead ("worker died") instead of deadlocking, and the
    threads are released; later submits raise too."""
    im, _ = _memories()
    q, v, b, _qd = _make_inputs(TCFG, 1, 1)[0]
    eng = AsyncStreamEngine(TCFG, im, n_slots=1, paused=True, device="cpu")
    eng.admit("a", np.zeros((TCFG.M,), np.float32))
    fut = eng.submit("a", q[0], v[0], b[0])
    # wrong-shaped window words (un-broadcastable into the batch)
    bad = eng.submit("a", q[0][:, :4], v[0], b[0])
    eng.start()
    with pytest.raises(EngineDead, match="worker died") as info:
        eng.flush(timeout=FLUSH_S)
    assert info.value.thread == "dispatcher"
    assert isinstance(info.value.cause, ValueError)
    # the step before the fault resolves, unless the dying dispatcher's
    # drain of the collect queue took it first; it never hangs
    try:
        fut.result(timeout=RESULT_S)
    except EngineDead:
        pass
    with pytest.raises(EngineDead):
        bad.result(timeout=RESULT_S)
    with pytest.raises(EngineDead):
        eng.submit("a", q[0], v[0], b[0])
    with pytest.raises(RuntimeError, match="worker died"):
        eng.close()              # drain re-raises, but threads are released
    assert not eng._dispatcher.is_alive() and not eng._collector.is_alive()


def test_mesh_must_be_one_device():
    im, _ = _memories()

    class Mesh:
        def __init__(self, n):
            self.devices = np.arange(n)

    with pytest.raises(ValueError, match="one card"):
        AsyncStreamEngine(TCFG, im, n_slots=2, mesh=Mesh(2), paused=True,
                          device="cpu")
    with pytest.raises(ValueError, match="DeadlineTracker"):
        AsyncStreamEngine(TCFG, im, n_slots=2, paused=True, device="cpu",
                          governor=Governor(TCFG, GovernorPolicy(budget_s=1.0)))
    eng = AsyncStreamEngine(TCFG, im, n_slots=2, mesh=Mesh(1), paused=True,
                            device="cpu")
    eng.close()
    assert eng.n_slots == 2


def test_governed_async_flight_matches_governor_plan_log():
    """The replayed flight plan timeline IS the governor's log, with every
    window served (a generous budget, shedding off), and the warm-up
    reaches every ladder level."""
    S, T = 4, 6
    im, _ = _memories()
    steps = _make_inputs(TCFG, S, T)
    reg, fl = MetricsRegistry(), FlightRecorder()
    tracker = DeadlineTracker(
        DeadlinePolicy(budget_s=30.0, escalate_margin_s=15.0,
                       allow_shed=False), metrics=reg)
    gov = Governor(TCFG, GovernorPolicy(budget_s=30.0), metrics=reg)
    with AsyncStreamEngine(TCFG, im, n_slots=S, tracker=tracker,
                           governor=gov, paused=True, metrics=reg,
                           flight=fl, device="cpu") as eng:
        eng.warmup()
        assert eng.plan is None       # the warm-up restores the latch
        futs = _submit_all(eng, _task_w(S), steps, S)
        eng.start()
        eng.flush(timeout=FLUSH_S)
        for fs in futs.values():
            for f in fs:
                f.result(timeout=RESULT_S)
        with pytest.raises(RuntimeError, match="governor"):
            eng.set_plan(None)
    recs = fl.records()
    assert len(recs) == len(gov.plan_log) == T
    assert plan_timeline(recs) == gov.plan_log
    for r in recs:
        assert "telemetry" in r and "lowering" in r
        assert isinstance(r["governor"]["level"], int)
        assert r["governor"]["slack"] is not None
        assert r["plan"] == {"banks": r["telemetry"]["banks"],
                             "planes": r["telemetry"]["planes"]}
    assert eng.summary()["telemetry_dropped"] == 0
    snap = reg.snapshot()
    assert snap["torr_steps_total"]["series"][0]["value"] == T
    assert eng.governor_summary()["plan_switches"] >= 0


def test_cancelled_future_counts_as_telemetry_dropped():
    """A window orphaned mid-flight is counted, not silently lost."""
    S, T = 2, 3
    im, _ = _memories()
    steps = _make_inputs(TCFG, S, T)
    reg = MetricsRegistry()
    with AsyncStreamEngine(TCFG, im, n_slots=S, paused=True, metrics=reg,
                           device="cpu") as eng:
        futs = _submit_all(eng, _task_w(S), steps, S)
        assert futs[0][0].cancel()        # orphan one pending window
        eng.start()
        eng.flush(timeout=FLUSH_S)
        for f in futs[0][1:] + futs[1]:
            f.result(timeout=RESULT_S)
    assert eng.stats.telemetry_dropped == 1
    assert eng.summary()["telemetry_dropped"] == 1
    snap = reg.snapshot()
    assert snap["torr_telemetry_dropped_total"]["series"][0]["value"] == 1



def test_concurrent_submitters_resolve_every_window_once():
    """Callers on several threads (more than the cores, with a short
    switch interval) submit while the workers run: every window resolves
    exactly once, with a result, and the counters agree."""
    import sys
    import threading

    S, T = 4, 6
    im, _ = _memories()
    steps = _make_inputs(TCFG, S, T)
    task_w = _task_w(S)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    eng = AsyncStreamEngine(TCFG, im, n_slots=S, device="cpu")
    futs = {s: [] for s in range(S)}
    try:
        for s in range(S):
            eng.admit(f"cam{s}", task_w[s])

        def feed(s):
            for q, valid, boxes, _qd in steps:
                futs[s].append(eng.submit(f"cam{s}", q[s], valid[s],
                                          boxes[s]))

        threads = [threading.Thread(target=feed, args=(s,))
                   for s in range(S)]
        threads += [threading.Thread(target=lambda: [eng.backlog("cam0")
                                                     for _ in range(200)])
                    for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=FLUSH_S)
            assert not t.is_alive()
        eng.flush(timeout=FLUSH_S)
        for s in range(S):
            assert len(futs[s]) == T
            for f in futs[s]:
                out, _tel = f.result(timeout=RESULT_S)
                assert np.isfinite(out.scores).all()
    finally:
        sys.setswitchinterval(old)
        eng.close()
    assert eng.stats.windows == S * T
    assert eng._inflight == 0
