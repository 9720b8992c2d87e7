"""Port parity: stream-sharded serving (the stream half of
``repro_torch.runtime.sharding``, ``AsyncStreamEngine(mesh=)`` and the
launcher's ``--mesh``) against ``repro``'s helpers and sync engine.

``repro`` holds its sharded engine bit-equal to its sync engine on four
fake host devices (``tests/test_async_engine.py::
test_async_sharded_matches_sync_on_fake_devices``, the compact dispatch
with ``bucket_cap=8`` in ``tests/test_compact_dispatch.py``, the batched
decide in ``tests/test_decide_batched.py``). Here the port's engine shards
6 slots, padded to 8, over 4 CPU shards (``stream_mesh(devices=["cpu"] *
4)``, the counterpart of ``--xla_force_host_platform_device_count=4``):
its outputs and telemetry equal, bit for bit, the port's sync engine and
``repro``'s sync engine fed the same arrays, for the default lowering and
compact with ``bucket_cap=8`` under the batched and the scan decide; so
do admit, retire and a snapshot restore landing on shard 2, and a
supervised sharded engine recovering from a dispatcher death. Every
engine is closed in a ``finally`` and every wait has a timeout.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import sharding as jshd
from repro.serving.stream_engine import StreamEngine as JEngine
from repro_torch.core import pipeline
from repro_torch.launch import serve
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.fault import FaultPlan
from repro_torch.serving.async_engine import AsyncStreamEngine
from repro_torch.serving.state_store import InMemoryStateStore
from repro_torch.serving.stream_engine import StreamEngine
from repro_torch.serving.supervisor import ServeSupervisor

from _torch_parity import assert_dataclass_same, assert_same
from test_torch_engine import JCFG, TCFG, _make_inputs, _memories

FLUSH_S = 120
RESULT_S = 30
S, T = 6, 3          # 6 slots padded to 8 over 4 shards


def _cpu_mesh(n=4):
    return shd.stream_mesh(devices=["cpu"] * n)


def _task_w(n):
    return np.random.default_rng(1).uniform(0, 1, (n, TCFG.M)) \
        .astype(np.float32)


# --- the helpers ------------------------------------------------------------

@pytest.mark.parametrize("n_slots,n_dev", [(1, 1), (6, 4), (8, 4), (15, 2),
                                           (16, 2), (5, 8), (0, 3)])
def test_pad_stream_slots_matches_reference(n_slots, n_dev):
    mesh = _cpu_mesh(n_dev)
    assert mesh.shape == {"stream": n_dev} and mesh.devices.size == n_dev
    # repro's helper reads only mesh.shape["stream"]
    assert shd.pad_stream_slots(n_slots, mesh) == \
        jshd.pad_stream_slots(n_slots, mesh)
    assert shd.pad_stream_slots(n_slots, None) == \
        jshd.pad_stream_slots(n_slots, None) == n_slots


def test_stream_specs_match_reference():
    """Every leaf of the stacked state: the stream spec is repro's
    ``PartitionSpec`` as a tuple; the item memory's is replicated."""
    mesh = _cpu_mesh()
    state = pipeline.init_multi_stream_state(TCFG, torch.zeros((8, TCFG.M)),
                                             device="cpu")
    specs = shd.stream_sharding(state, mesh)
    n = 0
    for f in ("packed", "acc", "acc_tag", "out", "topk_key", "margin",
              "age", "valid"):
        leaf = getattr(state.cache, f)
        got = getattr(specs.cache, f)
        assert got.mesh is mesh
        assert got.spec == tuple(jshd.stream_spec(jnp.zeros(leaf.shape)))
        n += 1
    assert specs.task_weights.spec == ("stream", None) == tuple(
        jshd.stream_spec(jnp.zeros(state.task_weights.shape)))
    im, _ = _memories()
    rep = shd.replicated_sharding({"packed": im.packed}, mesh)
    assert rep["packed"].spec == () == tuple(jshd.P())
    assert n == 8
    with pytest.raises(ValueError, match="at least one"):
        shd.stream_mesh(devices=[])


def test_stream_mesh_counts_the_cards(monkeypatch):
    """The first n cards, None or 0 all of them; too many raises repro's
    message."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert shd.stream_mesh(1) == (torch.device("cuda", 0),)
    assert shd.stream_mesh() == shd.stream_mesh(0) == (
        torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="requested 3 devices, only 2 "
                                         "present"):
        shd.stream_mesh(3)


def test_split_and_join_streams():
    mesh = _cpu_mesh()
    rng = np.random.default_rng(0)
    state = pipeline.init_multi_stream_state(
        TCFG, torch.from_numpy(_task_w(8)), device="cpu")
    parts = shd.split_streams(state, mesh)
    assert shd.stream_rows(8, mesh) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert [p.task_weights.shape[0] for p in parts] == [2, 2, 2, 2]
    assert_dataclass_same(shd.join_streams(parts, "cpu"), state, "join")
    # a shard owns its rows: writing them leaves the whole tree alone
    before = state.task_weights.clone()
    parts[1].task_weights.copy_(torch.from_numpy(
        rng.uniform(size=(2, TCFG.M)).astype(np.float32)))
    assert torch.equal(state.task_weights, before)
    with pytest.raises(ValueError, match="pad them"):
        shd.stream_rows(6, mesh)


# --- the sharded engine -----------------------------------------------------

LOWERINGS = {"default": {},
             "compact-batched-cap8": dict(fused="compact", bucket_cap=8),
             "compact-scan-cap8": dict(fused="compact", bucket_cap=8,
                                       decide="scan")}


def _sync_results(eng, steps, task_w):
    for s in range(S):
        eng.admit(s, task_w[s])
        for q, v, b, _qd in steps:
            eng.submit(s, q[s], v[s], b[s])
    return eng.drain()


@pytest.mark.parametrize("lowering", list(LOWERINGS))
def test_sharded_engine_matches_sync_and_jax(lowering):
    """6 slots padded to 8 over 4 CPU shards == the port's sync engine ==
    repro's sync engine, every output and telemetry field of every window;
    the final state's rows equal the sync engine's."""
    kw = LOWERINGS[lowering]
    im, jm = _memories()
    task_w = _task_w(S)
    steps = _make_inputs(TCFG, S, T)
    sync = StreamEngine(TCFG, im, n_slots=S, device="cpu", **kw)
    res = _sync_results(sync, steps, task_w)
    jres = _sync_results(JEngine(JCFG, jm, n_slots=S, **kw), steps, task_w)
    eng = AsyncStreamEngine(TCFG, im, n_slots=S, mesh=_cpu_mesh(),
                            paused=True, **kw)
    try:
        assert eng.n_slots == 8 and len(eng.shards) == 4
        assert [(sh.lo, sh.hi) for sh in eng.shards] == \
            [(0, 2), (2, 4), (4, 6), (6, 8)]
        futs = {s: [] for s in range(S)}
        for s in range(S):
            eng.admit(s, task_w[s])
            for q, v, b, _qd in steps:
                futs[s].append(eng.submit(s, q[s], v[s], b[s]))
        eng.start()
        eng.flush(timeout=FLUSH_S)
        got = {s: [f.result(timeout=RESULT_S) for f in futs[s]]
               for s in range(S)}
        state = eng.state
    finally:
        eng.close()
    paths = []
    for s in range(S):
        for t in range(T):
            for i, what in enumerate(("out", "tel")):
                assert_dataclass_same(got[s][t][i], res[s][t][i],
                                      (lowering, "sync", s, t, what))
                assert_dataclass_same(got[s][t][i], jres[s][t][i],
                                      (lowering, "repro", s, t, what))
            paths.append(got[s][t][1].path)
    assert len(set(np.concatenate(paths).ravel())) > 1
    if kw.get("bucket_cap"):
        assert got[0][0][1].bucket_tier == 8
    rows = pipeline.TorrState(
        cache=type(state.cache)(**{
            f: getattr(state.cache, f)[:S]
            for f in state.cache.__dataclass_fields__}),
        task_weights=state.task_weights[:S])
    assert_dataclass_same(rows, sync.state, "final state")
    assert eng.stats.windows == S * T and eng.stats.steps == T
    assert eng.stats.pad_slots == 2 * T


def test_admit_retire_restore_land_on_their_shard():
    """Before the engine starts: retire the stream of slot 4 (shard 2)
    with its backlog queued and admit a new stream there. After serving:
    retire slot 5's stream (shard 2) and warm-start another there from
    stream 1's snapshot, then feed it stream 1's next windows beside
    stream 1, one window a stream and flush (queue depth 0, so batching
    does not matter). Every window equals the sync engine's under the
    same operations, and the warm-started stream equals stream 1."""
    im, _ = _memories()
    task_w = _task_w(S + 2)
    steps = _make_inputs(TCFG, S + 1, 2 * T, seed=5)

    def run(eng):
        live = isinstance(eng, AsyncStreamEngine)
        out = {}

        def submit(sid, col, t):
            q, v, b, _ = steps[t]
            out.setdefault(sid, []).append(
                eng.submit(sid, q[col], v[col], b[col]))

        def serve():
            if live:
                eng.flush(timeout=FLUSH_S)
                return
            for sid, rs in eng.drain().items():
                out.setdefault(sid, []).extend(rs)
            eng.flush_telemetry()       # writes the last step's snapshots

        for s in range(S):
            assert eng.admit(f"s{s}", task_w[s]) == s
            for t in range(T):
                submit(f"s{s}", s, t)
        submit("s4", 4, T)
        submit("s4", 4, T + 1)
        eng.retire("s4")                    # 5 windows dropped
        assert eng.admit("new", task_w[S]) == 4
        for t in range(T):
            submit("new", S, t)
        if live:
            eng.start()
        serve()
        # the collector writes a step's snapshots after resolving its
        # futures, so a flush may return first
        deadline = time.monotonic() + RESULT_S
        while eng._store.latest_seq("s1") < T and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        snap = eng._store.get("s1")
        assert snap is not None and snap.window_seq == T
        eng.retire("s5")
        assert eng.admit("warm", task_w[S + 1], snapshot=snap) == 5
        for t in range(T, 2 * T):
            submit("s1", 1, t)
            submit("warm", 1, t)
            serve()
        if live:
            out = {sid: [f.result(timeout=RESULT_S) for f in fs
                         if not f.cancelled()] for sid, fs in out.items()}
        else:
            out = {sid: [r for r in rs if isinstance(r, tuple)]
                   for sid, rs in out.items()}
        return out

    sync = StreamEngine(TCFG, im, n_slots=S, device="cpu",
                        store=InMemoryStateStore())
    ref = run(sync)
    eng = AsyncStreamEngine(TCFG, im, n_slots=S, mesh=_cpu_mesh(),
                            paused=True, store=InMemoryStateStore())
    try:
        assert eng._shard_of(4) == eng._shard_of(5) == 2
        got = run(eng)
    finally:
        eng.close()
    assert sorted(got) == sorted(ref) and got["s4"] == ref["s4"] == []
    for sid in ref:
        assert len(got[sid]) == len(ref[sid]) > 0 or sid == "s4", sid
        for w, (g, r) in enumerate(zip(got[sid], ref[sid])):
            assert_dataclass_same(g[0], r[0], (sid, w, "out"))
            assert_dataclass_same(g[1], r[1], (sid, w, "tel"))
    for g, r in zip(got["warm"], got["s1"][T:]):
        assert_dataclass_same(g[0], r[0], "warm == s1")
    assert eng.stats.dropped == sync.stats.dropped == T + 2


def test_supervised_sharded_recovery_equals_a_clean_run():
    """A dispatcher death at step 2 under the supervisor: the rebuilt
    engine is sharded again (the factory's mesh) and every window equals
    the clean unsharded run's."""
    im, _ = _memories()
    steps = _make_inputs(TCFG, S, 2 * T)
    task_w = _task_w(S)

    def drive(front, start):
        futs = {}
        for s in range(S):
            front.admit(f"cam{s}", task_w[s])
            for t, (q, v, b, _qd) in enumerate(steps):
                futs[(s, t)] = front.submit(f"cam{s}", q[s], v[s], b[s])
        start()
        front.flush(timeout=FLUSH_S)
        return {k: f.result(timeout=RESULT_S) for k, f in futs.items()}

    with AsyncStreamEngine(TCFG, im, n_slots=S, paused=True,
                           device="cpu") as clean:
        ref = drive(clean, clean.start)
    store = InMemoryStateStore()
    fault = FaultPlan(at_step=2, thread="dispatcher")
    built = []

    def make():
        eng = AsyncStreamEngine(TCFG, im, n_slots=S, mesh=_cpu_mesh(),
                                paused=True, store=store, fault_plan=fault)
        built.append(eng)
        return eng

    sup = ServeSupervisor(make, store)
    try:
        outs = drive(sup, lambda: sup.engine.start())
        summary = sup.summary()
    finally:
        sup.close(drain=False)
    assert sup.join_abandoned(timeout=30)
    assert summary["restarts"] == 1 and summary["pending"] == 0
    assert len(built) == 2 and all(len(e.shards) == 4 for e in built)
    assert set(outs) == set(ref)
    for k in ref:
        assert_dataclass_same(outs[k][0], ref[k][0], (k, "out"))
        for f in ("path", "delta_count", "banks", "rho", "n_valid",
                  "reasoner_active", "planes", "fused_mode"):
            assert_same(getattr(outs[k][1], f), getattr(ref[k][1], f),
                        (k, f))


def test_launcher_mesh_on_cpu_shards(capsys):
    """``--torr-streams 6 --mesh 4 --device cpu``: the async runtime over 4
    CPU shards, 8 slots, every window served."""
    serve.main(["--device", "cpu", "--torr-streams", "6", "--torr-frames",
                "2", "--mesh", "4"])
    out = capsys.readouterr().out
    assert "slots=8" in out and "mode=async" in out and "shards=4" in out
    assert "LOST" not in out
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--torr-streams", "2", "--mesh", "2",
                    "--torr-serial"])
    with pytest.raises(ValueError, match="counts cards"):
        serve.run_torr_streams(2, 1, mesh_devices=-1, device="cpu")
