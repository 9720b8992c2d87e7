"""Port parity: the session state store (``repro_torch.serving.state_store``)
against ``repro.serving.state_store``.

Mirrors ``tests/test_fault_serving.py``'s store cases (record round trip,
schema validation, TTL and monotonic puts, the JSONL store's torn trailing
line, tombstone and compaction) on the port's classes, then holds the
on-disk format to ``repro``'s: the JSONL files both packages' engines write
for the same streams and windows are byte-equal, each package's file
warm-starts the other's engine bit-equal to an uninterrupted run, and a
packed word >= 2**31 crosses unchanged (the port views its int32 words as
uint32, never casts).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import state_store as jss
from repro.serving.async_engine import AsyncStreamEngine as JAsync
from repro.serving.stream_engine import StreamEngine as JEngine
from repro_torch.serving import state_store as ss
from repro_torch.serving.async_engine import AsyncStreamEngine
from repro_torch.serving.state_store import (CACHE_FIELDS,
                                             InMemoryStateStore,
                                             JsonlStateStore, StreamSnapshot)
from repro_torch.serving.stream_engine import StreamEngine

from _torch_parity import assert_dataclass_same, assert_same, words
from test_torch_engine import JCFG, TCFG, _make_inputs, _memories

FLUSH_S = 120
RESULT_S = 30


def _snap(sid="cam0", seq=3, seed=0, m=8):
    rng = np.random.default_rng(seed)
    cache = {
        "packed": rng.integers(0, 2**32, (4, 2), dtype=np.uint32),
        "acc": rng.integers(-50, 50, (4, m), dtype=np.int32),
        "acc_tag": rng.integers(0, 4, (4,), dtype=np.int32),
        "out": rng.standard_normal((4, m)).astype(np.float32),
        "topk_key": rng.integers(-1, 9, (4, 2), dtype=np.int32),
        "margin": rng.standard_normal((4,)).astype(np.float32),
        "age": rng.integers(0, 9, (4,), dtype=np.int32),
        "valid": rng.integers(0, 2, (4,)).astype(bool),
    }
    return StreamSnapshot(stream_id=sid, window_seq=seq, cache=cache,
                          task_w=rng.standard_normal((m,)).astype(np.float32),
                          meta={"engine": "test"})


# --- the store (tests/test_fault_serving.py's cases) -------------------------

def test_snapshot_record_roundtrip_and_repro_record_equal():
    snap = _snap()
    rec = snap.to_record()
    back = StreamSnapshot.from_record(json.loads(json.dumps(rec)))
    assert back.stream_id == snap.stream_id
    assert back.window_seq == snap.window_seq
    for f in CACHE_FIELDS:
        assert np.array_equal(back.cache[f], snap.cache[f]), f
        assert back.cache[f].dtype == snap.cache[f].dtype, f
    np.testing.assert_array_equal(back.task_w, snap.task_w)
    assert back.meta == snap.meta
    # the same snapshot through repro's record: the same JSON text
    jsnap = jss.StreamSnapshot(snap.stream_id, snap.window_seq, snap.cache,
                               snap.task_w, snap.meta)
    assert json.dumps(rec) == json.dumps(jsnap.to_record())
    assert ss.STATE_SCHEMA_VERSION == jss.STATE_SCHEMA_VERSION
    assert ss.CACHE_FIELDS == jss.CACHE_FIELDS


def test_snapshot_schema_validation():
    snap = _snap()
    del snap.cache["margin"]
    with pytest.raises(ValueError, match="margin"):
        snap.validate()
    rec = _snap().to_record()
    rec["v"] = 99
    with pytest.raises(ValueError, match="schema"):
        StreamSnapshot.from_record(rec)


def test_inmemory_store_ttl_and_monotonic():
    now = [0.0]
    store = InMemoryStateStore(ttl_s=10.0, clock=lambda: now[0])
    store.put(_snap(seq=5))
    # a stale write (an abandoned engine's late delivery) cannot regress
    store.put(_snap(seq=4))
    assert store.latest_seq("cam0") == 5
    store.put(_snap(seq=6))
    assert store.latest_seq("cam0") == 6
    now[0] = 5.0
    assert store.get("cam0") is not None
    now[0] = 20.0
    assert store.get("cam0") is None        # TTL-expired: reaped on read
    assert store.latest_seq("cam0") == 0
    assert store.keys() == []


def test_jsonl_store_persistence_torn_line_and_tombstone(tmp_path):
    path = tmp_path / "state.jsonl"
    store = JsonlStateStore(path)
    store.put(_snap(sid="a", seq=1))
    store.put(_snap(sid="a", seq=2, seed=1))
    store.put(_snap(sid="b", seq=7))
    store.close()

    # a fresh process sees latest-record-wins
    store2 = JsonlStateStore(path)
    assert store2.latest_seq("a") == 2
    assert store2.latest_seq("b") == 7
    got = store2.get("a")
    want = _snap(sid="a", seq=2, seed=1)
    for f in CACHE_FIELDS:
        assert np.array_equal(got.cache[f], want.cache[f]), f
    store2.delete("a")                      # appends a tombstone
    store2.close()

    # SIGKILL mid-append: the torn trailing line is skipped
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(_snap(sid="b", seq=9).to_record())[:37])
    store3 = JsonlStateStore(path)
    assert store3.get("a") is None          # tombstone survived reload
    assert store3.latest_seq("b") == 7      # torn seq-9 write discarded
    # repro's store reads the same file the same way
    jstore = jss.JsonlStateStore(path)
    assert jstore.keys() == store3.keys() == ["b"]
    assert jstore.latest_seq("b") == 7
    jstore.close()
    n = store3.compact()
    assert n == 1
    store3.close()
    lines = [ln for ln in path.read_text().splitlines() if ln.strip()]
    assert len(lines) == 1
    assert json.loads(lines[0])["stream_id"] == "b"


# --- the engines' files against repro's -------------------------------------

S, T = 3, 4


def _task_w():
    return np.random.default_rng(1).uniform(0, 1, (S, TCFG.M)) \
        .astype(np.float32)


def _serve(eng, steps, start=True, admit=True, snaps=None):
    """Admit S streams (warm from ``snaps`` when given), submit ``steps``
    and drain; per-stream results, sync engines stepped, async flushed."""
    task_w = _task_w()
    if admit:
        for s in range(S):
            snap = None if snaps is None else snaps.get(f"cam{s}")
            eng.admit(f"cam{s}", task_w[s], snapshot=snap)
    futs = {s: [] for s in range(S)}
    for q, valid, boxes, _qd in steps:
        for s in range(S):
            futs[s].append(eng.submit(f"cam{s}", q[s], valid[s], boxes[s]))
    if hasattr(eng, "flush"):
        if start:
            eng.start()
        eng.flush(timeout=FLUSH_S)
        return {s: [f.result(timeout=RESULT_S) for f in futs[s]]
                for s in range(S)}
    res = eng.drain()
    eng.flush_telemetry()
    return {s: res[f"cam{s}"] for s in range(S)}


def _engines(kind, store, jstore, cadence=1):
    im, jm = _memories()
    if kind == "sync":
        return (StreamEngine(TCFG, im, n_slots=S, store=store,
                             snapshot_every=cadence, device="cpu"),
                JEngine(JCFG, jm, n_slots=S, store=jstore,
                        snapshot_every=cadence))
    return (AsyncStreamEngine(TCFG, im, n_slots=S, paused=True, store=store,
                              snapshot_every=cadence, device="cpu"),
            JAsync(JCFG, jm, n_slots=S, paused=True, store=jstore,
                   snapshot_every=cadence))


def _close(*engines):
    for eng in engines:
        if hasattr(eng, "close"):
            eng.close()


@pytest.mark.parametrize("kind,cadence", [("sync", 1), ("async", 1),
                                          ("async", 3)])
def test_engine_jsonl_files_byte_equal_to_repro(tmp_path, kind, cadence):
    """Both packages' engines over the same windows write the same JSONL
    store, byte for byte: every record of every stream, in order."""
    steps = _make_inputs(TCFG, S, T)
    tp, jp = tmp_path / "port.jsonl", tmp_path / "repro.jsonl"
    store, jstore = JsonlStateStore(tp), jss.JsonlStateStore(jp)
    eng, jeng = _engines(kind, store, jstore, cadence)
    try:
        res, jres = _serve(eng, steps), _serve(jeng, steps)
    finally:
        _close(eng, jeng)
        store.close()
        jstore.close()
    for s in range(S):
        for t in range(T):
            assert_dataclass_same(res[s][t][0], jres[s][t][0], (s, t))
    port_bytes = tp.read_bytes()
    assert port_bytes == jp.read_bytes()
    recs = [json.loads(ln) for ln in port_bytes.decode().splitlines()]
    assert len(recs) == S * (T // cadence)
    # the packed words include words >= 2**31, stored as repro's uint32
    packed = StreamSnapshot.from_record(recs[-1]).cache["packed"]
    assert packed.dtype == np.uint32 and (packed >= 2**31).any()


def _results_equal(got, want, what):
    for s in range(S):
        for t, (g, w) in enumerate(zip(got[s], want[s])):
            assert_dataclass_same(g[0], w[0], (what, s, t))


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_each_package_store_warm_starts_the_others_engine(tmp_path, writer):
    """A store file written by one package warm-starts the other's engine:
    the windows after the snapshot come out bit-equal to an uninterrupted
    run, and the restored caches equal the writer's."""
    steps = _make_inputs(TCFG, S, 2 * T)
    first, rest = steps[:T], steps[T:]
    im, jm = _memories()
    path = tmp_path / "state.jsonl"
    # the uninterrupted reference: repro's sync engine over both halves,
    # each half queued whole before it drains (the same queue depths the
    # warm-started engine sees over the second half)
    ref = JEngine(JCFG, jm, n_slots=S)
    _serve(ref, first)
    want = _serve(ref, rest, admit=False)
    if writer == "repro":
        jstore = jss.JsonlStateStore(path)
        _serve(JEngine(JCFG, jm, n_slots=S, store=jstore), first)
        jstore.close()
        store = JsonlStateStore(path)
        eng = StreamEngine(TCFG, im, n_slots=S, device="cpu")
        got = _serve(eng, rest, snaps=store)
        store.close()
        assert_same(words(eng.state.cache.packed),
                    words(ref._state.cache.packed))
        for f in CACHE_FIELDS[1:]:
            assert_same(getattr(eng.state.cache, f),
                        getattr(ref._state.cache, f), f)
    else:
        store = JsonlStateStore(path)
        _serve(StreamEngine(TCFG, im, n_slots=S, store=store, device="cpu"),
               first)
        store.close()
        jstore = jss.JsonlStateStore(path)
        jeng = JEngine(JCFG, jm, n_slots=S)
        got = _serve(jeng, rest, snaps=jstore)
        jstore.close()
    _results_equal(got, want, writer)


def test_packed_words_above_2_31_cross_unchanged(tmp_path):
    """uint32 words >= 2**31 (the sign bit of the port's int32 storage) go
    through a snapshot, the JSONL file and a restore into the engine's
    int32 state as the same bit patterns, and out again."""
    im, _ = _memories()
    snap = _snap(m=TCFG.M)
    K, W = TCFG.K, TCFG.words
    rng = np.random.default_rng(5)
    packed = rng.integers(0, 2**32, (K, W), dtype=np.uint32)
    packed[0, :4] = (0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000001)
    cache = {
        "packed": packed,
        "acc": rng.integers(-50, 50, (K, TCFG.M), dtype=np.int32),
        "acc_tag": rng.integers(0, 4, (K,), dtype=np.int32),
        "out": rng.standard_normal((K, TCFG.M)).astype(np.float32),
        "topk_key": rng.integers(0, TCFG.M, (K, TCFG.top_k),
                                 dtype=np.int32),
        "margin": rng.standard_normal((K,)).astype(np.float32),
        "age": rng.integers(0, 9, (K,), dtype=np.int32),
        "valid": np.ones((K,), bool),
    }
    snap = StreamSnapshot("cam0", 7, cache, snap.task_w, {"engine": "sync"})
    path = tmp_path / "s.jsonl"
    store = JsonlStateStore(path)
    store.put(snap)
    store.close()
    back = JsonlStateStore(path).get("cam0")
    assert back.cache["packed"].dtype == np.uint32
    assert np.array_equal(back.cache["packed"], packed)
    eng = StreamEngine(TCFG, im, n_slots=2, device="cpu")
    eng.admit("other", snap.task_w)
    slot = eng.admit("cam0", snap.task_w, snapshot=back)
    state = eng.state
    assert state.cache.packed.dtype == torch.int32
    assert np.array_equal(state.cache.packed[slot].numpy().view(np.uint32),
                          packed)
    for f in CACHE_FIELDS[1:]:
        assert np.array_equal(getattr(state.cache, f)[slot].numpy(),
                              cache[f]), f
    # and out again through the engine's own snapshot path
    again = ss.materialize_snapshot(
        ss.snapshot_rows(state, slot, "cam0", 7))
    assert again.cache["packed"].dtype == np.uint32
    assert np.array_equal(again.cache["packed"], packed)
    # repro restores the port's record into its uint32 cache unchanged
    from repro.core import pipeline as jpipe
    jstate = jpipe.init_multi_stream_state(
        JCFG, jnp.zeros((2, JCFG.M), jnp.float32))
    jrec = jss.StreamSnapshot.from_record(again.to_record())
    jstate = jss.restore_slot(jstate, JCFG, 1, jrec)
    assert np.array_equal(np.asarray(jstate.cache.packed[1]), packed)


def test_restore_rejects_a_schema_mismatch():
    im, _ = _memories()
    eng = StreamEngine(TCFG, im, n_slots=1, device="cpu")
    snap = _snap(m=TCFG.M)      # K=4 but 2 words: not this engine's shape
    with pytest.raises(ValueError, match="packed"):
        eng.admit("cam0", snap.task_w, snapshot=snap)
    # a packed row cast to int32 (not repro's uint32) is refused, too
    good = ss.materialize_snapshot(ss.snapshot_rows(
        StreamEngine(TCFG, im, n_slots=1, device="cpu").state, 0, "x", 1))
    bad = StreamSnapshot("x", 1, dict(good.cache,
                                      packed=good.cache["packed"].view(
                                          np.int32)), good.task_w)
    with pytest.raises(ValueError, match="uint32"):
        StreamEngine(TCFG, im, n_slots=1, device="cpu").admit(
            "x", good.task_w, snapshot=bad)
