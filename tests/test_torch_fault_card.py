"""Fault-tolerant serving on the card: a snapshot taken at step t is
unchanged by step t+1 (the captured step hands back clones, never the
graph's static outputs the next replay overwrites), and one supervised
recovery after an injected dispatcher death is bit-equal to a fault-free
run. Every test needs a CUDA card and skips without one; they import no
JAX, so the card's host runs them:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fault_card.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import capture
from repro_torch.core.types import TorrConfig
from repro_torch.runtime.fault import FaultPlan
from repro_torch.serving import state_store as ss
from repro_torch.serving.async_engine import AsyncStreamEngine
from repro_torch.serving.stream_engine import StreamEngine
from repro_torch.serving.supervisor import ServeSupervisor

from test_torch_capture import HET, _memories_het, _steps


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured only there")
    return torch.device("cuda")


def _task_w(cfg, s):
    return np.full(cfg.M, 0.25 * (s + 1), np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [None, "compact"])
def test_a_snapshot_is_unchanged_by_the_next_step(card, fused):
    cfg = TorrConfig(**HET)
    im, _ = _memories_het()
    S = 2
    steps = _steps(HET, S, 3)
    eng = StreamEngine(cfg, im, n_slots=S, device=card, fused=fused)
    eng.warmup()
    for s in range(S):
        eng.admit(s, _task_w(cfg, s))
    for q, v, b, _qd in steps:
        for s in range(S):
            eng.submit(s, q[s], v[s], b[s])
    eng.step()
    pending = [ss.snapshot_rows(eng.state, s, f"cam{s}", 1)
               for s in range(S)]
    torch.cuda.synchronize()
    before = capture.tree_map(lambda x: x.cpu().clone(), eng.state)
    # the state the step returned is not a graph's static output buffer
    static = {x.data_ptr() for key in eng.graphs.keys()
              for x in capture.leaves(eng.graphs.entry(key).outputs)}
    assert not static & {x.data_ptr() for x in capture.leaves(eng.state)}
    eng.step()      # replays the same graphs: their static outputs change
    eng.step()
    torch.cuda.synchronize()
    memo = {}
    for s, p in enumerate(pending):
        snap = ss.materialize_snapshot(
            p, memo, lambda st: eng._to_host(st, eng._ready_event()))
        want = ss.materialize_snapshot(ss.snapshot_rows(before, s, "x", 1))
        for f in ss.CACHE_FIELDS:
            assert np.array_equal(snap.cache[f], want.cache[f]), (s, f)
        assert np.array_equal(snap.task_w, want.task_w)
    # the next step did change the cache, so the check above has teeth
    after = capture.tree_map(lambda x: x.cpu(), eng.state)
    assert not torch.equal(after.cache.age, before.cache.age)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dispatcher", "collector"])
def test_one_recovery_on_the_card_is_bit_equal_to_a_fault_free_run(card,
                                                                   kind):
    cfg = TorrConfig(**HET)
    im, _ = _memories_het()
    S, T = 2, 5
    steps = _steps(HET, S, T)

    def serve(front, start):
        futs = {}
        for s in range(S):
            front.admit(s, _task_w(cfg, s))
            futs[s] = [front.submit(s, torch.from_numpy(
                q[s].view(np.int32)).to(card), v[s], b[s])
                for q, v, b, _qd in steps]
        start()
        front.flush(timeout=600)
        return {s: [f.result(timeout=60) for f in fs]
                for s, fs in futs.items()}

    ref_eng = AsyncStreamEngine(cfg, im, n_slots=S, paused=True, device=card)
    try:
        ref = serve(ref_eng, ref_eng.start)
    finally:
        ref_eng.close()

    store = ss.InMemoryStateStore()
    fault = FaultPlan(at_step=2, thread=kind)

    def make():
        return AsyncStreamEngine(cfg, im, n_slots=S, paused=True,
                                 device=card, store=store, fault_plan=fault)

    sup = ServeSupervisor(make, store, backoff_s=0.001)
    try:
        got = serve(sup, lambda: sup.engine.start())
        assert sup.summary()["restarts"] == 1
        assert sup.summary()["windows_replayed"] > 0
        (rec,) = sup.recoveries
        assert rec["captures"], "the rebuilt engine captured no graph"
    finally:
        sup.close(drain=False)
    assert sup.join_abandoned(timeout=60)
    for s in range(S):
        for t in range(T):
            for a, b in ((got[s][t][0], ref[s][t][0]),
                         (got[s][t][1], ref[s][t][1])):
                for f in dataclasses.fields(a):
                    x, y = getattr(a, f.name), getattr(b, f.name)
                    assert np.array_equal(
                        np.atleast_1d(np.asarray(x)).view(np.uint8),
                        np.atleast_1d(np.asarray(y)).view(np.uint8)), \
                        (s, t, f.name)


@pytest.mark.cuda
def test_two_threads_can_capture_at_once(card):
    """Two engines warming up, each capturing its first key, on two
    threads started together (a rebuilt engine's capture beside an
    abandoned dispatcher's): both captures succeed, since captures take
    turns, and each engine then serves as an engine captured alone."""
    import threading

    cfg = TorrConfig(**HET)
    im, _ = _memories_het()
    S = 2
    steps = _steps(HET, S, 2)
    kinds = (None, "compact")
    engines = [StreamEngine(cfg, im, n_slots=S, device=card, fused=f)
               for f in kinds]
    errors = []
    barrier = threading.Barrier(len(engines))

    def warm(eng):
        try:
            barrier.wait(timeout=60)
            eng.warmup()
        except BaseException as e:  # noqa: BLE001 (asserted below)
            errors.append(e)

    threads = [threading.Thread(target=warm, args=(e,)) for e in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    for fused, eng in zip(kinds, engines):
        alone = StreamEngine(cfg, im, n_slots=S, device=card, fused=fused)
        alone.warmup()
        res = []
        for e in (eng, alone):
            for s in range(S):
                e.admit(s, _task_w(cfg, s))
                for q, v, b, _qd in steps:
                    e.submit(s, q[s], v[s], b[s])
            res.append(e.drain())
        for s in range(S):
            for (o, t), (oa, ta) in zip(res[0][s], res[1][s]):
                for a, b in ((o, oa), (t, ta)):
                    for f in dataclasses.fields(a):
                        assert torch.equal(getattr(a, f.name).cpu(),
                                           getattr(b, f.name).cpu()), f.name
