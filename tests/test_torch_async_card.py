"""The async engine on the card (``serving/async_engine.py``): its host
results equal the captured sync engine's, a key met while serving is
captured by the dispatcher thread, and a failing capture fails the
futures with ``EngineDead``. Every test needs a CUDA card and skips
without one; they import no JAX, so the card's host runs them:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_async_card.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.control import build_ladder
from repro_torch.core import capture
from repro_torch.core.types import TorrConfig
from repro_torch.serving.async_engine import AsyncStreamEngine
from repro_torch.serving.stream_engine import StreamEngine

from _torch_parity import assert_dataclass_same
from test_torch_capture import HET, _memories_het, _steps


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured only there")
    return torch.device("cuda")


def _serve_both(cfg, im, steps, S, card, plan=None, on_card=False, **kw):
    """The captured sync engine and a paused ``AsyncStreamEngine`` on the
    card over the same windows (the words as tensors on the card with
    ``on_card``), ``plan`` latched after the warm-up; returns both results,
    both final states and the async engine."""
    def windows(q, s):
        return torch.from_numpy(q[s].view(np.int32)).to(card) \
            if on_card else q[s]

    sync = StreamEngine(cfg, im, n_slots=S, device=card, **kw)
    sync.warmup()
    sync.set_plan(plan)
    for s in range(S):
        sync.admit(s, np.full(cfg.M, 0.25 * (s + 1), np.float32))
        for q, v, b, _qd in steps:
            sync.submit(s, windows(q, s), v[s], b[s])
    res_sync = sync.drain()
    eng = AsyncStreamEngine(cfg, im, n_slots=S, paused=True, device=card,
                            **kw)
    try:
        eng.warmup()
        eng.set_plan(plan)
        futs = {}
        for s in range(S):
            eng.admit(s, np.full(cfg.M, 0.25 * (s + 1), np.float32))
            futs[s] = [eng.submit(s, windows(q, s), v[s], b[s])
                       for q, v, b, _qd in steps]
        eng.start()
        eng.flush(timeout=600)
        res = {s: [f.result(timeout=60) for f in fs]
               for s, fs in futs.items()}
    finally:
        eng.close()
    return res, res_sync, eng.state, sync.state, eng


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(fused="compact", bucket_cap=2),
                                dict(serial=True)],
                         ids=["prefix", "compact", "serial"])
def test_async_engine_equals_sync_on_the_card(card, kw):
    """The async engine's host results equal the captured sync engine's,
    window by window, and so do the final states; the words go in as
    tensors on the card (gathered there) for prefix and as numpy (pinned
    staging) otherwise."""
    im, _ = _memories_het()
    cfg = TorrConfig(**HET)
    res, res_sync, st, st_sync, eng = _serve_both(
        cfg, im, _steps(HET, 3, 4, seed=7), 3, card, on_card=not kw, **kw)
    assert len(eng.graphs) > 0
    for s, wins in res.items():
        assert len(wins) == 4
        for t, (out, tel) in enumerate(wins):
            assert isinstance(out.scores, np.ndarray)
            assert_dataclass_same(out, res_sync[s][t][0], (s, t))
            assert_dataclass_same(tel, res_sync[s][t][1], (s, t))
    assert_dataclass_same(st, st_sync, "state")


@pytest.mark.cuda
def test_async_engine_captures_a_new_key_while_serving(card):
    """A plan latched after the warm-up is a new key: the dispatcher
    captures it inside the served loop, and the results still equal the
    captured sync engine's under the same plan."""
    im, _ = _memories_het()
    cfg = TorrConfig(**HET)
    plan = build_ladder(cfg)[3]
    res, res_sync, st, st_sync, eng = _serve_both(
        cfg, im, _steps(HET, 2, 3, seed=8), 2, card, plan=plan)
    assert len(eng.graphs.captures) == 2     # the warm-up's and the plan's
    for s, wins in res.items():
        for t, (out, tel) in enumerate(wins):
            assert_dataclass_same(out, res_sync[s][t][0], (s, t))
            assert_dataclass_same(tel, res_sync[s][t][1], (s, t))
    assert_dataclass_same(st, st_sync, "state")


@pytest.mark.cuda
def test_async_capture_error_fails_the_futures_on_the_card(card,
                                                           monkeypatch):
    """No fallback: a capture that fails in the dispatcher fails every
    window's future, and the flush, with EngineDead."""
    from repro_torch.runtime.fault import EngineDead

    im, _ = _memories_het()
    cfg = TorrConfig(**HET)
    steps = _steps(HET, 2, 2, seed=9)

    def broken(fn, inputs):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(capture.GraphFamily, "_capture",
                        staticmethod(broken))
    eng = AsyncStreamEngine(cfg, im, n_slots=2, paused=True, device=card)
    try:
        futs = []
        for s in range(2):
            eng.admit(s, np.full(cfg.M, 0.5, np.float32))
            futs += [eng.submit(s, q[s], v[s], b[s]) for q, v, b, _ in steps]
        eng.start()
        with pytest.raises(EngineDead, match="capture failed"):
            eng.flush(timeout=600)
        for f in futs:
            with pytest.raises(EngineDead):
                f.result(timeout=60)
    finally:
        with pytest.raises(EngineDead):
            eng.close()
    assert not eng._dispatcher.is_alive()
