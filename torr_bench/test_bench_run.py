"""Whole runs at a tiny size on the CPU: each cell's run is correct, and
with the timed path broken underneath, ``correct`` comes out false, once
for each fault the cells can have: a step that returns its state
unchanged, half of the batch left out and an answer altered where it is
produced. (The cells run on one card: no exchange between cards.)"""
import pytest

from tbench import serving
from tbench.testing import run_tiny


@pytest.mark.parametrize("cell,trace", [("edge-prefix-served", False),
                                        ("edge-prefix-served", True),
                                        ("edge-prefix-reuse", False),
                                        ("edge-prefix-reuse", True)])
def test_tiny_run_is_correct(cell, trace):
    rc, res = run_tiny(cell, trace=trace)
    assert rc == 0 and res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["metrics"]
    assert list(res)[-1] == "check"


def test_repeats_keep_a_sample_of_their_words_and_are_still_judged(
        monkeypatch):
    """What the driver holds on the card stops growing once every stream
    has cycled: a repeat's words are kept one submission in
    ``REPEAT_SAMPLE``, and a repeat without them is judged against the
    reference's walk over its first submission's words."""
    monkeypatch.setattr(serving, "REPEAT_SAMPLE", 4)
    seen = {}
    orig = serving.make_driver

    def keep(*a, **kw):
        seen["drv"] = orig(*a, **kw)
        return seen["drv"]
    monkeypatch.setattr(serving, "make_driver", keep)
    rc, res = run_tiny("edge-prefix-reuse", seconds=1.0)
    assert rc == 0 and res["correct"], res["check"]
    drv = seen["drv"]
    ws = [w for s in drv.windows for w in s]
    assert max(w.seq for w in ws) >= 2 * drv.Wn
    for w in ws:
        kept = w.seq < drv.Wn or w.seq % 4 == drv.keep_at[w.stream]
        assert (w.words is not None) == kept
    assert any(w.words is None and w.ok for w in ws)


def _state_unchanged(monkeypatch):
    from repro_torch.core import pipeline
    orig = pipeline.stream_batch_phases

    def broken(state, *a, **kw):
        _st, out, tel = yield from orig(state, *a, **kw)
        return state, out, tel
    monkeypatch.setattr(pipeline, "stream_batch_phases", broken)


def _half_the_batch(monkeypatch):
    import dataclasses

    from repro_torch.core import pipeline
    orig = pipeline.stream_batch_phases

    def broken(state, im, batch, *a, **kw):
        v = batch.valid.clone()
        v[v.shape[0] // 2:] = False
        return (yield from orig(state, im,
                                dataclasses.replace(batch, valid=v), *a,
                                **kw))
    monkeypatch.setattr(pipeline, "stream_batch_phases", broken)


def _answer_altered(monkeypatch):
    from repro_torch.serving.stream_engine import StreamEngine
    orig = StreamEngine._rows_to_host

    def broken(self, trees, readys):
        out, tel = orig(self, trees, readys)
        out.scores[0, 0, 0] += 1e-3
        return out, tel
    monkeypatch.setattr(StreamEngine, "_rows_to_host", broken)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _answer_altered])
@pytest.mark.parametrize("cell", ["edge-prefix-served", "edge-prefix-reuse"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, cell):
    fault(monkeypatch)
    rc, res = run_tiny(cell)
    assert rc == 0
    assert res["correct"] is False, res["check"]
