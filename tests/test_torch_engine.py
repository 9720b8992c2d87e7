"""Port parity: the multi-stream step, the stream engine and the TOOD system
against ``repro``'s (same numpy inputs, bit-equal outputs, telemetry and
caches)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import item_memory as jim
from repro.core import pipeline as jpipe
from repro.core import reasoner as jreasoner
from repro.core.types import TorrConfig as JCfg
from repro.data import tood_synth as jts
from repro.serving import tood_pipelines as jtp
from repro.serving.stream_engine import StreamEngine as JEngine
from repro_torch import convert
from repro_torch.core import item_memory, pipeline, reasoner
from repro_torch.core.types import TorrConfig
from repro_torch.data import tood_synth as ts
from repro_torch.serving import tood_pipelines as tp
from repro_torch.serving.stream_engine import StreamEngine

from _torch_parity import (SMALL, assert_dataclass_same, assert_same,
                           bipolar, pack_np)

TCFG, JCFG = TorrConfig(**SMALL), JCfg(**SMALL)


def _make_inputs(cfg, S, T, seed=0):
    """Per-stream temporally coherent windows with varied load (as
    ``tests/test_multistream.py``): stream s flips a few dims per step and
    draws its own valid counts and queue depths."""
    rng = np.random.default_rng(seed)
    base = bipolar(rng, (S, cfg.N_max, cfg.D))
    steps = []
    for _ in range(T):
        flips = rng.integers(0, cfg.D, (S, cfg.N_max, 16))
        for s in range(S):
            for n in range(cfg.N_max):
                base[s, n, flips[s, n]] *= -1
        valid = rng.random((S, cfg.N_max)) < rng.uniform(0.3, 1.0, (S, 1))
        boxes = rng.random((S, cfg.N_max, 4)).astype(np.float32)
        qd = rng.integers(0, 2 * cfg.q_hi, (S,)).astype(np.int32)
        steps.append((pack_np(base), valid, boxes, qd))
    return steps


@functools.lru_cache(maxsize=None)
def _memories(seed=0):
    codes = bipolar(np.random.default_rng(seed), (TCFG.M, TCFG.D))
    return (item_memory.build_item_memory(torch.from_numpy(codes)),
            jim.build_item_memory(jnp.asarray(codes)))


@pytest.mark.parametrize("fused", ["prefix", "off"])
@pytest.mark.parametrize("S", [1, 4])
def test_multi_stream_step_matches_jax(S, fused):
    im, jm = _memories()
    task_w = np.random.default_rng(1).uniform(0, 1, (S, TCFG.M)) \
        .astype(np.float32)
    tstate = pipeline.init_multi_stream_state(TCFG, task_w)
    jstate = jpipe.init_multi_stream_state(JCFG, jnp.asarray(task_w))
    jstep = jax.jit(jpipe.torr_multi_stream_step, static_argnames="cfg")
    paths = []
    for t, (q, valid, boxes, qd) in enumerate(_make_inputs(TCFG, S, T=4)):
        tstate, tout, ttel = pipeline.torr_multi_stream_step(
            tstate, im, torch.from_numpy(q.view(np.int32)), valid, boxes, qd,
            TCFG, fused=fused)
        jstate, jout, jtel = jstep(jstate, jm, jnp.asarray(q),
                                   jnp.asarray(valid), jnp.asarray(boxes),
                                   jnp.asarray(qd), JCFG)
        assert_dataclass_same(tout, jout, f"out[{t}]")
        for f in ("path", "delta_count", "banks", "rho", "n_valid",
                  "reasoner_active", "queue_depth", "high_load", "planes",
                  "decide_mode", "bucket_tier"):
            assert_same(getattr(ttel, f), getattr(jtel, f), (t, f))
        assert_same(ttel.fused_mode, np.full(S, 2 if fused == "prefix" else 0))
        assert_dataclass_same(tstate, jstate, f"state[{t}]")
        paths.append(ttel.path.numpy())
    assert len(set(np.concatenate(paths).ravel())) > 1   # paths do vary


def test_stream_engine_matches_jax_engine():
    """admit, uneven backlogs, step, retire (dropping a backlog), re-admit
    into the recycled slot, drain: per-stream outputs and telemetry equal
    ``repro``'s engine window by window, and so do the counters."""
    im, jm = _memories()
    rng = np.random.default_rng(2)
    task_w = rng.uniform(-1, 1, (4, TCFG.M)).astype(np.float32)
    steps = _make_inputs(TCFG, 4, T=5, seed=3)
    teng = StreamEngine(TCFG, im, n_slots=3, device="cpu")
    jeng = JEngine(JCFG, jm, n_slots=3)
    backlog = {"a": 5, "b": 2, "c": 4}
    for e in (teng, jeng):
        for s, sid in enumerate(("a", "b", "c")):
            e.admit(sid, task_w[s])
            for t in range(backlog[sid]):
                q, v, b, _ = steps[t]
                e.submit(sid, q[s], v[s], b[s])
    results = {"port": [], "jax": []}
    for name, e in (("port", teng), ("jax", jeng)):
        results[name].append(e.step())
        results[name].append(e.step())
        e.retire("c")                   # two of c's windows still queued
        assert e.stats.dropped == 2
        e.admit("d", task_w[3])
        for t in range(3):
            q, v, b, _ = steps[t]
            e.submit("d", q[3], v[3], b[3])
        assert e.backlog("a") == 3 and e.backlog("d") == 3
        results[name].append(e.drain())
    # the first two steps return {sid: result}; the drain {sid: [results]}
    for k in (0, 1):
        tp_, jp = results["port"][k], results["jax"][k]
        assert list(tp_) == list(jp)
        for sid in tp_:
            assert_dataclass_same(tp_[sid][0], jp[sid][0], (k, sid))
            assert_dataclass_same(tp_[sid][1], jp[sid][1], (k, sid))
    td, jd = results["port"][2], results["jax"][2]
    assert sorted(td) == sorted(jd) and len(td["d"]) == 3
    for sid in td:
        assert len(td[sid]) == len(jd[sid])
        for w, (tr, jr) in enumerate(zip(td[sid], jd[sid])):
            assert_dataclass_same(tr[0], jr[0], (sid, w))
            assert_dataclass_same(tr[1], jr[1], (sid, w))
    tsum, jsum = teng.summary(), jeng.summary()
    for k, v in tsum.items():
        assert v == jsum[k], k
    assert_dataclass_same(teng.state, jeng._state, "final state")
    assert not teng.busy and teng.step() == {}


def test_engine_admission_rules():
    im, _ = _memories()
    w = np.zeros(TCFG.M, np.float32)
    eng = StreamEngine(TCFG, im, n_slots=1, device="cpu")
    eng.admit("a", w)
    with pytest.raises(ValueError):
        eng.admit("a", w)
    with pytest.raises(RuntimeError):
        eng.admit("b", w)
    eng.retire("a")
    eng.admit("b", w)
    eng._pending[0].append(None)        # a leaked backlog trips the check
    eng.retire("b")
    eng._pending[0].append(None)
    with pytest.raises(AssertionError, match="leaked"):
        eng.admit("c", w)
    # a latched KnobPlan is the part of the step still to port
    with pytest.raises(NotImplementedError):
        pipeline.torr_multi_stream_step(eng.state, im, None, None, None,
                                        None, TCFG, plan=object())
    with pytest.raises(NotImplementedError):
        pipeline.torr_multi_stream_step(eng.state, im, None, None, None,
                                        None, TCFG, serial=True,
                                        plan=object())


def test_engine_warmup_is_a_state_no_op():
    im, _ = _memories()
    eng = StreamEngine(TCFG, im, n_slots=2, device="cpu")
    eng.admit("a", np.ones(TCFG.M, np.float32))
    before = convert.to_numpy(eng.state)
    eng.warmup()
    after = convert.to_numpy(eng.state)
    for k in before["cache"]:
        assert_same(after["cache"][k], before["cache"][k], k)
    assert eng.stats.steps == 0


def test_build_system_with_supplied_arrays_matches_jax():
    kw = dict(SMALL)
    world = jts.make_world(0, M=kw["M"], d=kw["feat_dim"])
    tworld = ts.make_world(0, M=kw["M"], d=kw["feat_dim"])
    assert_same(tworld.prototypes, world.prototypes)
    jsys = jtp.build_system(world, JCFG, seed=0)
    graph = reasoner.TaskGraph(
        relations=torch.from_numpy(np.array(jsys.graph.relations)),
        text_hv=torch.from_numpy(np.array(jsys.graph.text_hv)))
    tsys = tp.build_system(tworld, TCFG, R=jsys.R, graph=graph)
    assert_same(tsys.R, np.asarray(jsys.R, np.float32))
    assert_dataclass_same(tsys.im, jsys.im)
    assert_same(tsys.task_w, jsys.task_w)
    for t in range(world.task_paths.shape[0]):
        assert_same(reasoner.compose_path(graph, t, world.task_paths[t]),
                    jreasoner.compose_path(jsys.graph, t,
                                           jnp.asarray(world.task_paths[t])))
    # supplied codes win; system_from_numpy is the same system
    tsys2 = tp.build_system(tworld, TCFG, R=jsys.R, graph=graph,
                            codes=np.asarray(jsys.im.bipolar))
    tsys3 = convert.system_from_numpy(jsys.R, np.asarray(jsys.im.bipolar),
                                      jsys.task_w, cfg=TCFG)
    for s in (tsys2, tsys3):
        assert_dataclass_same(s.im, jsys.im)
        assert_same(s.task_w, jsys.task_w)
    # with nothing supplied the generator draws a full system
    g = torch.Generator().manual_seed(0)
    own = tp.build_system(tworld, TCFG, g)
    assert own.im.bipolar.shape == (TCFG.M, TCFG.D)
    assert np.isfinite(own.task_w).all()


def test_run_torr_matches_jax():
    """``run_torr`` (encode front-end + window steps on the default
    lowering) on the CPU gives ``repro``'s per-frame scores and every
    telemetry field, given the same system; the encodings are checked
    equal first."""
    kw = dict(SMALL, K=8)     # cache depth >= proposals: reuse can happen
    tcfg, jcfg = TorrConfig(**kw), JCfg(**kw)
    world = jts.make_world(1, M=kw["M"], d=kw["feat_dim"])
    jsys = jtp.build_system(world, jcfg, seed=1)
    tsys = convert.system_from_numpy(jsys.R, np.asarray(jsys.im.bipolar),
                                     jsys.task_w, cfg=tcfg)
    frames = jts.simulate_sequence(world, 2, 4, seed=1, n_max=kw["N_max"])
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops
    for f in frames:
        assert_same(ops.encode_packed(f.feats, tsys.R, device="cpu")
                    .numpy().view(np.uint32),
                    jops.encode_packed(jnp.asarray(f.feats),
                                       jnp.asarray(jsys.R)))
    tscores, ttels = tp.run_torr(tsys, frames, 2, queue_depth=1,
                                 device="cpu")
    jscores, jtels = jtp.run_torr(jsys, frames, 2, queue_depth=1)
    for t in range(len(frames)):
        assert_same(tscores[t].astype(np.float32),
                    jscores[t].astype(np.float32), t)
        assert_dataclass_same(ttels[t], jtels[t], t)
    paths = np.concatenate([t.path.numpy() for t in ttels])
    assert (paths != 2).any()           # reuse happened after frame 0
