"""Port parity for the switch lowering: the plain versions of the
``fused_scores`` and ``delta_update`` kernels against JAX's Pallas kernels
in interpret mode, the switch window step on ``tests/test_pipeline.py``'s
scenarios, the serial multi-stream step and engine, and ``evaluate_task``
(AP@0.5, path mix, per-frame scores) — all bit-equal on the same numpy
inputs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import item_memory as jim
from repro.core import pipeline as jpipe
from repro.core.types import TorrConfig as JCfg
from repro.data import tood_synth as jts
from repro.kernels import fused_window as jfw
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serving import tood_pipelines as jtp
from repro.serving.stream_engine import StreamEngine as JEngine
from repro_torch import convert
from repro_torch.core import item_memory, pipeline
from repro_torch.core.types import FUSED_IDS, TorrConfig
from repro_torch.kernels import build, delta_update, fused_window, ops
from repro_torch.serving import tood_pipelines as tp
from repro_torch.serving.stream_engine import StreamEngine

from _torch_parity import (SMALL, assert_dataclass_same, assert_same,
                           bipolar, pack_np)
from test_torch_engine import _make_inputs, _memories
from test_torch_pipeline import CONFIGS, SCENARIOS, _jax_step, _scenario, \
    _setup

TCFG, JCFG = TorrConfig(**SMALL), JCfg(**SMALL)


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> tensor (uint32 words as their int32 bit patterns)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


# --- fused_scores ------------------------------------------------------------

@pytest.mark.parametrize("D,M,N", [(1024, 8, 1), (2048, 64, 16),
                                   (4096, 128, 8), (2048, 256, 3),
                                   (1024, 37, 5), (1024, 1, 4)])
def test_fused_scores_matches_pallas(D, M, N):
    """acc, argmax and top-2 of the plain version == the interpret-mode
    Pallas grid (tests/test_kernels.py::test_fused_scores_grid), including
    ragged M and M = 1 (top2[:, 1] = INT32_MIN)."""
    rng = np.random.default_rng(D + M + N)
    qp, imp = pack_np(bipolar(rng, (N, D))), pack_np(bipolar(rng, (M, D)))
    want = jfw.fused_scores(jnp.asarray(qp), jnp.asarray(imp), d_eff=D,
                            interpret=True)
    got = fused_window.fused_scores(_t(qp), _t(imp), d_eff=D)
    for g, w, name in zip(got, want, ("acc", "best", "top2")):
        assert g.dtype == torch.int32
        assert_same(g, w, name)


def test_fused_scores_argmax_tie_breaking():
    """Duplicated item-memory rows force exact ties: the first copy wins
    and top-1 == top-2 (tests/test_kernels.py, same fixture shape)."""
    rng = np.random.default_rng(0)
    hv0 = bipolar(rng, (8, 1024))
    imp = pack_np(np.concatenate([hv0, hv0]))
    qp = pack_np(bipolar(rng, (8, 1024)))
    acc, best, top2 = fused_window.fused_scores(_t(qp), _t(imp), d_eff=1024)
    want = jfw.fused_scores(jnp.asarray(qp), jnp.asarray(imp), d_eff=1024,
                            interpret=True)
    assert_same(best, want[1])
    assert_same(top2, want[2])
    assert (best < 8).all()
    assert torch.equal(top2[:, 0], top2[:, 1])


def test_fused_similarity_matches_jax():
    """The host-latched entry over the (banks, planes) plan grid, reading
    reduced planes from ``pmajor``."""
    cfg = TorrConfig(**SMALL)
    rng = np.random.default_rng(3)
    codes = bipolar(rng, (cfg.M, cfg.D))
    im = item_memory.build_item_memory(torch.from_numpy(codes))
    jm = jim.build_item_memory(jnp.asarray(codes))
    qp = pack_np(bipolar(rng, (6, cfg.D)))
    for banks, planes in ((8, 4), (8, 2), (3, 4), (1, 1)):
        kw = dict(banks=banks, bank_words=cfg.bank_words, planes=planes,
                  plane_total=cfg.bit_planes)
        got = ops.fused_similarity(_t(qp), im.packed, pmajor=im.pmajor, **kw)
        want = jops.fused_similarity(jnp.asarray(qp), jm.packed,
                                     pmajor=jm.pmajor, **kw)
        for g, w in zip(got, want):
            assert_same(g, w, (banks, planes))


# --- delta_update ------------------------------------------------------------

def _delta_inputs(rng, M, budget, D=1024, lead=()):
    dmaj = np.ascontiguousarray(bipolar(rng, (M, D)).T)
    acc = rng.integers(-1000, 1000, (*lead, M)).astype(np.int32)
    idx = rng.integers(0, D, (*lead, budget)).astype(np.int32)
    w = np.where(rng.random((*lead, budget)) < 0.5, 2, -2).astype(np.int32)
    w[..., budget // 2:] = 0                                   # padding
    return acc, dmaj, idx, w


@pytest.mark.parametrize("M,budget", [(64, 8), (128, 64), (384, 96),
                                      (7, 16)])
def test_delta_update_matches_pallas(M, budget):
    """The plain version == the scalar-prefetch Pallas kernel in interpret
    mode (tests/test_kernels.py::test_delta_update_property and
    ::test_delta_apply_dispatch; ragged M against JAX's oracle)."""
    rng = np.random.default_rng(M * budget)
    acc, dmaj, idx, w = _delta_inputs(rng, M, budget)
    interpret = True if M % 8 == 0 else None
    want = jfw.delta_apply(jnp.asarray(acc), jnp.asarray(dmaj),
                           jnp.asarray(idx), jnp.asarray(w),
                           interpret=interpret)
    got = fused_window.delta_apply(_t(acc), _t(dmaj), _t(idx), _t(w))
    assert_same(got, want)
    assert_same(ops.delta_update(_t(acc), _t(dmaj), _t(idx), _t(w)), want)


def test_delta_update_leading_batch_and_zero_rows():
    """A leading [L] batch (the loop's streams) equals L single calls; an
    all-zero-weight row returns its accumulator unchanged."""
    rng = np.random.default_rng(9)
    acc, dmaj, idx, w = _delta_inputs(rng, 64, 32, lead=(5,))
    w[2] = 0
    got = delta_update.delta_update(_t(acc), _t(dmaj), _t(idx), _t(w))
    for r in range(5):
        assert_same(got[r], jref.delta_update_ref(
            jnp.asarray(acc[r]), jnp.asarray(dmaj), jnp.asarray(idx[r]),
            jnp.asarray(w[r])), r)
    assert_same(got[2], acc[2])


# --- wrappers ------------------------------------------------------------

def test_switch_wrappers_route_cpu_tensors_to_plain(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernel loader reached from a CPU tensor")

    monkeypatch.setattr(build, "launch_fn", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    before = dict(build.LAUNCHES)
    q = torch.zeros((4, 16), dtype=torch.int32)
    fused_window.fused_scores(q, q, d_eff=512)
    acc, dmaj, idx, w = (_t(a) for a in _delta_inputs(
        np.random.default_rng(0), 8, 8, lead=(2,)))
    fused_window.delta_apply(acc, dmaj, idx, w)
    assert build.LAUNCHES == before


def test_switch_wrappers_reject_bad_inputs():
    q = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        fused_window.fused_scores(q.float(), q, d_eff=512)
    with pytest.raises(ValueError):
        fused_window.fused_scores(q, q[:, :8], d_eff=512)
    with pytest.raises(ValueError):
        fused_window.fused_scores(q, q[:0], d_eff=512)        # M = 0
    with pytest.raises(ValueError):
        fused_window.fused_scores(q.to("meta"), q.to("meta"), d_eff=512)
    acc, dmaj, idx, w = (_t(a) for a in _delta_inputs(
        np.random.default_rng(0), 8, 8, lead=(2,)))
    with pytest.raises(TypeError):
        delta_update.delta_update(acc, dmaj.to(torch.int32), idx, w)
    with pytest.raises(ValueError):
        delta_update.delta_update(acc, dmaj, idx, w[:, :4])
    with pytest.raises(ValueError):
        delta_update.delta_update(acc[0], dmaj, idx, w)     # leading axes
    with pytest.raises(ValueError):
        delta_update.delta_update(acc[:, :4], dmaj, idx, w)   # M mismatch


# --- the switch window step ----------------------------------------------

@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_switch_window_step_matches_jax(cfg_name, scenario):
    """The port's default single-window lowering against JAX's on the
    scenarios of tests/test_pipeline.py: every output, every telemetry
    field (fused_mode = switch) and the cache, window by window."""
    tcfg, jcfg, im, jm, task_w, qs, rng = _setup(CONFIGS[cfg_name])
    tstate = pipeline.init_state(tcfg, task_w, device="cpu")
    jstate = jpipe.init_state(jcfg, jnp.asarray(task_w))
    jstep = _jax_step(None)
    for t, (q_bip, qd, valid) in enumerate(_scenario(scenario, tcfg, qs,
                                                     rng)):
        q = pack_np(q_bip)
        boxes = rng.random((tcfg.N_max, 4)).astype(np.float32)
        tstate, tout, ttel = pipeline.torr_window_step(
            tstate, im, _t(q), valid, boxes, qd, tcfg)
        jstate, jout, jtel = jstep(jstate, jm, jnp.asarray(q),
                                   jnp.asarray(valid), jnp.asarray(boxes),
                                   jnp.int32(qd), jcfg)
        assert int(ttel.fused_mode) == FUSED_IDS["switch"]
        assert_dataclass_same(tout, jout, f"out[{t}]")
        assert_dataclass_same(ttel, jtel, f"tel[{t}]")
        assert_dataclass_same(tstate, jstate, f"state[{t}]")


@functools.lru_cache(maxsize=None)
def _jax_mstep(serial, fused):
    return jax.jit(functools.partial(jpipe.torr_multi_stream_step,
                                     serial=serial, fused=fused),
                   static_argnames="cfg")


@pytest.mark.parametrize("serial,fused,S", [(True, None, 1), (True, None, 4),
                                            (True, "prefix", 4),
                                            (False, "switch", 4)])
def test_multi_stream_switch_and_serial_match_jax(serial, fused, S):
    """The serial lowering (a loop over slots of the single-window step,
    JAX's lax.map; switch by default) and the batched step with
    fused="switch" (windows grouped by bank choice): every field equal to
    JAX's (tests/test_multistream.py::test_multi_stream_step_matches_\
sequential's fixtures)."""
    im, jm = _memories()
    task_w = np.random.default_rng(1).uniform(0, 1, (S, TCFG.M)) \
        .astype(np.float32)
    tstate = pipeline.init_multi_stream_state(TCFG, task_w, device="cpu")
    jstate = jpipe.init_multi_stream_state(JCFG, jnp.asarray(task_w))
    jstep = _jax_mstep(serial, fused)
    for t, (q, valid, boxes, qd) in enumerate(_make_inputs(TCFG, S, T=3)):
        tstate, tout, ttel = pipeline.torr_multi_stream_step(
            tstate, im, _t(q), valid, boxes, qd, TCFG, serial=serial,
            fused=fused)
        jstate, jout, jtel = jstep(jstate, jm, jnp.asarray(q),
                                   jnp.asarray(valid), jnp.asarray(boxes),
                                   jnp.asarray(qd), JCFG)
        assert_dataclass_same(tout, jout, f"out[{t}]")
        assert_dataclass_same(ttel, jtel, f"tel[{t}]")
        assert_dataclass_same(tstate, jstate, f"state[{t}]")


def test_switch_groups_heterogeneous_banks():
    """Per-stream bank choices 8/8/3/1 (tests/test_compact_dispatch.py's
    heterogeneous fixture): the switch dispatch launches one scan per
    distinct choice and every stream equals JAX's."""
    kw = dict(SMALL, K=4, fps_target=40000.0)
    tcfg, jcfg = TorrConfig(**kw), JCfg(**kw)
    S = 4
    rng = np.random.default_rng(2)
    codes = bipolar(rng, (tcfg.M, tcfg.D))
    im = item_memory.build_item_memory(torch.from_numpy(codes))
    jm = jim.build_item_memory(jnp.asarray(codes))
    task_w = rng.uniform(0, 1, (S, tcfg.M)).astype(np.float32)
    q_bip = bipolar(rng, (S, tcfg.N_max, tcfg.D))
    valid = np.repeat((np.arange(tcfg.N_max) < 6)[None], S, 0)
    boxes = np.zeros((S, tcfg.N_max, 4), np.float32)
    qd = np.array([0, 2, 8, 30], np.int32)
    tstate = pipeline.init_multi_stream_state(tcfg, task_w, device="cpu")
    jstate = jpipe.init_multi_stream_state(jcfg, jnp.asarray(task_w))
    jstep = _jax_mstep(False, "switch")
    for t in range(3):
        qb = q_bip.copy()
        if t:
            qb[:, :, t::97] *= -1
        q = pack_np(qb)
        tstate, tout, ttel = pipeline.torr_multi_stream_step(
            tstate, im, _t(q), valid, boxes, qd, tcfg, fused="switch")
        jstate, jout, jtel = jstep(jstate, jm, jnp.asarray(q),
                                   jnp.asarray(valid), jnp.asarray(boxes),
                                   jnp.asarray(qd), jcfg)
        assert_dataclass_same(tout, jout, t)
        assert_dataclass_same(ttel, jtel, t)
        assert_dataclass_same(tstate, jstate, t)
    assert sorted(set(ttel.banks.tolist())) == [1, 3, 8]


def test_serial_engine_matches_jax_engine():
    """StreamEngine(serial=True) with pad slots and real backlogs against
    JAX's (tests/test_multistream.py::test_stream_engine_matches_\
sequential): every output and telemetry field, the counters and the final
    state."""
    im, jm = _memories()
    S, T = 3, 4
    task_w = np.random.default_rng(4).uniform(0, 1, (S, TCFG.M)) \
        .astype(np.float32)
    steps = _make_inputs(TCFG, S, T, seed=5)
    engines = (StreamEngine(TCFG, im, n_slots=S + 1, serial=True,
                            device="cpu"),
               JEngine(JCFG, jm, n_slots=S + 1, serial=True))
    for e in engines:
        for s in range(S):
            e.admit(f"cam{s}", task_w[s])
            for q, v, b, _ in steps:
                e.submit(f"cam{s}", q[s], v[s], b[s])
    got, want = (e.drain() for e in engines)
    for s in range(S):
        for t in range(T):
            (to, tt), (jo, jt) = got[f"cam{s}"][t], want[f"cam{s}"][t]
            assert_dataclass_same(to, jo, (s, t))
            assert_dataclass_same(tt, jt, (s, t))
            assert int(tt.fused_mode) == FUSED_IDS["switch"]
    for k, v in engines[0].summary().items():
        assert v == engines[1].summary()[k], k
    assert_dataclass_same(engines[0].state, engines[1]._state, "final")


# --- the TOOD workload end to end ----------------------------------------

def test_evaluate_task_matches_jax():
    """AP@0.5 of TorR, dense and naive HDC, the path mix, every frame's
    scores and every telemetry field equal JAX's on the same system."""
    kw = dict(SMALL, K=8)
    tcfg, jcfg = TorrConfig(**kw), JCfg(**kw)
    world = jts.make_world(1, M=kw["M"], d=kw["feat_dim"])
    jsys = jtp.build_system(world, jcfg, seed=1)
    tsys = convert.system_from_numpy(jsys.R, np.asarray(jsys.im.bipolar),
                                     jsys.task_w, cfg=tcfg)
    for task in (0, 3):
        got = tp.evaluate_task(world, tsys, task, n_frames=6, seed=2,
                               queue_depth=1, device="cpu")
        want = jtp.evaluate_task(world, jsys, task, n_frames=6, seed=2,
                                 queue_depth=1)
        for k in ("task", "ap_dense", "ap_naive_hdc", "ap_torr", "path_mix"):
            assert got[k] == want[k], (task, k)
        for t, (tt, jt) in enumerate(zip(got["telemetry"],
                                         want["telemetry"])):
            assert_dataclass_same(tt, jt, (task, t))
    frames = jts.simulate_sequence(world, 3, 6, 2, n_max=kw["N_max"])
    jscores, _ = jtp.run_torr(jsys, frames, 3, 1)
    for t, (a, b) in enumerate(zip(got["scores"], jscores)):
        assert_same(a.astype(np.float32), b.astype(np.float32), t)
    assert got["path_mix"]["full"] < 1.0          # reuse happened
