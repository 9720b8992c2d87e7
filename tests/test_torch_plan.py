"""Port parity for the latched knob plan: the plan selectors, the planned
lookups, the full plan as a bit-exact no-op, reduced-plan scores, a stale
delta across a plan switch on every single-window lowering, the plan's
bucket tier, a tau offset at its float32 edge, and
``StreamEngine.set_plan`` over a plan sequence (the ladder over every
lowering of the multi-stream step is ``tests/test_torch_plan_grid.py``) —
each against ``repro`` on the same numpy inputs (every output,
telemetry field and cache leaf equal), mirroring the plan tests of
``tests/test_control.py``, ``tests/test_decide_batched.py`` and
``tests/test_compact_dispatch.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.control import KnobPlan as JPlan
from repro.control import build_ladder as jbuild_ladder
from repro.control import full_plan as jfull_plan
from repro.core import item_memory as jim
from repro.core import pipeline as jpipe
from repro.core.types import TorrConfig as JCfg
from repro.kernels import ops as jops
from repro.serving.stream_engine import StreamEngine as JEngine
from repro_torch.control import KnobPlan, build_ladder, full_plan
from repro_torch.core import aligner, item_memory, pipeline, query_cache
from repro_torch.core.types import (PATH_BYPASS, PATH_DELTA, PATH_FULL,
                                    TorrConfig, plan_tag)
from repro_torch.kernels import ops
from repro_torch.serving.stream_engine import StreamEngine

from _torch_parity import (SMALL, assert_dataclass_same, assert_same,
                           bipolar, pack_np)
from test_torch_engine import _make_inputs
from test_torch_switch import _t

TCFG, JCFG = TorrConfig(**SMALL), JCfg(**SMALL)
PLANS = [(8, 4), (8, 2), (8, 1), (4, 4), (4, 1), (2, 2), (1, 1)]


def _plans(banks, planes, **kw):
    """The same plan in both packages."""
    return (KnobPlan(banks=banks, planes=planes,
                     plane_total=TCFG.bit_planes, **kw),
            JPlan(banks=banks, planes=planes, plane_total=JCFG.bit_planes,
                  **kw))


@functools.lru_cache(maxsize=None)
def _memories(kw=tuple(sorted(SMALL.items())), seed=0):
    cfg = TorrConfig(**dict(kw))
    codes = bipolar(np.random.default_rng(seed), (cfg.M, cfg.D))
    return (item_memory.build_item_memory(torch.from_numpy(codes)),
            jim.build_item_memory(jnp.asarray(codes)))


@functools.lru_cache(maxsize=None)
def _jstep(single: bool):
    fn = jpipe.torr_window_step if single else jpipe.torr_multi_stream_step
    names = ("cfg", "plan", "fused", "bucket_cap", "decide")
    return jax.jit(fn, static_argnames=names if single
                   else names + ("serial",))


# --- plan geometry and the planned lookups ----------------------------------

def test_plan_selectors_match_jax():
    """plan_word_sel (host-latched wrappers), plan_word_mask and
    plan_dim_mask agree with JAX's and with each other for every plan."""
    for banks, planes in PLANS:
        sel = item_memory.plan_word_sel(TCFG, banks, planes)
        assert_same(sel, jim.plan_word_sel(JCFG, banks, planes))
        mask = item_memory.plan_word_mask(TCFG, banks, planes)
        assert sorted(sel.tolist()) == torch.nonzero(mask)[:, 0].tolist()
        assert sel.size * 32 == TCFG.d_eff_planned(banks, planes)
        dmask = item_memory.plan_dim_mask(TCFG, banks, planes)
        assert_same(dmask, jim.plan_dim_mask(JCFG, banks, planes))
        assert int(dmask.sum()) == TCFG.d_eff_planned(banks, planes)
    # stacked bank choices, one per stream
    assert_same(item_memory.plan_dim_mask(TCFG, torch.tensor([8, 2]), 3)[1],
                jim.plan_dim_mask(JCFG, 2, 3))


@pytest.mark.parametrize("banks,planes", PLANS)
def test_planned_lookups_match_jax_and_oracle(banks, planes):
    """The plane-gated scan (pmajor fast path and static gather) equals the
    integer dot over the plan's enabled dims and JAX's wrapper; the planned
    cache_nearest equals the per-query core nearest and JAX's."""
    im, jm = _memories()
    rng = np.random.default_rng(banks * 10 + planes)
    q_bip = bipolar(rng, (5, TCFG.D))
    q = pack_np(q_bip)
    kw = dict(banks=banks, bank_words=TCFG.bank_words, planes=planes,
              plane_total=TCFG.bit_planes)
    acc, cos = ops.packed_similarity(_t(q), im.packed, pmajor=im.pmajor,
                                     **kw)
    dmask = item_memory.plan_dim_mask(TCFG, banks, planes).numpy()
    want = np.where(dmask, q_bip, 0).astype(np.int64) @ \
        np.where(dmask, im.bipolar.numpy(), 0).astype(np.int64).T
    assert_same(acc, want.astype(np.int32))
    for g, w in zip((acc, cos), jops.packed_similarity(
            jnp.asarray(q), jm.packed, pmajor=jm.pmajor, **kw)):
        assert_same(g, w, (banks, planes))
    acc2, _ = ops.packed_similarity(_t(q), im.packed, **kw)
    assert_same(acc2, acc)

    cache = query_cache.init_cache(TCFG, device="cpu")
    for i in range(3):
        cache = query_cache.write_entry(
            cache, torch.tensor(i), packed=_t(pack_np(bipolar(rng, TCFG.D))),
            acc=torch.zeros(TCFG.M, dtype=torch.int32),
            acc_tag=plan_tag(banks, planes),
            out=torch.zeros(TCFG.M), topk_key=torch.zeros(
                TCFG.top_k, dtype=torch.int32), margin=torch.tensor(0.0))
    idx, rho, ham = ops.cache_nearest(_t(q), cache.packed, cache.valid, **kw)
    jidx, jrho, jham = jops.cache_nearest(
        jnp.asarray(q), jnp.asarray(cache.packed.numpy().view(np.uint32)),
        jnp.asarray(cache.valid.numpy()), **kw)
    for g, w in ((idx, jidx), (rho, jrho), (ham, jham)):
        assert_same(g, w, (banks, planes))
    for n in range(q.shape[0]):
        i1, r1, h1 = query_cache.nearest(cache, _t(q[n]), TCFG, banks, planes)
        assert (int(idx[n]), int(ham[n])) == (int(i1), int(h1))
        assert_same(rho[n], r1)


# --- the single-window step under plans ------------------------------------

def _window(seed, n_valid=None):
    rng = np.random.default_rng(seed)
    q_bip = bipolar(rng, (TCFG.N_max, TCFG.D))
    valid = np.arange(TCFG.N_max) < (TCFG.K - 1 if n_valid is None
                                     else n_valid)
    return q_bip, valid, np.zeros((TCFG.N_max, 4), np.float32)


def _both_step(states, q, valid, boxes, qd, plans, **kw):
    """One window through the port and JAX with the same plan and lowering;
    every output, telemetry field and cache leaf must be equal. Returns the
    new states and the port's (out, tel)."""
    im, jm = _memories()
    tstate, jstate = states
    tstate, tout, ttel = pipeline.torr_window_step(
        tstate, im, _t(q), valid, boxes, qd, TCFG, plan=plans[0], **kw)
    jstate, jout, jtel = _jstep(True)(
        jstate, jm, jnp.asarray(q), jnp.asarray(valid), jnp.asarray(boxes),
        jnp.int32(qd), JCFG, plan=plans[1], **kw)
    assert_dataclass_same(tout, jout, ("out", plans[0], kw))
    assert_dataclass_same(ttel, jtel, ("tel", plans[0], kw))
    assert_dataclass_same(tstate, jstate, ("state", plans[0], kw))
    return (tstate, jstate), (tout, ttel)


def _init(task_w):
    return (pipeline.init_state(TCFG, task_w, device="cpu"),
            jpipe.init_state(JCFG, jnp.asarray(task_w)))


def _task_w(seed=1, S=None):
    shape = (TCFG.M,) if S is None else (S, TCFG.M)
    return np.random.default_rng(seed).uniform(0, 1, shape) \
        .astype(np.float32)


@pytest.mark.parametrize("fused", ["switch", "prefix"])
def test_full_plan_is_bit_exact_noop(fused):
    """plan=full_plan(cfg) reproduces plan=None bit for bit over a warm
    full -> delta -> bypass sequence, and both equal JAX's."""
    q_bip, valid, boxes = _window(2)
    runs = []
    for plans in ((None, None), (full_plan(TCFG), jfull_plan(JCFG))):
        states, res = _init(_task_w()), []
        for t, qd in enumerate([0, 0, TCFG.q_hi]):
            qb = q_bip.copy()
            if t:
                qb[:, t::131] *= -1
            states, r = _both_step(states, pack_np(qb), valid, boxes, qd,
                                   plans, fused=fused)
            res.append(r)
        runs.append((states[0], res))
    (st0, r0), (st1, r1) = runs
    for (o0, t0), (o1, t1) in zip(r0, r1):
        assert_dataclass_same(o0, o1)
        assert_dataclass_same(t0, t1)
    assert_dataclass_same(st0, st1)
    assert {int(p) for _o, tl in r0 for p in tl.path[:TCFG.K - 1]} == \
        {PATH_FULL, PATH_DELTA, PATH_BYPASS}


@pytest.mark.parametrize("banks,planes", [(8, 2), (4, 4), (4, 2), (2, 1)])
def test_reduced_plan_full_scores_match_oracle(banks, planes):
    """Cold-cache full-path scores under a reduced plan equal JAX's and the
    integer dot over the plan's enabled dims times the task weights."""
    im, _ = _memories()
    task_w = _task_w()
    q_bip, valid, boxes = _window(3)
    q = pack_np(q_bip)
    _, (out, tel) = _both_step(_init(task_w), q, valid, boxes, 0,
                               _plans(banks, planes))
    nv = int(valid.sum())
    assert (tel.path[:nv] == PATH_FULL).all()
    assert int(tel.banks) == banks and int(tel.planes) == planes
    wmask = item_memory.plan_word_mask(TCFG, banks, planes)
    d_eff = TCFG.d_eff_planned(banks, planes)
    for n in range(nv):
        acc = aligner.full_dot(_t(q[n]), im, wmask)
        assert_same(out.scores[n], acc.float() / d_eff * torch.from_numpy(
            task_w))


@pytest.mark.parametrize("fused", ["off", "switch", "prefix", "compact"])
@pytest.mark.parametrize("pa,pb", [((8, 4), (4, 2)), ((8, 1), (8, 4)),
                                   ((2, 2), (1, 1)), ((4, 1), (4, 4))])
def test_plan_switch_rejects_stale_delta(pa, pb, fused):
    """tests/test_control.py::test_plan_switch_rejects_stale_delta and
    ::test_fused_delta_then_full_exact_after_plan_switch: a delta
    accumulator tagged under plan A is delta-corrected under A but never
    under B, whose window re-scans full, exactly, on every lowering."""
    im, _ = _memories()
    task_w = _task_w()
    rng = np.random.default_rng(sum(pa) * 10 + sum(pb))
    q_bip, valid, boxes = _window(int(rng.integers(1000)))
    q0 = pack_np(q_bip)
    # drift a few dims of word 0 (plane 0, bank 0: enabled under any plan)
    q_bip[:, rng.choice(32, size=4, replace=False)] *= -1
    q1 = pack_np(q_bip)
    plan_a, plan_b = _plans(*pa), _plans(*pb)
    nv = int(valid.sum())
    states, (_, tel0) = _both_step(_init(task_w), q0, valid, boxes, 0,
                                   plan_a, fused=fused)
    assert (tel0.path[:nv] == PATH_FULL).all()
    _, (_, tel_a) = _both_step(states, q1, valid, boxes, 0, plan_a,
                               fused=fused)
    assert (tel_a.path[:nv] == PATH_DELTA).all(), (pa, pb)
    _, (out_b, tel_b) = _both_step(states, q1, valid, boxes, 0, plan_b,
                                   fused=fused)
    assert (tel_b.path[:nv] == PATH_FULL).all(), (pa, pb)
    wmask_b = item_memory.plan_word_mask(TCFG, *pb)
    d_eff_b = TCFG.d_eff_planned(*pb)
    for n in range(nv):
        if bool(tel_b.reasoner_active[n]):
            acc = aligner.full_dot(_t(q1[n]), im, wmask_b)
            assert_same(out_b.scores[n],
                        acc.float() / d_eff_b * torch.from_numpy(task_w))


@pytest.mark.parametrize("decide", ["scan", "batched"])
def test_decide_delta_then_full_across_plan_switch(decide):
    """tests/test_decide_batched.py::test_decide_delta_then_full_across_\
plan_switch and tests/test_compact_dispatch.py::test_compact_delta_then_\
full_after_plan_switch: deltas under plan A, then plan B stales every tag
    and the full re-scans go through the bucket (an overflowing and the
    full tier), equal to JAX's compact step and to the port's oracle."""
    task_w = _task_w()
    q_bip, valid, boxes = _window(7)
    q0 = pack_np(q_bip)
    q_bip[:, :4] *= -1
    q1 = pack_np(q_bip)
    plan_a, plan_b = _plans(8, 4), _plans(4, 2)
    nv = int(valid.sum())
    finals = []
    for kw in (dict(fused="off"), dict(fused="compact", decide=decide,
                                       bucket_cap=2),
               dict(fused="compact", decide=decide)):
        states = _init(task_w)
        for q, plans, path in ((q0, plan_a, PATH_FULL),
                               (q1, plan_a, PATH_DELTA),
                               (q1, plan_b, PATH_FULL)):
            states, (out, tel) = _both_step(states, q, valid, boxes, 0,
                                            plans, **kw)
            assert (tel.path[:nv] == path).all(), kw
        finals.append((states[0], out))
    for st, out in finals[1:]:
        assert_dataclass_same(out, finals[0][1])
        assert_dataclass_same(st.cache, finals[0][0].cache)


def test_bucket_cap_precedence_and_plan_latch():
    """tests/test_decide_batched.py::test_bucket_cap_precedence (explicit
    argument > plan.bucket_cap > full capacity, loud clamps) and
    tests/test_compact_dispatch.py::test_compact_bucket_cap_latched_via_\
plan (the plan's tier is the step's when it gets none)."""
    resolve = pipeline._resolve_bucket_cap
    plan = _plans(8, 4, bucket_cap=2)[0]
    assert resolve(4, plan, 8) == 4
    assert resolve(None, plan, 8) == 2
    assert resolve(None, None, 8) == 8
    assert resolve(None, _plans(8, 4)[0], 8) == 8
    with pytest.warns(UserWarning, match="bucket_cap=16 exceeds"):
        assert resolve(16, plan, 8) == 8
    with pytest.warns(UserWarning, match="plan.bucket_cap=2 exceeds"):
        assert resolve(None, plan, 1) == 1
    with pytest.raises(ValueError):
        resolve(0, None, 8)
    with pytest.raises(ValueError):
        _plans(8, 4, bucket_cap=0)

    q_bip, valid, boxes = _window(11)
    states = _init(_task_w())
    for t in range(3):
        qb = q_bip.copy()
        if t:
            qb[:, t::131] *= -1
        states, (_o, tel) = _both_step(states, pack_np(qb), valid, boxes, 0,
                                       _plans(8, 4, bucket_cap=2),
                                       fused="compact")
        assert int(tel.bucket_tier) == 2


def test_tau_offset_at_its_float32_edge():
    """The deepest ladder level's tau offsets on a trace whose rho lands
    exactly on the offset threshold. tau_q - 0.05 and tau_byp - 0.03 are
    Python doubles a hair above 0.5625 and 0.875; each rounds once to that
    float32, so rho = 0.5625 takes the delta path and rho = 0.875 bypasses
    under high load, as in JAX (a float64 comparison would scan both
    full). Every lowering equals JAX's."""
    kw = dict(SMALL, tau_q=float(np.nextafter(0.6125, 1.0)),
              tau_byp=float(np.nextafter(0.905, 1.0)))
    tcfg, jcfg = TorrConfig(**kw), JCfg(**kw)
    plan, jplan = build_ladder(tcfg)[-1], jbuild_ladder(jcfg)[-1]
    assert (plan.banks, plan.planes) == (1, 1) and plan.tau_q_off == -0.05
    assert tcfg.tau_q + plan.tau_q_off > 0.5625
    assert np.float32(plan.thresholds(tcfg).tau_q) == np.float32(0.5625)
    im, jm = _memories(tuple(sorted(kw.items())))
    rng = np.random.default_rng(5)
    q_bip = bipolar(rng, (tcfg.N_max, tcfg.D))
    valid = np.arange(tcfg.N_max) < 3
    boxes = np.zeros((tcfg.N_max, 4), np.float32)
    q0 = pack_np(q_bip)
    # plan (1, 1) reads word 0 only (32 dims): flip 2, 7 and 8 of its bits
    # -> rho = 1 - 2h/32 = 0.875, 0.5625, 0.5
    for n, h in enumerate((2, 7, 8)):
        q_bip[n, rng.choice(32, size=h, replace=False)] *= -1
    q1 = pack_np(q_bip)
    task_w = _task_w()
    for low in (dict(fused="off"), dict(fused="switch"),
                dict(fused="prefix"), dict(fused="compact")):
        tst = pipeline.init_state(tcfg, task_w, device="cpu")
        jst = jpipe.init_state(jcfg, jnp.asarray(task_w))
        for q, qd in ((q0, 0), (q1, tcfg.q_hi)):
            tst, tout, ttel = pipeline.torr_window_step(
                tst, im, _t(q), valid, boxes, qd, tcfg, plan=plan, **low)
            jst, jout, jtel = _jstep(True)(
                jst, jm, jnp.asarray(q), jnp.asarray(valid),
                jnp.asarray(boxes), jnp.int32(qd), jcfg, plan=jplan, **low)
            assert_dataclass_same(tout, jout, low)
            assert_dataclass_same(ttel, jtel, low)
            assert_dataclass_same(tst, jst, low)
        assert ttel.rho[:3].tolist() == [0.875, 0.5625, 0.5]
        assert ttel.path[:3].tolist() == [PATH_BYPASS, PATH_DELTA,
                                          PATH_FULL], low


# --- the engine's plan latch ------------------------------------------------

@pytest.mark.parametrize("knobs", [dict(), dict(fused="compact"),
                                   dict(fused="auto"), dict(serial=True)],
                         ids=["prefix", "compact", "auto", "serial"])
def test_engine_set_plan_sequence_matches_jax(knobs):
    """StreamEngine.set_plan latches a plan per step (a ladder walk down,
    a return to None, a plan carrying a bucket tier): every window equals
    JAX's engine driven through the same sequence, and so does the final
    state; the plan property reads the latch back."""
    S = 3
    im, jm = _memories()
    task_w = _task_w(S=S)
    steps = _make_inputs(TCFG, S, T=6, seed=4)
    ladder, jladder = build_ladder(TCFG), jbuild_ladder(JCFG)
    seq = [(ladder[0], jladder[0]), (ladder[3], jladder[3]),
           (ladder[6], jladder[6]), (None, None), _plans(4, 2, bucket_cap=4),
           (ladder[5], jladder[5])]
    engines = (StreamEngine(TCFG, im, n_slots=S, device="cpu", **knobs),
               JEngine(JCFG, jm, n_slots=S, **knobs))
    for e in engines:
        for s in range(S):
            e.admit(s, task_w[s])
            for q, v, b, _qd in steps:
                e.submit(s, q[s], v[s], b[s])
    for t, plans in enumerate(seq):
        res = []
        for e, p in zip(engines, plans):
            e.set_plan(p)
            assert e.plan is p
            res.append(e.step())
        for s in range(S):
            assert_dataclass_same(res[0][s][0], res[1][s][0], (t, s))
            assert_dataclass_same(res[0][s][1], res[1][s][1], (t, s))
            if plans[0] is not None:
                assert int(res[0][s][1].planes) == plans[0].planes
    assert_dataclass_same(engines[0].state, engines[1]._state, "final")
    with pytest.raises(ValueError):
        engines[0].set_plan(KnobPlan(banks=2, planes=1, plane_total=8))
