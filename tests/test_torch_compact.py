"""Port parity for the compact dispatch: the plain version of the
``packed_hamming_batched`` kernel against JAX's Pallas kernel in interpret
mode, the lookup ops, the decide passes (scan and batched: decision
7-tuple and ``aux``), the compact step over bucket tiers (overflow
included) on ``tests/test_decide_batched.py``'s and
``tests/test_compact_dispatch.py``'s adversarial fixtures, and the engine's
``fused="auto"`` dispatch — all bit-equal to ``repro`` on the same numpy
inputs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import item_memory as jim
from repro.core import pipeline as jpipe
from repro.core import policy as jpolicy
from repro.core import query_cache as jqc
from repro.core.types import TorrConfig as JCfg
from repro.kernels import ops as jops
from repro.kernels import xnor_popcount_sim as jxps
from repro.serving.stream_engine import StreamEngine as JEngine
from repro_torch import convert
from repro_torch.core import item_memory, pipeline, policy, query_cache
from repro_torch.core.types import (DECIDE_IDS, FUSED_IDS, PATH_DELTA,
                                    PATH_FULL, TorrConfig)
from repro_torch.kernels import build, ops, xnor_popcount_sim
from repro_torch.serving.stream_engine import StreamEngine

from _torch_parity import (SMALL, assert_dataclass_same, assert_same,
                           bipolar, pack_np)
from test_decide_batched import _episode
from test_torch_switch import _t

K8 = dict(SMALL, K=8)
DEC_NAMES = ("action", "idx", "lru", "d_idx", "d_weight", "d_count", "rho")


def _words(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


# --- packed_hamming_batched and the lookup ops ------------------------------

@pytest.mark.parametrize("S,N,M,W", [(2, 16, 8, 256), (2, 16, 16, 256),
                                     (1, 5, 3, 40), (3, 7, 13, 8)])
def test_packed_hamming_batched_matches_pallas(S, N, M, W):
    """Each batch of the plain version == the interpret-mode Pallas grid,
    at the decide pass's shapes (M = K small, M = N) and ragged ones; the
    2-D form agrees."""
    rng = np.random.default_rng(S * 100 + N + M + W)
    q, h = _words(rng, (S, N, W)), _words(rng, (S, M, W))
    got = xnor_popcount_sim.packed_hamming_batched(_t(q), _t(h))
    assert got.shape == (S, N, M) and got.dtype == torch.int32
    for s in range(S):
        want = jxps.packed_hamming_batched(jnp.asarray(q[s]),
                                           jnp.asarray(h[s]),
                                           tw=min(128, W), interpret=True)
        assert_same(got[s], want, s)
        assert_same(xnor_popcount_sim.packed_hamming_batched(
            _t(q[s]), _t(h[s])), want, s)


def test_lookup_ops_match_jax():
    """packed_similarity, cache_nearest (over plans) and masked_hamming_all
    (per-window word masks, stacked per stream) == JAX's."""
    cfg = TorrConfig(**SMALL)
    rng = np.random.default_rng(4)
    codes = bipolar(rng, (cfg.M, cfg.D))
    im = item_memory.build_item_memory(torch.from_numpy(codes))
    jm = jim.build_item_memory(jnp.asarray(codes))
    q = pack_np(bipolar(rng, (6, cfg.D)))
    cache = pack_np(bipolar(rng, (cfg.K, cfg.D)))
    cache[1] = q[2]
    valid = np.array([True, True, False, True])
    for banks, planes in ((8, 4), (8, 2), (3, 4), (1, 1)):
        kw = dict(banks=banks, bank_words=cfg.bank_words, planes=planes,
                  plane_total=cfg.bit_planes)
        got = ops.packed_similarity(_t(q), im.packed, pmajor=im.pmajor, **kw)
        want = jops.packed_similarity(jnp.asarray(q), jm.packed,
                                      pmajor=jm.pmajor, **kw)
        for g, w in zip(got, want):
            assert_same(g, w, (banks, planes))
        got = ops.cache_nearest(_t(q), _t(cache), torch.from_numpy(valid),
                                **kw)
        want = jops.cache_nearest(jnp.asarray(q), jnp.asarray(cache),
                                  jnp.asarray(valid), **kw)
        for g, w in zip(got, want):
            assert_same(g, w, (banks, planes))
    wm = np.stack([np.arange(cfg.words) < b * cfg.bank_words
                   for b in (8, 3)])
    qs = pack_np(bipolar(rng, (2, 6, cfg.D)))
    es = pack_np(bipolar(rng, (2, 5, cfg.D)))
    got = ops.masked_hamming_all(_t(qs), _t(es), torch.from_numpy(wm))
    for s in range(2):
        assert_same(got[s], jops.masked_hamming_all(
            jnp.asarray(qs[s]), jnp.asarray(es[s]), jnp.asarray(wm[s])), s)


def test_batched_hamming_wrappers_route_and_reject(monkeypatch):
    q = torch.zeros((2, 4, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        xnor_popcount_sim.packed_hamming_batched(q.float(), q)
    with pytest.raises(ValueError):
        xnor_popcount_sim.packed_hamming_batched(q, q[0])      # ranks
    with pytest.raises(ValueError):
        xnor_popcount_sim.packed_hamming_batched(q, q[:1])     # batches
    with pytest.raises(ValueError):
        xnor_popcount_sim.packed_hamming_batched(q, q[..., :8])
    with pytest.raises(ValueError):
        xnor_popcount_sim.packed_hamming_batched(q.to("meta"), q.to("meta"))

    def refuse(*a, **k):
        raise AssertionError("kernel loader reached from a CPU tensor")

    monkeypatch.setattr(build, "launch_fn", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    before = dict(build.LAUNCHES)
    xnor_popcount_sim.packed_hamming_batched(q, q)
    xnor_popcount_sim.packed_hamming_batched(q[0], q[0])
    ops.masked_hamming_all(q, q, torch.ones((2, 16), dtype=torch.bool))
    assert build.LAUNCHES == before


# --- cache views, policy helpers ---------------------------------------------

def _jax_cache(cfg, rng, n_valid):
    c = jqc.init_cache(cfg)
    packed = pack_np(bipolar(rng, (cfg.K, cfg.D)))
    valid = np.arange(cfg.K) < n_valid
    age = rng.integers(0, 9, cfg.K).astype(np.int32)
    tag = rng.integers(0, 3, cfg.K).astype(np.int32) * 256 + 4
    return jqc.CacheState(jnp.asarray(packed), c.acc, jnp.asarray(tag),
                          c.out, c.topk_key, c.margin, jnp.asarray(age),
                          jnp.asarray(valid))


def _port_cache(jc):
    return convert.cache_state_from_numpy(
        **{k: np.asarray(getattr(jc, k)) for k in convert.CACHE_FIELDS})


def test_meta_cache_and_batched_lookups_match_jax():
    cfg, jcfg = TorrConfig(**K8), JCfg(**K8)
    rng = np.random.default_rng(6)
    jc = _jax_cache(jcfg, rng, 6)
    tc = _port_cache(jc)
    q = pack_np(bipolar(rng, (5, cfg.D)))
    q[3] = np.asarray(jc.packed[2])
    for banks, planes in ((8, 4), (2, 2)):
        for g, w in zip(query_cache.nearest_all(tc, _t(q), cfg, banks,
                                                planes),
                        jqc.nearest_all(jc, jnp.asarray(q), jcfg, banks,
                                        planes)):
            assert_same(g, w, (banks, planes))
        assert_same(query_cache.hamming_all(query_cache.meta_view(tc), _t(q),
                                            cfg, banks, planes),
                    jqc.hamming_all(jqc.meta_view(jc), jnp.asarray(q), jcfg,
                                    banks, planes))
    tm, jm_ = query_cache.meta_view(tc), jqc.meta_view(jc)
    for t, j in ((query_cache.meta_touch(tm, torch.tensor(3)),
                  jqc.meta_touch(jm_, jnp.int32(3))),
                 (query_cache.meta_write(tm, torch.tensor(7),
                                         packed=_t(q[0]), acc_tag=1028),
                  jqc.meta_write(jm_, jnp.int32(7), packed=jnp.asarray(q[0]),
                                 acc_tag=1028))):
        assert_dataclass_same(t, j, "meta")


def test_policy_compact_helpers_match_jax():
    for n in (1, 8, 24, 2048):
        assert policy.bucket_ladder(n) == jpolicy.bucket_ladder(n)
        for want in (0, 1, 5, n // 3, n, 4 * n):
            assert policy.bucket_tier(n, want) == \
                jpolicy.bucket_tier(n, want)
    assert policy.bucket_ladder(24) == (1, 2, 4, 8, 16, 24)
    with pytest.raises(ValueError):
        policy.bucket_ladder(0)
    rng = np.random.default_rng(8)
    a = rng.integers(0, 4, (3, 16)).astype(np.int32)
    v = rng.random((3, 16)) < 0.7
    for s in range(3):
        assert_same(policy.intra_window_coupled(torch.from_numpy(a[s]),
                                                torch.from_numpy(v[s])),
                    jpolicy.intra_window_coupled(jnp.asarray(a[s]),
                                                 jnp.asarray(v[s])))


def test_resolve_knobs():
    """tests/test_decide_batched.py::test_decide_knob_validation and the
    plan-free half of ::test_bucket_cap_precedence."""
    with pytest.raises(ValueError, match="decide='psychic'"):
        pipeline._resolve_decide("psychic")
    assert pipeline._resolve_decide(None) == "batched"
    assert pipeline._resolve_decide("scan") == "scan"
    resolve = pipeline._resolve_bucket_cap
    assert resolve(4, None, 8) == 4
    assert resolve(None, None, 8) == 8
    with pytest.warns(UserWarning, match="bucket_cap=16 exceeds"):
        assert resolve(16, None, 8) == 8
    with pytest.raises(ValueError):
        resolve(0, None, 8)


# --- decide passes: the decision 7-tuple and aux -----------------------------

@functools.lru_cache(maxsize=None)
def _jax_decide():
    def run(cache, q, v, banks, planes, high, cfg):
        a = jax.vmap(lambda c, q, v, b, h: jpipe._decide_pass(
            c, q, v, cfg, b, planes, h))(cache, q, v, banks, high)
        b, aux = jax.vmap(lambda c, q, v, b, h: jpipe._decide_pass_batched_aux(
            c, q, v, cfg, b, planes, h))(cache, q, v, banks, high)
        return a, b, aux
    return jax.jit(run, static_argnames=("cfg", "planes"))


@pytest.mark.parametrize("planes,mix", [(4, 0.0), (4, 0.9), (1, 0.9)])
def test_decide_passes_match_jax(planes, mix):
    """Both decide passes over a warmed, churned stacked cache (streams at
    banks 8 and 4): the port's decision tuples and aux equal JAX's, and the
    port's two passes equal each other."""
    cfg, jcfg = TorrConfig(**SMALL), JCfg(**SMALL)
    S = 2
    eps = [_episode(jcfg, mix, 3, seed=10 * s + planes) for s in range(S)]
    rng = np.random.default_rng(planes)
    codes = bipolar(rng, (cfg.M, cfg.D))
    im = item_memory.build_item_memory(torch.from_numpy(codes))
    task_w = rng.uniform(0, 1, (S, cfg.M)).astype(np.float32)
    state = pipeline.init_multi_stream_state(cfg, task_w, device="cpu")
    banks = torch.tensor([8, 4], dtype=torch.int32)
    high = torch.tensor([True, False])
    decide = _jax_decide()
    for t in range(3):
        q = np.stack([eps[s][t][0] for s in range(S)])
        v = np.stack([eps[s][t][1] for s in range(S)])
        jcache = jqc.CacheState(*(jnp.asarray(convert.to_numpy(
            getattr(state.cache, k), words=k == "packed"))
            for k in convert.CACHE_FIELDS))
        a = pipeline._decide_pass(state.cache, _t(q), torch.from_numpy(v),
                                  cfg, banks, planes, high)
        b, aux = pipeline._decide_pass_batched_aux(
            state.cache, _t(q), torch.from_numpy(v), cfg, banks, planes,
            high)
        ja, jb, jaux = decide(jcache, jnp.asarray(q), jnp.asarray(v),
                              jnp.asarray(banks.numpy()), planes,
                              jnp.asarray(high.numpy()), jcfg)
        for name, x, y, z, w in zip(DEC_NAMES, a, b, ja, jb):
            assert_same(x, z, (t, "scan", name))
            assert_same(y, w, (t, "batched", name))
            assert_same(x, y, (t, name))
        for i, (x, y) in enumerate(zip(aux, jaux)):
            assert_same(x, y, (t, "aux", i))
        state, _, _ = pipeline.torr_multi_stream_step(
            state, im, _t(q), v, np.zeros((S, cfg.N_max, 4), np.float32),
            np.array([0, cfg.q_hi], np.int32), cfg, fused="compact",
            decide="scan")


# --- the compact step -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_steps(cfg):
    kw = dict(static_argnames=("cfg", "serial", "fused", "bucket_cap",
                               "decide"))
    return jax.jit(jpipe.torr_multi_stream_step, **kw)


def _run_pair(kw, windows, qd_seq, task_w, lowerings, seed=0):
    """Run the port (every lowering in ``lowerings``) and JAX (the first
    lowering, and ``fused="off"``) over the same [S]-stacked windows; every
    port lowering must equal JAX's output, telemetry (fused/decide/tier
    per its own lowering) and final cache, window by window. Returns the
    port's per-window telemetry of the first lowering."""
    tcfg, jcfg = TorrConfig(**kw), JCfg(**kw)
    codes = bipolar(np.random.default_rng(seed), (tcfg.M, tcfg.D))
    im = item_memory.build_item_memory(torch.from_numpy(codes))
    jm = jim.build_item_memory(jnp.asarray(codes))
    S = task_w.shape[0]
    jstep = _jax_steps(jcfg)
    boxes = np.zeros((S, tcfg.N_max, 4), np.float32)
    runs = {}
    for name, low in [("jax", lowerings[0]), ("off", dict(fused="off"))] + \
            [(i, low) for i, low in enumerate(lowerings)]:
        if name in ("jax", "off"):
            st = jpipe.init_multi_stream_state(jcfg, jnp.asarray(task_w))
        else:
            st = pipeline.init_multi_stream_state(tcfg, task_w,
                                                     device="cpu")
        res = []
        for (q, v), qd in zip(windows, qd_seq):
            if name in ("jax", "off"):
                st, out, tel = jstep(st, jm, jnp.asarray(q), jnp.asarray(v),
                                     jnp.asarray(boxes), jnp.asarray(qd),
                                     jcfg, **low)
            else:
                st, out, tel = pipeline.torr_multi_stream_step(
                    st, im, _t(q), v, boxes, qd, tcfg, **low)
            res.append((out, tel))
        runs[name] = (st, res)
    jst, jres = runs["jax"]
    ost, ores = runs["off"]
    for i in range(len(lowerings)):
        st, res = runs[i]
        for t, ((o, tl), (jo, jt), (oo, ot)) in enumerate(zip(res, jres,
                                                             ores)):
            assert_dataclass_same(o, jo, (i, t))
            assert_dataclass_same(o, oo, (i, t, "off"))
            for f in ("path", "delta_count", "banks", "rho", "n_valid",
                      "reasoner_active", "queue_depth", "high_load",
                      "planes"):
                assert_same(getattr(tl, f), getattr(jt, f), (i, t, f))
            low = lowerings[i]
            assert (tl.fused_mode == FUSED_IDS[low["fused"]]).all()
            if low["fused"] == "compact":
                dec = low.get("decide") or "batched"
                assert (tl.decide_mode == DECIDE_IDS[dec]).all()
                tier = low.get("bucket_cap") or S * tcfg.N_max
                assert (tl.bucket_tier == min(tier, S * tcfg.N_max)).all()
            if i == 0:
                assert_dataclass_same(tl, jt, (i, t, "tel"))
        assert_dataclass_same(st, jst, (i, "final"))
        assert_dataclass_same(st, ost, (i, "final off"))
    return [tl for _, tl in runs[0][1]]


def _stacked(eps, t):
    return (np.stack([e[t][0] for e in eps]), np.stack([e[t][1] for e in eps]))


def _compact_lowerings(tiers, serial=(False,), decides=("batched", "scan")):
    return [dict(fused="compact", bucket_cap=c, decide=d, serial=s)
            for c in tiers for d in decides for s in serial]


def _dup_window(cfg, seed, copies):
    rng = np.random.default_rng(seed)
    q = _words(rng, (cfg.N_max, cfg.words))
    for i, j in copies:
        q[j] = q[i]
    return q, np.ones((cfg.N_max,), bool)


def _adversarial_windows(cfg):
    """tests/test_decide_batched.py's conflict fixtures as one stream each:
    duplicate queries, a query equal to an earlier write and its perturbed
    twin, an LRU eviction chain longer than K (all-fresh windows,
    N_max = 2K), and an all-padding window between warm ones."""
    q_self, v = _dup_window(cfg, 5, copies=[(0, 4)])
    q_pert = q_self.copy()
    q_pert[4, 0] ^= np.uint32(0b1011)
    warm = _episode(cfg, 0.0, 1, seed=14)
    pad = (_dup_window(cfg, 13, [])[0], np.zeros(cfg.N_max, bool))
    return {
        "dup": [_dup_window(cfg, 3, copies=[(0, 1), (0, 7), (2, 3)])] * 2,
        "self_hit": [(q_self, v), (q_pert, v)],
        "lru_chain": _episode(cfg, 0.0, 2, seed=11, p_valid=1.0),
        "all_pad": [warm[0], pad],
    }


def test_compact_adversarial_conflict_windows_match_jax():
    """Four streams, one adversarial fixture each, through the compact step
    under both decide passes at an overflowing, a partial and the full
    tier: equal to JAX's compact step and to the oracle."""
    cfg = TorrConfig(**SMALL)
    fixtures = _adversarial_windows(cfg)
    eps = list(fixtures.values())
    windows = [_stacked(eps, t) for t in range(2)]
    qd = [np.array([0, cfg.q_hi, 0, cfg.q_hi], np.int32)] * 2
    task_w = np.random.default_rng(1).uniform(0, 1, (4, cfg.M)) \
        .astype(np.float32)
    tels = _run_pair(SMALL, windows, qd, task_w,
                     _compact_lowerings((1, 8, None)))
    paths = np.stack([tl.path.numpy() for tl in tels])
    assert (paths == PATH_FULL).any() and (paths != PATH_FULL).any()


def test_compact_delta_then_full_across_a_bank_switch():
    """Eq. 6 exactness through the compact path: deltas at 8 banks, then a
    queue depth of 1 (below the high-load gate) drops Alg. 1's bank choice
    to 3 under a tight cycle budget, which stales every accumulator tag and
    forces full re-scans through the bucket (the plan switch of
    tests/test_compact_dispatch.py, driven by load)."""
    kw = dict(SMALL, fps_target=300000.0)
    cfg = TorrConfig(**kw)
    rng = np.random.default_rng(7)
    q_bip = bipolar(rng, (1, cfg.N_max, cfg.D))
    valid = (np.arange(cfg.N_max) < cfg.K - 1)[None]
    q0 = pack_np(q_bip)
    q_bip[..., :4] *= -1
    q1 = pack_np(q_bip)
    windows = [(q0, valid), (q1, valid), (q1, valid)]
    qd = [np.array([d], np.int32) for d in (0, 0, 1)]
    task_w = rng.uniform(0, 1, (1, cfg.M)).astype(np.float32)
    tels = _run_pair(kw, windows, qd, task_w,
                     _compact_lowerings((2, None), serial=(False, True)))
    nv = cfg.K - 1
    assert (tels[0].path[0, :nv] == PATH_FULL).all()
    assert (tels[1].path[0, :nv] == PATH_DELTA).all()
    assert (tels[2].path[0, :nv] == PATH_FULL).all()
    assert [int(t.banks[0]) for t in tels] == [8, 8, 3]


@pytest.mark.parametrize("mix", [0.0, 0.5, 0.99])
def test_compact_reuse_mixes_match_jax(mix):
    """tests/test_compact_dispatch.py::test_compact_multi_stream_reuse_mixes
    and tests/test_decide_batched.py::test_multi_stream_decide_modes_\
identical: four streams at a reuse mix, both decide passes, the batched
    and the serial apply, tiers that the mixes over- and underflow."""
    cfg = TorrConfig(**K8)
    from benchmarks.micro_aligner import _mix_trace
    steps = _mix_trace(JCfg(**K8), mix, 4, 3, seed=int(mix * 100),
                       numpy=True)
    windows = [(q, v) for q, v, _b, _qd in steps]
    qd = [qd for *_, qd in steps]
    task_w = np.random.default_rng(1).uniform(0, 1, (4, cfg.M)) \
        .astype(np.float32)
    tier = policy.bucket_tier(4 * cfg.N_max, cfg.N_max)
    _run_pair(K8, windows, qd, task_w,
              _compact_lowerings((tier, 1), serial=(False, True)))


def test_compact_ragged_and_heterogeneous_banks():
    """Ragged M with a small tier (tests/test_compact_dispatch.py::\
test_compact_ragged_fallback_bit_identical) and per-stream bank choices
    8/8/3/1 sharing one bucket (::test_compact_multi_stream_heterogeneous_\
banks)."""
    kw = dict(D=1024, B=8, M=27, K=4, N_max=5, delta_budget=128,
              feat_dim=64, fps_target=40000.0)
    cfg = TorrConfig(**kw)
    rng = np.random.default_rng(5)
    q_bip = bipolar(rng, (4, cfg.N_max, cfg.D))
    valid = np.repeat((np.arange(cfg.N_max) < 4)[None], 4, 0)
    windows = []
    for t in range(3):
        qb = q_bip.copy()
        if t:
            qb[:, :, t::97] *= -1
        windows.append((pack_np(qb), valid))
    qd = [np.array([0, 2, 8, 30], np.int32)] * 3
    task_w = rng.uniform(0, 1, (4, cfg.M)).astype(np.float32)
    tels = _run_pair(kw, windows, qd, task_w, _compact_lowerings((2, 8)))
    assert sorted(set(tels[0].banks.tolist())) == [1, 4, 8]


# --- engines ----------------------------------------------------------------

def _engine_pair(cfg_kw, steps, S, port_kw, jax_kw):
    tcfg, jcfg = TorrConfig(**cfg_kw), JCfg(**cfg_kw)
    codes = bipolar(np.random.default_rng(0), (tcfg.M, tcfg.D))
    im = item_memory.build_item_memory(torch.from_numpy(codes))
    jm = jim.build_item_memory(jnp.asarray(codes))
    task_w = np.random.default_rng(1).uniform(0, 1, (S, tcfg.M)) \
        .astype(np.float32)
    engines = (StreamEngine(tcfg, im, n_slots=S, device="cpu", **port_kw),
               JEngine(jcfg, jm, n_slots=S, **jax_kw))
    for e in engines:
        for s in range(S):
            e.admit(s, task_w[s])
            for q, v, b, _qd in steps:
                e.submit(s, q[s], v[s], b[s])
    got, want = (e.drain() for e in engines)
    for s in range(S):
        for t in range(len(steps)):
            assert_dataclass_same(got[s][t][0], want[s][t][0], (s, t))
            assert_dataclass_same(got[s][t][1], want[s][t][1], (s, t))
    assert_dataclass_same(engines[0].state, engines[1]._state, "final")
    return engines


def _mix_steps(cfg_kw, mix, S, T, seed=0):
    from benchmarks.micro_aligner import _mix_trace
    return _mix_trace(JCfg(**cfg_kw), mix, S, T - 1, seed=seed, numpy=True)


def test_engine_auto_converges_to_compact_on_reuse():
    """tests/test_compact_dispatch.py::test_stream_engine_auto_converges_\
to_compact_on_reuse: the EWMA falls, auto dispatches compact at a small
    tier, and every window, telemetry field included, equals JAX's auto
    engine; the summary carries the same EWMA."""
    kw = dict(SMALL, K=16)
    port, jeng = _engine_pair(kw, _mix_steps(kw, 1.0, 2, 6), 2,
                              dict(fused="auto"), dict(fused="auto"))
    assert port.full_path_ewma < 0.5
    mode, tier, _ = port._resolve_fused()
    assert mode == "compact" and tier < 2 * kw["N_max"]
    assert (mode, tier) == jeng._resolve_fused()[:2]
    assert port.summary()["full_path_ewma"] == \
        jeng.summary()["full_path_ewma"]


def test_engine_auto_stays_hoisted_on_full_traffic():
    kw = dict(SMALL)
    port, _ = _engine_pair(kw, _mix_steps(kw, 0.0, 2, 4), 2,
                           dict(fused="auto"), dict(fused="auto"))
    assert port.full_path_ewma > 0.5
    assert port._resolve_fused()[:2] == (None, None)


def test_engine_compact_and_decide_knobs_match_jax():
    """tests/test_decide_batched.py::test_stream_engine_decide_knob_bit_\
identical: pinned-compact engines under both decide passes, and the
    serial auto engine, equal JAX's engines window by window."""
    kw = dict(SMALL, K=8)
    steps = [(q, v, b, qd) for q, v, b, qd in _mix_steps(kw, 0.9, 2, 4,
                                                          seed=40)]
    for knobs in (dict(fused="compact", bucket_cap=8, decide="scan"),
                  dict(fused="compact", bucket_cap=8),
                  dict(fused="auto", serial=True)):
        _engine_pair(kw, steps, 2, knobs, knobs)
