"""Port parity: the single-window step (``fused="off"``, the port's oracle,
and ``"prefix"``, the bank-prefix kernel path) against ``repro``'s on the
scenarios of ``tests/test_pipeline.py``, the Alg. 1 policy, and the tie
orders the port must keep (first maximum / lowest index)."""
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
from repro.core import reasoner as jreasoner
from repro.core.types import TorrConfig as JCfg
from repro_torch import convert
from repro_torch.core import item_memory, pipeline, policy, query_cache
from repro_torch.core import reasoner
from repro_torch.core.types import (PATH_BYPASS, PATH_DELTA, PATH_FULL,
                                    TorrConfig)

from _torch_parity import (SMALL, assert_dataclass_same, assert_same,
                           bipolar, pack_np)

# the issue's small config, and tests/test_pipeline.py's (whose N_max <= K
# keeps a cold window from thrashing its own cache)
CONFIGS = {
    "small": dict(SMALL),
    "pipeline": dict(D=2048, B=8, M=32, K=6, N_max=4, delta_budget=512,
                     feat_dim=64),
}


@functools.lru_cache(maxsize=None)
def _jax_step(fused):
    return jax.jit(functools.partial(jpipe.torr_window_step, fused=fused),
                   static_argnames="cfg")


def _setup(kw):
    tcfg, jcfg = TorrConfig(**kw), JCfg(**kw)
    rng = np.random.default_rng(0)
    codes = bipolar(rng, (tcfg.M, tcfg.D))
    task_w = rng.uniform(-1, 1, tcfg.M).astype(np.float32)
    qs = bipolar(rng, (tcfg.N_max, tcfg.D))
    return (tcfg, jcfg, item_memory.build_item_memory(torch.from_numpy(codes)),
            jim.build_item_memory(jnp.asarray(codes)), task_w, qs, rng)


def _scenario(name, cfg, qs, rng):
    """[(bipolar queries, queue depth, valid)] windows of one scenario."""
    ones = np.ones(cfg.N_max, bool)
    drift = qs.copy()
    drift[:, ::97] *= -1
    if name == "cold_delta_bypass":
        return [(qs, 0, ones), (drift, 0, ones), (drift, cfg.q_hi, ones)]
    if name == "scene_cut":
        return [(qs, 0, ones), (bipolar(rng, qs.shape), 0, ones)]
    if name == "exact_delta":
        d2 = qs.copy()
        d2[:, 5::61] *= -1
        return [(qs, 0, ones), (d2, 0, ones)]
    if name == "padding":
        half = np.arange(cfg.N_max) < cfg.N_max // 2
        return [(qs, 0, half), (drift, 1, half), (drift, cfg.q_hi, ~half)]
    if name == "budget_overflow":
        over = qs.copy()
        over[:, :cfg.delta_budget + 64] *= -1
        return [(qs, 0, ones), (over, 0, ones), (over, 2, ones)]
    raise KeyError(name)


SCENARIOS = ("cold_delta_bypass", "scene_cut", "exact_delta", "padding",
             "budget_overflow")


@pytest.mark.parametrize("fused", ["off", "prefix"])
@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_window_step_matches_jax(cfg_name, scenario, fused):
    tcfg, jcfg, im, jm, task_w, qs, rng = _setup(CONFIGS[cfg_name])
    tstate = pipeline.init_state(tcfg, task_w)
    jstate = jpipe.init_state(jcfg, jnp.asarray(task_w))
    jstep = _jax_step(fused)
    paths = []
    for t, (q_bip, qd, valid) in enumerate(_scenario(scenario, tcfg, qs,
                                                     rng)):
        q = pack_np(q_bip)
        boxes = rng.random((tcfg.N_max, 4)).astype(np.float32)
        tstate, tout, ttel = pipeline.torr_window_step(
            tstate, im, torch.from_numpy(q.view(np.int32)), valid, boxes,
            qd, tcfg, fused=fused)
        jstate, jout, jtel = jstep(jstate, jm, jnp.asarray(q),
                                   jnp.asarray(valid), jnp.asarray(boxes),
                                   jnp.int32(qd), jcfg)
        assert_dataclass_same(tout, jout, f"out[{t}]")
        assert_dataclass_same(ttel, jtel, f"tel[{t}]")
        assert_dataclass_same(tstate, jstate, f"state[{t}]")
        paths.append(ttel.path.numpy())
    if cfg_name == "pipeline":      # the scenario really ran its paths
        if scenario == "cold_delta_bypass":
            assert [set(p) for p in paths] == [{PATH_FULL}, {PATH_DELTA},
                                               {PATH_BYPASS}]
        if scenario in ("scene_cut", "budget_overflow"):
            assert set(paths[1]) == {PATH_FULL}
        if scenario == "exact_delta":
            assert set(paths[1]) == {PATH_DELTA}


def test_window_step_state_round_trips_through_convert():
    """A JAX state mid-stream carried over by ``convert`` continues
    bit-identically in the port."""
    tcfg, jcfg, im, jm, task_w, qs, rng = _setup(CONFIGS["pipeline"])
    jstate = jpipe.init_state(jcfg, jnp.asarray(task_w))
    jstep = _jax_step("prefix")
    zeros = np.zeros((tcfg.N_max, 4), np.float32)
    ones = np.ones(tcfg.N_max, bool)
    jstate, _, _ = jstep(jstate, jm, jnp.asarray(pack_np(qs)),
                         jnp.asarray(ones), jnp.asarray(zeros), jnp.int32(0),
                         jcfg)
    leaves = {k: np.asarray(getattr(jstate.cache, k))
              for k in convert.CACHE_FIELDS}
    tstate = convert.torr_state_from_numpy(leaves,
                                           np.asarray(jstate.task_weights))
    back = convert.to_numpy(tstate)
    for k in convert.CACHE_FIELDS:
        assert_same(back["cache"][k], leaves[k], k)
    q2 = qs.copy()
    q2[:, ::50] *= -1
    q2p = pack_np(q2)
    tstate, tout, ttel = pipeline.torr_window_step(
        tstate, im, torch.from_numpy(q2p.view(np.int32)), ones, zeros, 0,
        tcfg, fused="prefix")
    jstate, jout, jtel = jstep(jstate, jm, jnp.asarray(q2p),
                               jnp.asarray(ones), jnp.asarray(zeros),
                               jnp.int32(0), jcfg)
    assert_dataclass_same(tout, jout)
    assert_dataclass_same(ttel, jtel)
    assert_dataclass_same(tstate, jstate)


def test_policy_truth_table_and_bank_selection_match_jax():
    for kw in (CONFIGS["pipeline"], dict(D=8192, B=8, M=1024, K=8, N_max=128,
                                         delta_budget=2048)):
        tcfg, jcfg = TorrConfig(**kw), JCfg(**kw)
        rho = np.array([0.99, 0.95, 0.9499999, 0.7, 0.6, 0.5999999, 0.1,
                        -np.inf], np.float32)
        count = np.array([10, tcfg.delta_budget, tcfg.delta_budget + 1])
        R, C, T, H = np.meshgrid(np.arange(len(rho)), count, [True, False],
                                 [True, False], indexing="ij")
        args = (rho[R.ravel()], C.ravel().astype(np.int32), T.ravel(),
                H.ravel())
        got = policy.select_path(*(torch.from_numpy(np.asarray(a))
                                   for a in args), tcfg)
        want = jpolicy.select_path(*(jnp.asarray(a) for a in args), jcfg)
        assert_same(got, want)
        n = np.repeat(np.arange(0, tcfg.N_max + 2), 12).astype(np.int32)
        qd = np.tile(np.arange(12), tcfg.N_max + 2).astype(np.int32)
        tn, tq = torch.from_numpy(n), torch.from_numpy(qd)
        assert_same(policy.high_load(tn, tq, tcfg),
                    jpolicy.high_load(jnp.asarray(n), jnp.asarray(qd), jcfg))
        want_b = jax.vmap(lambda a, b: jpolicy.select_banks(a, b, jcfg))(
            jnp.asarray(n), jnp.asarray(qd))
        assert_same(policy.select_banks(tn, tq, tcfg), want_b)
        for b in (1, 4, 8):
            assert policy.window_cycles(3, 2, b, tcfg) == \
                int(jpolicy.window_cycles(3, 2, b, jcfg))
    # tests/test_pipeline.py's truth table, on the port alone
    cfg = TorrConfig(**CONFIGS["pipeline"])
    t, f = torch.tensor(True), torch.tensor(False)

    def path(r, hi, ok=t):
        return int(policy.select_path(torch.tensor(r, dtype=torch.float32),
                                      torch.tensor(10), ok, hi, cfg))

    assert path(0.99, t) == PATH_BYPASS
    assert path(0.99, f) == PATH_DELTA
    assert path(0.7, t) == PATH_DELTA
    assert path(0.1, t) == PATH_FULL
    assert path(0.7, f, ok=f) == PATH_FULL


def test_tie_orders_match_jax():
    """Equal values resolve to the lowest index in top-k keys, the cache's
    nearest match and LRU slot, and the window's argmax — as in ``repro``."""
    kw = CONFIGS["pipeline"]
    tcfg, jcfg = TorrConfig(**kw), JCfg(**kw)
    # top-k with a tied block straddling the k boundary, and all-equal rows
    s = np.zeros((3, tcfg.M), np.float32)
    s[0, [3, 9, 17, 20, 25, 30]] = 0.5
    s[1, [2, 5]] = 0.75
    s[1, [1, 8, 11, 29]] = 0.25
    ts = torch.from_numpy(s)
    for r in range(3):
        k, m = reasoner.topk_key_margin(ts[r], tcfg)
        jk, jmg = jreasoner.topk_key_margin(jnp.asarray(s[r]), jcfg)
        assert_same(k, jk)
        assert_same(m, jmg)
    # argmax over rows holding +0.0 / -0.0 ties (the window's `best`)
    z = np.array([[-0.0, 0.0, -1.0], [0.0, -0.0, -0.0], [-2.0, -0.0, 0.0]],
                 np.float32)
    assert_same(torch.argmax(torch.from_numpy(z), dim=-1).to(torch.int32),
                jnp.argmax(jnp.asarray(z), axis=-1).astype(jnp.int32))
    # nearest: two valid entries at the same distance; LRU: equal ages
    rng = np.random.default_rng(9)
    q = bipolar(rng, (tcfg.D,))
    e = np.stack([q] * tcfg.K)
    e[1, :7] *= -1
    e[3, 100:107] *= -1               # same distance as entry 1
    e[0] = bipolar(rng, (tcfg.D,))
    packed = pack_np(e)
    valid = np.array([True, True, False, True, True, True])
    age = np.array([5, 2, 0, 2, 7, 7], np.int32)
    jc = jqc.init_cache(jcfg)
    jc = jqc.CacheState(jnp.asarray(packed), jc.acc, jc.acc_tag, jc.out,
                        jc.topk_key, jc.margin, jnp.asarray(age),
                        jnp.asarray(valid))
    tc = convert.cache_state_from_numpy(
        packed, np.asarray(jc.acc), np.asarray(jc.acc_tag),
        np.asarray(jc.out), np.asarray(jc.topk_key), np.asarray(jc.margin),
        age, valid)
    for banks in (1, 4, 8):
        got = query_cache.nearest(tc, torch.from_numpy(pack_np(q)
                                                       .view(np.int32)),
                                  tcfg, banks)
        want = jqc.nearest(jc, jnp.asarray(pack_np(q)), jcfg, banks)
        for g, w in zip(got, want):
            assert_same(g, w, banks)
    assert_same(query_cache.lru_slot(tc), jqc.lru_slot(jc))
    tc.valid[:] = True
    jc = jqc.CacheState(*(list(jax.tree_util.tree_leaves(jc))[:7]),
                        jnp.ones(tcfg.K, bool))
    assert_same(query_cache.lru_slot(tc), jqc.lru_slot(jc))
