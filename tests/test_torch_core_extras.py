"""Port parity: the functions of ported modules that the serving path does not
call (the no-reuse config, the bipolar and packed cosines, the trained item
memory, ``full_scores``, the int8 tensor-core dot, ``policy.decide``, the
reasoner's precomputed and online weights, ``StreamBatch.n_streams``), each
held bit-equal to ``repro``'s on the same numpy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.torr_edge import torr_edge_no_reuse as jno_reuse
from repro.core import aligner as jaligner
from repro.core import hdc as jhdc
from repro.core import item_memory as jim
from repro.core import policy as jpolicy
from repro.core import reasoner as jreasoner
from repro.core.types import StreamBatch as JBatch
from repro.core.types import TorrConfig as JCfg
from repro_torch.configs.torr_edge import torr_edge_no_reuse
from repro_torch.core import aligner, hdc, item_memory, policy, reasoner
from repro_torch.core.types import StreamBatch, TorrConfig

from _torch_parity import (SMALL, assert_dataclass_same, assert_same,
                           bipolar, pack_np)

TCFG, JCFG = TorrConfig(**SMALL), JCfg(**SMALL)


@pytest.mark.parametrize("rt", ["RT-60", "RT-30"])
def test_torr_edge_no_reuse_matches_jax(rt):
    got = dataclasses.asdict(torr_edge_no_reuse(rt))
    assert got == dataclasses.asdict(jno_reuse(rt))
    assert got["tau_byp"] > 1.0 and got["tau_q"] > 1.0


@pytest.mark.parametrize("shape", [(64,), (3, 1024), (2, 4, 256)])
def test_bipolar_and_packed_cosines_match_jax(shape):
    rng = np.random.default_rng(0)
    a, b = bipolar(rng, shape), bipolar(rng, shape)
    b[..., : shape[-1] // 2] = a[..., : shape[-1] // 2]   # not orthogonal
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert_same(hdc.dot_bipolar(ta, tb), jhdc.dot_bipolar(ja, jb))
    assert_same(hdc.cosine_bipolar(ta, tb), jhdc.cosine_bipolar(ja, jb))
    pa, pb = pack_np(a), pack_np(b)
    tpa, tpb = (torch.from_numpy(pa.view(np.int32)),
                torch.from_numpy(pb.view(np.int32)))
    for d_eff in (None, 32, 32 * pa.shape[-1]):
        assert_same(hdc.cosine_packed(tpa, tpb, d_eff),
                    jhdc.cosine_packed(jnp.asarray(pa), jnp.asarray(pb),
                                       d_eff), d_eff)


@pytest.mark.parametrize("keyed", [False, True])
def test_item_memory_from_prototypes_matches_jax(keyed):
    """Integer features and a +-1 projection keep every projected sum exact
    (and some at 0: sign(0) is +1 in both), and an even example count
    leaves zero-sum dimensions for the keyed bundle's tie-break bits, which
    the JAX package draws and both packages receive."""
    rng = np.random.default_rng(3)
    M, n, d = TCFG.M, 4, 16
    feats = rng.integers(-2, 3, (M, n, d)).astype(np.float32)
    R = bipolar(rng, (TCFG.D, d)).astype(np.float32)
    key = jax.random.PRNGKey(7) if keyed else None
    want = jim.item_memory_from_prototypes(jnp.asarray(feats), jnp.asarray(R),
                                           key, plane_total=TCFG.bit_planes)
    tie = None
    if keyed:
        tie = np.array(jax.vmap(
            lambda k: jhdc.random_hv(k, (TCFG.D,), dtype=jnp.int32))(
                jax.random.split(key, M)))
        tie = torch.from_numpy(tie)
    got = item_memory.item_memory_from_prototypes(
        torch.from_numpy(feats), torch.from_numpy(R), tie,
        plane_total=TCFG.bit_planes)
    assert_dataclass_same(got, want, "im")
    hv = np.where(feats @ R.T >= 0, 1, -1).sum(1)
    assert (hv == 0).any()           # the tie-break bits are exercised


@pytest.mark.parametrize("banks", [1, 3, 8])
def test_full_scores_matches_jax(banks):
    rng = np.random.default_rng(4)
    codes = bipolar(rng, (TCFG.M, TCFG.D))
    im = item_memory.build_item_memory(torch.from_numpy(codes))
    jm = jim.build_item_memory(jnp.asarray(codes))
    q = pack_np(bipolar(rng, (TCFG.D,)))
    acc, cos = aligner.full_scores(torch.from_numpy(q.view(np.int32)), im,
                                   TCFG, banks)
    jacc, jcos = jaligner.full_scores(jnp.asarray(q), jm, JCFG, banks)
    assert_same(acc, jacc, "acc")
    assert_same(cos, jcos, "cos")


@pytest.mark.parametrize("M", [32, 20])
@pytest.mark.parametrize("lead", [(), (3,), (2, 20)])
def test_full_dot_mxu_matches_jax_and_popcount(lead, M):
    """Exact integer dots at every bank mask, on row counts below and above
    ``_int_mm``'s 16 and a class count that is not a multiple of 8."""
    cfg = dataclasses.replace(TCFG, M=M)
    rng = np.random.default_rng(5)
    codes = bipolar(rng, (M, cfg.D))
    im = item_memory.build_item_memory(torch.from_numpy(codes))
    jm = jim.build_item_memory(jnp.asarray(codes))
    q = bipolar(rng, lead + (cfg.D,))
    for banks in (2, 8):
        dm = item_memory.dim_mask(cfg, banks)
        got = aligner.full_dot_mxu(torch.from_numpy(q), im, dm)
        want = jaligner.full_dot_mxu(jnp.asarray(q), jm,
                                     jim.dim_mask(JCFG, banks))
        assert got.dtype == torch.int32
        assert_same(got, want, banks)
        wm = item_memory.word_mask(cfg, banks)
        qp = torch.from_numpy(pack_np(q).view(np.int32))
        assert_same(got, aligner.full_dot(qp, im, wm), banks)


def test_policy_decide_matches_jax():
    rng = np.random.default_rng(6)
    n = 64
    rho = rng.uniform(0.4, 1.0, n).astype(np.float32)
    rho[:4] = (TCFG.tau_byp, TCFG.tau_q, np.nextafter(TCFG.tau_q, 0), 1.0)
    dc = rng.integers(0, 2 * TCFG.delta_budget, n).astype(np.int32)
    ok = rng.random(n) < 0.7
    n_obj = rng.integers(0, 2 * TCFG.N_hi, n).astype(np.int32)
    qd = rng.integers(0, 2 * TCFG.q_hi, n).astype(np.int32)
    args = (rho, dc, ok, n_obj, qd)
    action, banks = policy.decide(*map(torch.from_numpy, args), TCFG)
    # repro decides one proposal at a time; the port takes any batch
    jaction, jbanks = jax.vmap(lambda *a: jpolicy.decide(*a, JCFG))(
        *map(jnp.asarray, args))
    assert_same(action, jaction, "action")
    assert_same(banks, jbanks, "banks")
    assert len(np.unique(action.numpy())) == 3


def test_precomputed_and_online_weights_match_jax():
    """``repro``'s own check (online == precomputed at full D) and both
    bit-equal to ``repro``'s at every bank count, on the same graph."""
    cfg, jcfg = (dataclasses.replace(c, n_relations=8) for c in (TCFG, JCFG))
    rng = np.random.default_rng(7)
    rel, text = bipolar(rng, (8, cfg.D)), bipolar(rng, (3, cfg.D))
    codes = bipolar(rng, (cfg.M, cfg.D))
    g = reasoner.TaskGraph(torch.from_numpy(rel), torch.from_numpy(text))
    jg = jreasoner.TaskGraph(jnp.asarray(rel), jnp.asarray(text))
    im = item_memory.build_item_memory(torch.from_numpy(codes))
    jm = jim.build_item_memory(jnp.asarray(codes))
    paths = np.array([[1, -1, -1], [0, 2, -1], [3, 4, 5]], np.int32)
    pre = reasoner.precompute_weights(g, im, cfg, paths)
    assert_same(pre, jreasoner.precompute_weights(jg, jm, jcfg,
                                                  jnp.asarray(paths)))
    for t in range(3):
        for banks in (1, 5, cfg.B):
            got = reasoner.online_weights(g, im, cfg, t, paths[t], banks)
            assert_same(got, jreasoner.online_weights(
                jg, jm, jcfg, jnp.int32(t), jnp.asarray(paths[t]), banks),
                (t, banks))
        assert_same(reasoner.online_weights(g, im, cfg, t, paths[t], cfg.B),
                    pre[t])


@pytest.mark.parametrize("S", [1, 5])
def test_stream_batch_n_streams_matches_jax(S):
    q = np.zeros((S, TCFG.N_max, TCFG.words), np.uint32)
    v = np.zeros((S, TCFG.N_max), bool)
    b = np.zeros((S, TCFG.N_max, 4), np.float32)
    qd = np.zeros((S,), np.int32)
    got = StreamBatch(*(torch.from_numpy(x.view(np.int32) if x is q else x)
                        for x in (q, v, b, qd)))
    assert got.n_streams == JBatch(*map(jnp.asarray, (q, v, b, qd))).n_streams
    assert got.n_streams == S
