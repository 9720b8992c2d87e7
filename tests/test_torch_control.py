"""Port parity for the host control plane: ``KnobPlan`` and the ladder,
``plan_level`` and the ``Governor``'s ``plan_log``, the cycle model
(``window_cost``, ``telemetry_cost`` on the port's own telemetry,
``simulate_task``) and the deadline decision table and tracker — each fed
the same inputs as ``repro``'s and held equal to float64 precision (the
same floats, not a tolerance)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import control as jctl
from repro.configs.torr_edge import torr_edge as jtorr_edge
from repro.core import item_memory as jim
from repro.core import pipeline as jpipe
from repro.core.types import TorrConfig as JCfg
from repro.obs.metrics import LATENCY_BUCKETS_S, MetricsRegistry
from repro.obs.slo import SLOMonitor, SLOPolicy
from repro.perf import cycle_model as jcm
from repro.serving import deadline as jdl
from repro_torch import control as ctl
from repro_torch.configs.torr_edge import torr_edge
from repro_torch.core import item_memory, pipeline
from repro_torch.core.types import TorrConfig
from repro_torch.perf import cycle_model as cm
from repro_torch.serving import deadline as dl

from _torch_parity import SMALL, bipolar, pack_np
from test_torch_switch import _t


# --- knob plans and the ladder ----------------------------------------------

def test_knob_plan_and_ladder_match_jax():
    for tcfg, jcfg in ((TorrConfig(**SMALL), JCfg(**SMALL)),
                       (torr_edge(), jtorr_edge())):
        ladder, jladder = ctl.build_ladder(tcfg), jctl.build_ladder(jcfg)
        assert [dataclasses.asdict(p) for p in ladder] == \
            [dataclasses.asdict(p) for p in jladder]
        assert ladder[0] == ctl.full_plan(tcfg) and ladder[0].is_full
        for p, jp in zip(ladder, jladder):
            assert (p.is_full, p.d_eff(tcfg)) == (jp.is_full, jp.d_eff(jcfg))
            t, jt = p.thresholds(tcfg), jp.thresholds(jcfg)
            assert (t.tau_q, t.tau_byp) == (jt.tau_q, jt.tau_byp)
            assert (t is tcfg) == (jt is jcfg)
            p.validate(tcfg)
        assert np.array_equal(ctl.ladder_rel_cost(ladder, tcfg),
                              jctl.ladder_rel_cost(jladder, jcfg))
    # the edge ladder: precision first, then banks with tau offsets
    edge = ctl.build_ladder(torr_edge())
    assert [(p.banks, p.planes) for p in edge] == [
        (8, 4), (8, 3), (8, 2), (8, 1), (4, 1), (2, 1), (1, 1)]
    assert [(p.tau_q_off, p.tau_byp_off) for p in edge[4:]] == \
        [(-0.05, -0.03)] * 3
    assert len({*edge}) == len(edge)          # frozen and hashable
    with pytest.raises(dataclasses.FrozenInstanceError):
        edge[0].banks = 2
    bad = [dict(banks=8, planes=0, plane_total=4),
           dict(banks=8, planes=5, plane_total=4),
           dict(banks=0, planes=1, plane_total=4),
           dict(banks=8, planes=1, plane_total=4, bucket_cap=0)]
    for kw in bad:
        for cls in (ctl.KnobPlan, jctl.KnobPlan):
            with pytest.raises(ValueError):
                cls(**kw)
    cfg = torr_edge()
    for kw in (dict(banks=8, planes=1, plane_total=8),
               dict(banks=9, planes=1, plane_total=4)):
        with pytest.raises(ValueError):
            ctl.KnobPlan(**kw).validate(cfg)
        with pytest.raises(ValueError):
            jctl.KnobPlan(**kw).validate(jtorr_edge())


def _pol_pair(**kw):
    return ctl.GovernorPolicy(**kw), jctl.GovernorPolicy(**kw)


def test_plan_level_matches_jax():
    """The pure level selection over a grid of slack, backlog, step,
    level, recovery count, energy and measurement cost."""
    rng = np.random.default_rng(0)
    rel = ctl.ladder_rel_cost(ctl.build_ladder(torr_edge()), torr_edge())
    n = 0
    for pkw in (dict(budget_s=1 / 60), dict(budget_s=1 / 30, recover_hold=2,
                                            energy_budget_mj=55.0)):
        pol, jpol = _pol_pair(**pkw)
        for _ in range(400):
            args = (float(rng.uniform(-0.02, 0.04)), int(rng.integers(0, 6)),
                    float(rng.choice([0.0, rng.uniform(1e-4, 0.05)])),
                    int(rng.integers(0, len(rel))), int(rng.integers(0, 4)))
            e = float(rng.choice([0.0, rng.uniform(40, 120)]))
            meas = float(rng.choice([rel[0], rng.uniform(0.1, 1.0)]))
            got = ctl.plan_level(*args, rel, pol, e, rel_meas=meas)
            assert got == jctl.plan_level(*args, rel, jpol, e, rel_meas=meas)
            n += got[0] != args[3]
    assert n > 50                                  # the level does move


class _Alerts:
    """A stand-in SLO monitor whose alert level follows a script."""

    def __init__(self, levels):
        self._levels = iter(levels)
        self.alert_level = 0

    def tick(self):
        self.alert_level = next(self._levels)


@pytest.mark.parametrize("pkw", [dict(), dict(recover_hold=2),
                                 dict(energy_budget_mj=50.0,
                                      slack_margin=0.1)])
def test_governor_plan_log_matches_jax(pkw):
    """One (slack, step, backlog, energy) sequence through both governors,
    with metrics and an SLO hook: the same plan_log, levels, switches,
    energy EWMA, measurement blend, summary and exported metrics."""
    cfg, jcfg = torr_edge(), jtorr_edge()
    pol, jpol = _pol_pair(**dict(dict(budget_s=1 / 60), **pkw))
    rng = np.random.default_rng(len(pkw))
    alerts = [int(a) for a in rng.choice([0, 0, 0, 1, 2], 200)]
    slo, jslo = _Alerts(alerts), _Alerts(alerts)
    reg, jreg = MetricsRegistry(), MetricsRegistry()
    gov = ctl.Governor(cfg, pol, metrics=reg, slo=slo)
    jgov = jctl.Governor(jcfg, jpol, metrics=jreg, slo=jslo)
    for t in range(200):
        slack = float(rng.uniform(-0.01, 0.03))
        step = 0.0 if t == 0 else float(rng.uniform(1e-3, 0.03))
        backlog = int(rng.integers(0, 4))
        energies = rng.uniform(45, 90, 2) if t % 2 else ()
        for g, s in ((gov, slo), (jgov, jslo)):
            if t % 3 == 0:
                s.tick()
            g.update(slack, step, backlog=backlog, n_windows=4)
            for mj in energies:
                g.observe_energy(float(mj))
        assert dataclasses.asdict(gov.plan) == dataclasses.asdict(jgov.plan)
    assert gov.plan_log == jgov.plan_log
    assert len({lvl for *_bp, lvl in gov.plan_log}) > 2
    assert (gov.switches, gov.windows_by_level, gov._rel_meas) == \
        (jgov.switches, jgov.windows_by_level, jgov._rel_meas)
    assert gov.energy_ewma_mj == jgov.energy_ewma_mj
    assert gov.summary() == jgov.summary()
    assert reg.snapshot() == jreg.snapshot()


def test_governor_policies_match_jax(monkeypatch):
    assert ctl.policy_for("RT-30", recover_hold=7) == \
        ctl.GovernorPolicy(**dataclasses.asdict(
            jctl.policy_for("RT-30", recover_hold=7)))
    for env in ({}, {"TORR_GOV_MARGIN": "0.4", "TORR_GOV_HOLD": "2",
                     "TORR_GOV_ENERGY_MJ": "55", "TORR_GOV_ALPHA": "0.5"},
                {"TORR_GOV_ENERGY_MJ": "0"}):
        for k in ("TORR_GOV_MARGIN", "TORR_GOV_HOLD", "TORR_GOV_ENERGY_MJ",
                  "TORR_GOV_ALPHA"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert dataclasses.asdict(ctl.policy_from_env("RT-60")) == \
            dataclasses.asdict(jctl.policy_from_env("RT-60"))


# --- the cycle model ----------------------------------------------------------

def _cost_same(a, b):
    assert (a.cycles, a.total_cycles, a.energy_j, a.power_w) == \
        (b.cycles, b.total_cycles, b.energy_j, b.power_w)


def test_cycle_model_helpers_match_jax():
    cfg, jcfg = torr_edge(), jtorr_edge()
    assert (cm.P_STATIC, cm.DMA_BITS_PER_CYCLE, cm.POWER_W, cm.AREA) == \
        (jcm.P_STATIC, jcm.DMA_BITS_PER_CYCLE, jcm.POWER_W, jcm.AREA)
    rng = np.random.default_rng(1)
    lat = rng.uniform(0.005, 0.03, 50)
    for x in (lat, lat[:0]):
        assert cm.latency_summary(x, 1 / 60) == jcm.latency_summary(x, 1 / 60)
    for fused in ("off", "switch", "prefix", "compact"):
        for n_full, n_valid, cap in ((0, 0, None), (3, 9, None),
                                     (9, 9, 4), (2, 128, 8)):
            assert cm.lowering_scan_rows(n_full, n_valid, fused, cap) == \
                jcm.lowering_scan_rows(n_full, n_valid, fused, cap)
    for decide in ("scan", "batched"):
        assert cm.decide_psu_cycles(77, 2048, decide) == \
            jcm.decide_psu_cycles(77, 2048, decide)
    for _ in range(20):
        n = int(rng.integers(1, cfg.N_max + 1))
        path = rng.integers(0, 3, cfg.N_max)
        dc = rng.integers(0, cfg.delta_budget, cfg.N_max)
        ra = rng.random(cfg.N_max) < 0.5
        banks = int(rng.integers(1, cfg.B + 1))
        kw = dict(window_scale=float(rng.choice([1.0, 2.0])),
                  d_eff=int(rng.choice([banks * 1024, banks * 256])),
                  fused=str(rng.choice(["switch", "prefix", "compact"])),
                  bucket_cap=None, decide=str(rng.choice(["scan",
                                                          "batched"])))
        _cost_same(cm.window_cost(path, dc, banks, ra, n, cfg, 1 / 60, **kw),
                   jcm.window_cost(path, dc, banks, ra, n, jcfg, 1 / 60,
                                   **kw))
        rho = rng.uniform(-1, 1, n)
        delta = rng.integers(0, 4096, n)
        for high in (False, True):
            assert np.array_equal(cm.path_mix(rho, delta, high, cfg),
                                  jcm.path_mix(rho, delta, high, jcfg))


def test_telemetry_cost_on_port_telemetry_matches_jax():
    """One window under a reduced plan in both packages (compact: the
    recorded lowering is priced too); the port's telemetry, as tensors or
    as numpy, costs what JAX's does, window by window of a stacked step."""
    tcfg, jcfg = TorrConfig(**SMALL), JCfg(**SMALL)
    rng = np.random.default_rng(3)
    codes = bipolar(rng, (tcfg.M, tcfg.D))
    im = item_memory.build_item_memory(torch.from_numpy(codes))
    jm = jim.build_item_memory(jnp.asarray(codes))
    S = 2
    task_w = rng.uniform(0, 1, (S, tcfg.M)).astype(np.float32)
    plan, jplan = (cls(banks=4, planes=2, plane_total=4)
                   for cls in (ctl.KnobPlan, jctl.KnobPlan))
    q = pack_np(bipolar(rng, (S, tcfg.N_max, tcfg.D)))
    valid = rng.random((S, tcfg.N_max)) < 0.7
    boxes = np.zeros((S, tcfg.N_max, 4), np.float32)
    qd = np.array([0, 5], np.int32)
    _, _, tel = pipeline.torr_multi_stream_step(
        pipeline.init_multi_stream_state(tcfg, task_w, device="cpu"), im,
        _t(q), valid, boxes, qd, tcfg, plan=plan, fused="compact",
        bucket_cap=4)
    jstep = jax.jit(jpipe.torr_multi_stream_step,
                    static_argnames=("cfg", "plan", "fused", "bucket_cap"))
    _, _, jtel = jstep(
        jpipe.init_multi_stream_state(jcfg, jnp.asarray(task_w)), jm,
        jnp.asarray(q), jnp.asarray(valid), jnp.asarray(boxes),
        jnp.asarray(qd), jcfg, plan=jplan, fused="compact", bucket_cap=4)
    for s in range(S):
        tw = type(tel)(**{f.name: getattr(tel, f.name)[s]
                          for f in dataclasses.fields(tel)})
        jw = type(jtel)(**{f.name: getattr(jtel, f.name)[s]
                           for f in dataclasses.fields(jtel)})
        tw_np = type(tel)(**{f.name: getattr(tw, f.name).numpy()
                             for f in dataclasses.fields(tw)})
        for kw in (dict(), dict(window_scale=2.0, use_recorded_lowering=True)):
            want = jcm.telemetry_cost(jw, jcfg, 1 / 60, **kw)
            _cost_same(cm.telemetry_cost(tw, tcfg, 1 / 60, **kw), want)
            _cost_same(cm.telemetry_cost(tw_np, tcfg, 1 / 60, **kw), want)


@pytest.mark.parametrize("rt", ["RT-60", "RT-30"])
def test_simulate_task_matches_jax(rt):
    for task in cm.TASK_PROFILES:
        assert cm.simulate_task(task, rt, n_frames=40, seed=3) == \
            jcm.simulate_task(task, rt, n_frames=40, seed=3)
    assert cm.simulate_all(rt, n_frames=10) == jcm.simulate_all(rt,
                                                                n_frames=10)


# --- deadlines -------------------------------------------------------------------

def test_deadline_decision_table_matches_jax():
    assert dl.LATENCY_BUCKETS_S == LATENCY_BUCKETS_S
    for rt in ("RT-60", "RT-30"):
        assert dataclasses.asdict(dl.policy_for(rt)) == \
            dataclasses.asdict(jdl.policy_for(rt))
    pols = [(dl.policy_for(rt, **kw), jdl.policy_for(rt, **kw))
            for rt in ("RT-60", "RT-30")
            for kw in (dict(), dict(allow_shed=False),
                       dict(escalate_margin_s=0.0))]
    grid = np.linspace(0.0, 0.06, 25)
    decisions = set()
    for pol, jpol in pols:
        for wait in grid:
            for step in grid[::3]:
                for backlog in (0, 1, 3, 9):
                    d = dl.decide(wait, backlog, step, pol)
                    assert int(d) == int(jdl.decide(wait, backlog, step,
                                                    jpol))
                    assert d.name == jdl.Decision(int(d)).name
                    decisions.add(d)
                    assert dl.retry_after_s(backlog, step, pol) == \
                        jdl.retry_after_s(backlog, step, jpol)
    assert decisions == set(dl.Decision)
    for args in ((3, 0.0123, "deadline", None), (3, 0.004, "rt", 0.05)):
        assert str(dl.WindowShed(*args)) == str(jdl.WindowShed(*args))


def test_deadline_tracker_matches_jax():
    """Both trackers on the same injected clock and call sequence, with
    metrics and an SLO monitor wired: the same decisions, latencies,
    counters, summary and exported metrics."""
    rng = np.random.default_rng(5)
    times = np.cumsum(rng.uniform(0.0, 0.02, 400)).tolist()
    reg, jreg = MetricsRegistry(), MetricsRegistry()
    slo, jslo = (SLOMonitor(SLOPolicy(), metrics=r) for r in (reg, jreg))
    pol, jpol = dl.policy_for("RT-60"), jdl.policy_for("RT-60")
    tr = dl.DeadlineTracker(pol, clock=iter(times).__next__, metrics=reg,
                            slo=slo)
    jtr = jdl.DeadlineTracker(jpol, clock=iter(times).__next__,
                              metrics=jreg, slo=jslo)
    arrivals = []
    for i in range(100):
        dur = float(rng.uniform(0.002, 0.03))
        for t in (tr, jtr):
            t.observe_step(dur)
        arrivals.append(times[4 * i] - float(rng.uniform(0, 0.02)))
        backlog = int(rng.integers(0, 4))
        assert int(tr.decide_head(arrivals[-1], backlog)) == \
            int(jtr.decide_head(arrivals[-1], backlog))
        assert tr.lateness(arrivals[-1]) == jtr.lateness(arrivals[-1])
        assert tr.retry_after_hint(backlog) == jtr.retry_after_hint(backlog)
        assert tr.complete(arrivals[-1]) == jtr.complete(arrivals[-1])
        assert tr.step_ema_s == jtr.step_ema_s
    assert tr.summary() == jtr.summary()
    assert tr.shed > 0 and tr.escalated > 0 and tr.missed > 0
    assert reg.snapshot() == jreg.snapshot()
