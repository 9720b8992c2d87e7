"""Port parity for every level of the knob-plan ladder on every lowering of
the multi-stream step (the plan grid of ``tests/test_control.py``, run
through ``tests/test_compact_dispatch.py``'s and
``tests/test_decide_batched.py``'s compact lowerings too): each equal to
``repro``'s step on the same lowering and plan, window by window, in every
output, telemetry field and cache leaf."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.control import build_ladder as jbuild_ladder
from repro.core import pipeline as jpipe
from repro.core.types import TorrConfig as JCfg
from repro_torch.control import build_ladder
from repro_torch.core import pipeline
from repro_torch.core.types import TorrConfig

from _torch_parity import SMALL, assert_dataclass_same
from test_torch_engine import _make_inputs
from test_torch_plan import TCFG, _jstep, _memories, _task_w
from test_torch_switch import _t


# --- the plan grid over every lowering of the multi-stream step -------------

def _low_name(low):
    return ",".join(f"{k}={v}" for k, v in low.items())


LOWERINGS = [dict(fused="prefix"), dict(fused="off"), dict(serial=True),
             dict(fused="switch"), dict(fused="compact"),
             dict(fused="compact", decide="scan", bucket_cap=4),
             dict(fused="compact", serial=True, bucket_cap=8)]


@pytest.mark.parametrize("level", range(len(build_ladder(TCFG))))
def test_ladder_level_on_every_lowering_matches_jax(level):
    """Each level of the ladder (full plan to (1, 1) with tau offsets) on
    every lowering of the multi-stream step — prefix, oracle, serial
    switch, batched switch, compact (batched and scan decide, serial
    apply, overflowing tiers) — over 4 streams whose load gives Alg. 1
    banks 8/8/3/1 before the plan's cap: equal to JAX's step on the same
    lowering, window by window, in every field."""
    kw = dict(SMALL, fps_target=40000.0)
    tcfg, jcfg = TorrConfig(**kw), JCfg(**kw)
    plan, jplan = build_ladder(tcfg)[level], jbuild_ladder(jcfg)[level]
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    im, jm = _memories(tuple(sorted(kw.items())))
    S = 4
    task_w = _task_w(S=S)
    steps = _make_inputs(tcfg, S, T=3, seed=level)
    qd = np.array([0, 2, 8, 30], np.int32)
    for low in LOWERINGS:
        tst = pipeline.init_multi_stream_state(tcfg, task_w, device="cpu")
        jst = jpipe.init_multi_stream_state(jcfg, jnp.asarray(task_w))
        for t, (q, v, b, _qd) in enumerate(steps):
            tst, tout, ttel = pipeline.torr_multi_stream_step(
                tst, im, _t(q), v, b, qd, tcfg, plan=plan, **low)
            jst, jout, jtel = _jstep(False)(
                jst, jm, jnp.asarray(q), jnp.asarray(v), jnp.asarray(b),
                jnp.asarray(qd), jcfg, plan=jplan, **low)
            ctx = (level, _low_name(low), t)
            assert_dataclass_same(tout, jout, ctx)
            assert_dataclass_same(ttel, jtel, ctx)
            assert_dataclass_same(tst, jst, ctx)
            assert (ttel.planes == plan.planes).all()
            assert (ttel.banks <= plan.banks).all()
