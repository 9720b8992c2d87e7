"""Port parity: the dry-run's measuring tools (``perf/roofline.py``,
``perf/op_analyze.py``, ``perf/profile_cell.py``; the port's counterparts
of ``repro.perf.roofline``, ``hlo_analyze`` and ``profile_cell``).

  * ``model_flops_for`` equals the reference's for every arch and shape
    (integer arithmetic on ``param_count``);
  * the ``Roofline`` terms and bottleneck as ``tests/test_perf_models.py``
    checks them, at the H100 constants;
  * the analyzer counts a loop of 8 products as 8 x 2 x 4 x 64 x 64 FLOPs,
    unrolled and through ``op_analyze.scan`` sampled (forward and
    backward), and counts each hand-written kernel as one op;
  * the TorR properties of ``tests/test_perf_models.py:88-190`` at their
    config: the prefix and switch steps never produce a [S, M, W] or
    [S*N, M, W] int32 tensor while ``fused="off"`` does; the scan kernel's
    bytes fall along the plan ladder, the step's bytes along its bank
    steps and along the compact bucket tiers.
"""
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.perf import roofline as jroofline
from repro_torch import configs as tconfigs
from repro_torch.control.plan import KnobPlan
from repro_torch.core import pipeline
from repro_torch.core.item_memory import random_item_memory
from repro_torch.core.types import TorrConfig
from repro_torch.perf import op_analyze, profile_cell, roofline


def test_model_flops_match_reference():
    for arch in jconfigs.ARCHS:
        for name, shape in jconfigs.SHAPES.items():
            assert roofline.model_flops_for(tconfigs.get(arch), shape) == \
                jroofline.model_flops_for(jconfigs.get(arch), shape), \
                (arch, name)


def test_roofline_terms_and_bottleneck():
    P, H, L = roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW
    assert (P, H, L) == (989e12, 3.35e12, 450e9)
    r = roofline.Roofline(
        arch="a", shape="s", mesh="m", chips=256,
        flops_global=P * 256,               # exactly 1s of compute
        bytes_global=H * 256 * 2,           # 2s of memory
        coll_bytes_global=L * 256 * 0.5,    # 0.5s of collectives
        coll_breakdown={}, model_flops=P * 256 * 0.5,
        memory_per_device={})
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(0.5)
    assert r.bottleneck == "memory"
    assert r.t_bound == pytest.approx(2.0)
    assert r.roofline_frac == pytest.approx(0.25)   # 0.5s ideal / 2s bound
    assert r.useful_flops_frac == pytest.approx(0.5)
    d = r.to_dict()
    assert d["bottleneck"] == "memory" and d["chips"] == 256


def _body(h, wi):
    h = torch.tanh(h @ wi)
    return h, h


def test_analyzer_counts_a_loop_of_products():
    w = torch.zeros(8, 64, 64)
    x = torch.zeros(4, 64)
    want = 8 * 2 * 4 * 64 * 64

    def unrolled(w, x):
        h = x
        for i in range(8):
            h = torch.tanh(h @ w[i])
        return h.sum()

    _, a = op_analyze.analyze(unrolled, w, x)
    assert a.flops == want
    _, s = op_analyze.analyze(
        lambda: op_analyze.scan(lambda h, i: _body(h, w[i]), x, range(8)),
        sample_loops=True)
    assert s.flops == want
    assert sum(r.name == "mm" for r in s.ops) == 2       # ran twice
    assert s.bytes_traffic == pytest.approx(a.bytes_traffic - 8 * 4 * 4,
                                            rel=0.02)

    # the backward's ops scale too: the sampled loop's gradient counts as
    # the unrolled one's
    def grads(sample):
        wg = w.clone().requires_grad_(True)
        xg = x.clone().requires_grad_(True)

        def run():
            h, _ = op_analyze.scan(lambda h, i: _body(h, wg[i]), xg,
                                   range(8))
            h.sum().backward()
        return op_analyze.analyze(run, sample_loops=sample)[1].flops

    assert grads(True) == grads(False) == 3 * want


def test_kernel_wrappers_count_as_one_op():
    from repro_torch.kernels import fused_window
    from repro_torch.kernels.xnor_popcount_sim import packed_hamming_batched

    g = torch.Generator().manual_seed(0)
    q = torch.randint(-2**31, 2**31 - 1, (6, 8), dtype=torch.int32,
                      generator=g)
    h = torch.randint(-2**31, 2**31 - 1, (5, 8), dtype=torch.int32,
                      generator=g)
    out, a = op_analyze.analyze(packed_hamming_batched, q, h)
    assert [r.name for r in a.ops] == ["packed_hamming_batched"]
    assert a.flops == 64 * 6 * 5 * 8
    assert a.bytes_traffic == (6 * 8 + 5 * 8 + 6 * 5) * 4
    assert torch.equal(out, packed_hamming_batched(q, h))
    _, a = op_analyze.analyze(fused_window.fused_scores, q, h, d_eff=256)
    assert [r.name for r in a.ops] == ["fused_scores"]


def test_profile_ranks_ops():
    w = torch.zeros(8, 64, 64)
    x = torch.zeros(4, 64)

    def f(w, x):
        h = x
        for i in range(8):
            h = torch.tanh(h @ w[i])
        return h @ torch.zeros(64, 512)

    _, a = op_analyze.analyze(f, w, x)
    by_bytes, by_flops = profile_cell.profile_rows(
        op_analyze.aggregate(a.ops), top=3)
    assert by_flops[0]["op"] == "mm" and by_flops[0]["count"] == 8
    assert by_bytes[0]["bytes"] >= by_bytes[1]["bytes"] >= by_bytes[2]["bytes"]
    assert "test_torch_perf_tools" not in by_flops[0]["where"]
    text = profile_cell.format_rows(by_bytes, by_flops, 3)
    assert "top 3 by per-device FLOPs" in text


# --- the TorR step (tests/test_perf_models.py:88-190) ----------------------

CFG = TorrConfig(D=2048, B=8, M=48, K=4, N_max=8, delta_budget=128,
                 feat_dim=64)
S = 4
KERNELS = ("bank_prefix_hamming", "fused_scores", "packed_hamming_batched",
           "delta_update")


def _step_analysis(**kw):
    im = random_item_memory(torch.Generator().manual_seed(0), CFG)
    st = pipeline.init_multi_stream_state(
        CFG, np.zeros((S, CFG.M), np.float32), device="cpu")
    args = (st, im, torch.zeros((S, CFG.N_max, CFG.words), dtype=torch.int32),
            torch.ones((S, CFG.N_max), dtype=torch.bool),
            torch.zeros((S, CFG.N_max, 4)),
            torch.zeros((S,), dtype=torch.int32))
    _, a = op_analyze.analyze(
        lambda: pipeline.torr_multi_stream_step(*args, CFG, **kw))
    return a


def _materializes(a, dims) -> bool:
    return any(s == dims and d == "int32" for r in a.ops
               for s, d in zip(r.shapes, r.dtypes))


def _kernel_bytes(a) -> float:
    return sum(r.bytes for r in a.ops if r.name in KERNELS)


def test_fused_steps_never_materialize_smw():
    smw = (S, CFG.M, CFG.words)
    assert _materializes(_step_analysis(fused="off"), smw)
    for fused in ("prefix", "switch"):
        a = _step_analysis(fused=fused)
        assert not _materializes(a, smw), fused
        assert not _materializes(a, (S * CFG.N_max, CFG.M, CFG.words)), fused
        assert any(r.name in KERNELS for r in a.ops), fused


def test_fused_step_bytes_scale_with_plan():
    ladder = [(8, 4), (8, 2), (4, 2), (2, 1)]
    runs = [_step_analysis(fused="prefix", plan=KnobPlan(
        banks=b, planes=p, plane_total=CFG.bit_planes)) for b, p in ladder]
    kernel = [_kernel_bytes(a) for a in runs]
    for hi, lo in zip(kernel, kernel[1:]):
        assert lo < hi, (ladder, kernel)
    # the step: each bank step moves fewer bytes; the first planes step
    # adds the plane gather and word mask (PERF.md, Findings)
    total = [a.bytes_traffic for a in runs]
    assert total[2] < total[1] and total[3] < total[2], total
    assert total[3] < total[0], total


def test_compact_step_bytes_scale_with_bucket_tier():
    measured = [_step_analysis(fused="compact", bucket_cap=tier)
                .bytes_traffic for tier in (32, 16, 8, 4)]
    for hi, lo in zip(measured, measured[1:]):
        assert lo < hi, measured
