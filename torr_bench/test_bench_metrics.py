"""The metric arithmetic: windows per second over the window, windows a
step and the query cache's hit share, the kernels' bounds and the step's
required work at known shapes, and readers that find nothing returning
nothing."""
import math
import types

import numpy as np
import pytest

from tbench import counts, manifest
from tbench import readings as rd
from tbench.serving import Window

TC = {"D": 8192, "M": 1024, "feat_dim": 512}


def ctx_of(windows, t0=0.0, t1=10.0, **kw):
    base = dict(windows=[windows], t0=t0, t1=t1, seconds=t1 - t0,
                trace=None, launches=None, ref=None,
                stats=({"steps": 0, "windows": 0},
                       {"steps": 10, "windows": 40}),
                spans=(None, None), cell={"chips": 1}, tc=TC)
    base.update(kw)
    return types.SimpleNamespace(**base)


def win(t_sub, latency, ok=True):
    w = Window(stream=0, seq=0, j=0, t_sub=t_sub,
               t_done=t_sub + latency if ok else float("nan"))
    w.ok = ok
    return w


def test_windows_per_s_counts_deliveries_inside_the_window():
    ws = [win(i * 0.5, 0.2) for i in range(30)]     # delivered 0.2 .. 14.7
    ctx = ctx_of(ws, t0=1.0, t1=11.0)
    inside = sum(1 for w in ws if 1.0 <= w.t_done < 11.0)
    assert manifest.reader("end_to_end", "windows_per_s")(ctx) == \
        inside / 10.0


def test_windows_per_s_leaves_out_windows_not_delivered():
    ws = [win(i * 0.5, 0.2) for i in range(20)]
    ws += [win(i * 0.5, 0.2, ok=False) for i in range(20)]
    ctx = ctx_of(ws, t0=0.0, t1=10.0)
    assert manifest.reader("end_to_end", "windows_per_s")(ctx) == 2.0


def test_windows_per_step_and_the_cache_hit_share():
    a, b = win(1.0, 0.1), win(2.0, 0.1)
    a.path, a.n_valid = np.array([0, 0, 2, 1, 0]), 4   # padding row last
    b.path, b.n_valid = np.array([0, 2, 2, 2, 0]), 4
    ctx = ctx_of([a, b])
    assert manifest.reader("metrics", "windows_per_step")(ctx) == 4.0
    assert manifest.reader("metrics", "bypass_pct")(ctx) == \
        pytest.approx(100.0 * 3 / 8)
    assert manifest.reader("metrics", "bypass_pct")(ctx_of([])) is None
    none = ctx_of([], stats=({"steps": 5, "windows": 9},
                             {"steps": 5, "windows": 9}))
    assert manifest.reader("metrics", "windows_per_step")(none) is None


def test_kernel_bounds_at_known_shapes():
    # the encode of one window: z [128, 512], R [8192, 512], words out
    args = ((128 * 512, 4), (8192 * 512, 4), (128 * 256, 4), 128, 512, 8192)
    flops = 2 * 128 * 512 * 8192
    nbytes = 4 * (128 * 512 + 8192 * 512 + 128 * 256)
    assert counts.launch_flops("sign_project_pack", args) == flops
    assert counts.launch_bytes(args) == nbytes
    assert counts.bound_s("sign_project_pack", args) == pytest.approx(
        max(flops / 495e12, nbytes / 3.35e12))
    # the compact scan over 2048 rows, 8 banks: bytes alone
    ham = ((2048 * 256, 4), (1024 * 256, 4), (2048 * 1024 * 8, 4), 2048,
           1024, 256, 8)
    assert counts.launch_flops("bank_prefix_hamming", ham) == 0
    assert counts.bound_s("bank_prefix_hamming", ham) == pytest.approx(
        4 * (2048 * 256 + 1024 * 256 + 2048 * 1024 * 8) / 3.35e12)


def test_roofline_share_from_a_trace_and_nothing_without_one():
    args = ((2048 * 256, 4), (1024 * 256, 4), (2048 * 1024 * 8, 4), 2048,
            1024, 256, 8)
    bound = counts.bound_s("bank_prefix_hamming", args)
    trace = {"kernels": {"bank_prefix_hamming_kernel<8>": {
        "count": 10, "s": 20 * bound}}, "busy_s": {0: 0.5},
        "window_s": 1.0}
    ctx = ctx_of([], trace=trace, launches={"bank_prefix_hamming": [
        (0.0, args)]}, slice=(5.0, 6.0))
    share = rd.roofline_pct(ctx, "bank_prefix_hamming")
    assert share == pytest.approx(50.0)
    assert rd.roofline_pct(ctx_of([]), "bank_prefix_hamming") is None
    assert rd.roofline_pct(ctx, "sign_project_pack") is None


def test_step_mfu_from_the_reference_path_mix():
    rep = types.SimpleNamespace(
        path=[np.array([[2, 2, 1, 0] + [0] * 124])],
        d_count=[np.array([[0, 0, 100, 0] + [0] * 124])])
    w = win(0.5, 0.1)
    w.n_valid = 4
    ctx = ctx_of([w], ref=rep, stats=({"steps": 0, "windows": 0},
                                      {"steps": 1, "windows": 1}))
    flops, nbytes = counts.window_required(TC, 4, 2, [100])
    nbytes += counts.item_memory_bytes(TC)
    want = 100 * max(flops / 495e12, nbytes / 3.35e12) / 10.0
    assert rd.step_mfu_pct(ctx) == pytest.approx(want)
    assert 0 < want < 100
    assert rd.step_mfu_pct(ctx_of([])) is None
    assert math.isfinite(want)
