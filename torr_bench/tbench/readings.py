"""What the metric readers share: the windows of the measured window, span
and counter deltas, and roofline shares from the traced slice. Each reader
(``end_to_end/<name>.py``, ``metrics/<name>.py``) is a few lines over
these. A reader that finds nothing to read returns None."""
from __future__ import annotations

import numpy as np

from . import counts


def resolved_in_window(ctx) -> list:
    """Windows delivered inside [t0, t1)."""
    return [w for ws in ctx.windows for w in ws
            if w.ok and ctx.t0 <= w.t_done < ctx.t1]


def counter_delta(ctx, key: str):
    a, b = ctx.stats
    return b[key] - a[key]


def span_mean_ms(ctx, name: str):
    """Mean duration in ms of span ``name`` over the window, from the
    engine's span histogram (sum and count at t0 and t1)."""
    s0, s1 = ctx.spans
    if s1 is None:
        return None

    def read(snap):
        fam = snap.get("torr_span_duration_seconds")
        for ser in (fam or {}).get("series", []):
            if ser["labels"].get("span") == name:
                return ser["sum"], ser["count"]
        return 0.0, 0
    (a, n0), (b, n1) = read(s0), read(s1)
    if n1 - n0 <= 0:
        return None
    return 1e3 * (b - a) / (n1 - n0)


def roofline_pct(ctx, kernel: str):
    """Device time of ``kernel`` in the traced slice against the least time
    of the same launches: the launches' mean bound (their shapes as
    launched; a graph's kernels as captured) times the launches the trace
    holds, over their device time. None when the trace holds none."""
    t, rec = ctx.trace, ctx.launches
    if not t or not rec or kernel not in rec:
        return None
    fns = counts.DEVICE_FUNCTIONS[kernel]
    n, secs = 0, 0.0
    for name, k in t["kernels"].items():
        if any(f in name for f in fns):
            n += k["count"]
            secs += k["s"]
    if n == 0 or secs <= 0:
        return None
    lo, hi = ctx.slice
    inside = [a for ts, a in rec[kernel] if lo <= ts <= hi]
    shapes = inside or [a for _ts, a in rec[kernel]]
    bound = np.mean([counts.bound_s(kernel, a) for a in shapes])
    return 100.0 * bound * n / secs


def step_mfu_pct(ctx):
    """The least time the window's required work needs at the published
    peaks, over the window's length: the windows delivered in it, with the
    reference's path of every valid proposal (full and delta counts), and
    the item memory and projection once a step."""
    rep = ctx.ref
    if rep is None:
        return None
    flops = nbytes = 0
    for w in resolved_in_window(ctx):
        path = rep.path[w.stream][w.seq]          # padding rows: bypass
        dcnt = rep.d_count[w.stream][w.seq]
        f, b = counts.window_required(ctx.tc, int(w.n_valid),
                                      int(np.sum(path == 2)),
                                      dcnt[path == 1])
        flops += f
        nbytes += b
    steps = counter_delta(ctx, "steps")
    if steps <= 0:
        return None
    nbytes += steps * counts.item_memory_bytes(ctx.tc)
    bound = max(flops / counts.PEAK_TF32_FLOPS,
                nbytes / counts.PEAK_HBM_BYTES)
    return 100.0 * bound / ctx.seconds
