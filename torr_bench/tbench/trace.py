"""A slice at the end of the measured window under ``torch.profiler``, reduced
to what the per-layer readers need: per card, the union of the intervals
in which a device operation ran (busy), the slice's length, the device
time and count of each kernel name, the operations that took most time,
and the idle gaps labelled by the host operation open when each began.

The trace stays in memory (no file is written). The device's activity
tracing slows the host, so a traced run reports only per-layer metrics.
"""
from __future__ import annotations

import bisect
import time

import torch

TOP = 10
GAP_MIN_NS = 10_000          # gaps shorter than this are not labelled


class Slice:
    """:meth:`prepare` runs one empty profiler session before the program
    loads anything on the card, so that the device's activity tracing is
    set up before the engine captures its graphs (set up afterwards, on
    the H100 host, it took 8-13 s and recorded no kernel of the graphs).
    :meth:`start` and :meth:`stop` then bracket the slice; read the
    reduction from :attr:`result`."""

    def __init__(self):
        self.prof = None
        self.result = None
        # device activity only: it brings the CUDA runtime calls with it
        # (which label the idle gaps), and leaves the operators of every
        # host thread unrecorded, which would slow the whole run (on the
        # CPU the host's operators are all there is to record)
        self.acts = [torch.profiler.ProfilerActivity.CUDA
                     if torch.cuda.is_available()
                     else torch.profiler.ProfilerActivity.CPU]

    def prepare(self) -> None:
        with torch.profiler.profile(activities=self.acts):
            pass

    def start(self) -> None:
        self.prof = torch.profiler.profile(activities=self.acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.ns0 = time.time_ns()

    def end(self) -> None:
        """Close the slice: what ran after this is left out. The profiler
        itself is stopped by :meth:`stop` once the program's threads are
        idle (stopped beside them, it hung the run on the H100 host)."""
        self.wall = time.perf_counter() - self.t0
        self.ns1 = time.time_ns()

    def stop(self) -> None:
        if torch.cuda.is_available():
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        self.result = reduce_events(events, self.wall,
                                    (self.ns0, self.ns1))

    def close(self) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None


def _union(iv: list) -> tuple[int, list]:
    """(covered ns, merged intervals) of [start, end) intervals."""
    iv.sort()
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def reduce_events(events, wall_s: float, clip=None) -> dict:
    """Reduce kineto events to busy seconds per card, the slice's window,
    kernel time and count by name, the top device operations and the
    labelled idle gaps (summed by label). ``clip`` (start, end), in the
    events' nanoseconds, keeps only what lies inside."""
    lo, hi = clip if clip else (-2 ** 63, 2 ** 63)
    dev_iv, kernels, host = {}, {}, []
    for e in events:
        dt = e.device_type()
        if dt == torch.autograd.DeviceType.CUDA:
            a = max(e.start_ns(), lo)
            b = min(e.start_ns() + e.duration_ns(), hi)
            if b <= a:
                continue
            n = b - a
            dev_iv.setdefault(e.device_index(), []).append((a, b))
            k = kernels.setdefault(e.name(), [0, 0])
            k[0] += 1
            k[1] += n
        elif not e.name().startswith("bench."):
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                         e.name()))
    busy, gaps = {}, {}
    host.sort()
    starts = [h[0] for h in host]
    for d, iv in dev_iv.items():
        covered, merged = _union(iv)
        busy[d] = covered / 1e9
        for (_a, b), (c, _d) in zip(merged, merged[1:]):
            if c - b < GAP_MIN_NS:
                continue
            # the innermost host operation open when the gap began
            i = bisect.bisect_right(starts, b)
            label, span = "no host operation", None
            for h in host[max(0, i - 400):i]:
                if h[0] <= b < h[1] and (span is None or
                                         h[1] - h[0] < span):
                    label, span = h[2], h[1] - h[0]
            gaps[label] = gaps.get(label, 0) + (c - b)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "window_s": wall_s,
        "device_events": sum(c for c, _ns in kernels.values()),
        "busy_s": busy,                       # card -> seconds
        "kernels": {k: {"count": c, "s": ns / 1e9}
                    for k, (c, ns) in kernels.items()},
        "device_ops": [[k[:120], ns / 1e9] for k, (_c, ns) in top],
        "idle_gaps": [[k[:120], ns / 1e9] for k, ns in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }
