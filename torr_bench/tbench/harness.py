"""One run of one cell: make the inputs from the seed, build and warm the
deployment's engine, drive the cell's traffic for the measured window,
judge what it produced against the plain reference, read the metrics and
print the result line.

Phases, on the host clock (``time.perf_counter``):

  set-up   process start -> inputs from the seed -> kernels loaded (built
           on a checkout's first run) -> engine built, its graphs captured
           -> the traffic itself for ``warmup_s`` (every shape the window
           uses runs once) -> t0
  window   t0 -> t1 = t0 + seconds: the traffic goes on; with ``--trace
           1`` the engine's spans are on, and the window's last
           ``trace_s`` seconds run under torch.profiler (the per-layer
           readers see [t0, t1 - trace_s))
  drain    no window is submitted after t1; every submitted window is
           waited for (up to ``DRAIN_S``); the engine is closed, the peak
           memory read, the caches copied and the engine freed
  check    the reference judges every window (``check.py``)
"""
from __future__ import annotations

import json
import sys
import time
import types

import numpy as np
import torch

from . import check as chk
from . import inputs as inp_mod
from . import manifest, serving, trace as trace_mod

DRAIN_S = 60.0
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by their whole top-level names."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def record_launches() -> tuple[dict, object]:
    """Record the shapes of every launch of the program's hand-written
    kernels (``kernels.build.launch``): kernel name -> [(time, args)], a
    tensor argument as (numel, element size). A captured graph's kernels
    are recorded at their capture; its replays run the same shapes.
    Returns the records and a function that stops the recording."""
    from repro_torch.kernels import build

    records: dict = {}
    orig = build.launch

    def launch(name, device, *args):
        rec = tuple((a.numel(), a.element_size())
                    if isinstance(a, torch.Tensor) else a for a in args)
        records.setdefault(name, []).append((time.perf_counter(), rec))
        return orig(name, device, *args)

    build.launch = launch

    def stop():
        build.launch = orig
    return records, stop


def _finite(x: float) -> float:
    """A number JSON can carry: an infinite reading as 1e30."""
    return float(x) if np.isfinite(x) else 1e30


def _stats(eng) -> dict:
    st = eng.stats
    return {"steps": st.steps, "windows": st.windows}


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device=None, man: dict | None = None,
        cell: dict | None = None) -> tuple[int, dict | None]:
    """Run one cell; returns (exit code, result line or None). ``device``
    None runs on the card and requires as many as the cell asks for;
    ``device="cpu"`` is the tests' path (no card, the program's plain
    versions). ``man`` and ``cell`` (a workload entry with its
    ``config_file`` and ``traffic_file`` loaded) stand in for the
    checkout's manifest."""
    man = manifest.load() if man is None else man
    w = manifest.cell(man, cell_name) if cell is None else cell
    cfgf, traffic = w["config_file"], w["traffic_file"]
    tc, dep = cfgf["torr"], cfgf["deployment"]
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: this benchmark runs on the card",
                  file=sys.stderr)
            return 2, None
        if torch.cuda.device_count() < w["chips"]:
            print(f"{w['name']} needs {w['chips']} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2, None
        device = "cuda:0"
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    n_streams = traffic["streams_per_card"] * dep["cards"]
    n_max = traffic["n_max"]
    n_max = tc[n_max] if isinstance(n_max, str) else n_max
    marks = [("start", t_start), ("args", time.perf_counter())]
    slc = None
    if trace:
        slc = trace_mod.Slice()
        slc.prepare()
    inp = inp_mod.make_inputs(tc, n_streams, traffic["windows_per_stream"],
                              n_max, seed, dev)
    marks.append(("inputs", time.perf_counter()))
    if on_card:
        from repro_torch.kernels import build
        build.build_all()
    marks.append(("kernels", time.perf_counter()))
    launches, stop_recording = (record_launches() if trace
                                else (None, lambda: None))
    registry = None
    if trace:
        from repro_torch.obs.metrics import MetricsRegistry
        registry = MetricsRegistry()
    cfg = serving.torr_config(tc)
    eng = serving.build_engine(cfg, inp.codes, dep, dev, metrics=registry)
    eng.warmup()
    marks.append(("engine", time.perf_counter()))
    drv = serving.make_driver(eng, inp, traffic, seed, dev)
    drv.run(time.perf_counter() + traffic["warmup_s"])
    # the measured window
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    marks.append(("warm", t0))
    stats0, caps0 = _stats(eng), serving.captures(eng)
    spans0 = registry.snapshot() if registry else None
    t1 = t0 + seconds
    mark = {}
    if trace:
        # the slice closes the window, [t1 - span, t1]; the profiler is
        # stopped and its events reduced after the drain, when the engine
        # is idle. Per-layer readers see [t0, ts): the part the profiler
        # did not touch.
        span = min(traffic["trace_s"], seconds / 3)
        ts = t1 - span

        def at_slice():
            mark.update(stats=_stats(eng), caps=serving.captures(eng),
                        spans=registry.snapshot())
            slc.start()
        drv.hooks = [(ts, at_slice), (t1, slc.end)]
    drv.run(t1)
    t_end = ts if mark else t1
    stats1 = mark.get("stats") or _stats(eng)
    caps1 = mark.get("caps", serving.captures(eng))
    spans1 = mark.get("spans") or (registry.snapshot() if registry
                                   else None)
    marks.append(("window", time.perf_counter()))
    drv.drain(DRAIN_S)
    if slc is not None and slc.prof is not None:
        if mark:
            slc.stop()
        else:
            slc.close()
    eng.close(drain=False)
    stop_recording()
    mem = (max(torch.cuda.max_memory_allocated(d)
               for d in range(torch.cuda.device_count()))
           if on_card else 0)
    cache = serving.final_cache(eng)
    del eng
    if on_card:
        torch.cuda.empty_cache()

    marks.append(("drain", time.perf_counter()))
    numbers = chk.check(inp, drv.windows, cache, tc, seed, dev)
    marks.append(("check", time.perf_counter()))
    correct, shown = chk.verdict(numbers, cfgf["limits"])
    ctx = types.SimpleNamespace(
        cell=w, tc=tc, dep=dep, traffic=traffic, windows=drv.windows,
        t0=t0, t1=t_end, seconds=t_end - t0, setup_s=setup_s,
        stats=(stats0, stats1), captures=(caps0, caps1),
        spans=(spans0, spans1), trace=slc.result if slc else None,
        slice=(slc.t0, slc.t0 + slc.wall) if slc and slc.result else None,
        launches=launches, encodes=drv.encodes, ref=numbers.get("_rep"))
    kind = "metrics" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_of(man, w["name"],
                                 "per_layer" if trace else "end_to_end"):
        v = manifest.reader(kind, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    in_window = [x for ws in drv.windows for x in ws if t0 <= x.t_sub < t1]
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": w["chips"],
        "memory_peak_bytes": int(mem),
    }
    result = {"correct": bool(correct), "attempted": len(in_window),
              "failed": sum(1 for x in in_window if not x.ok),
              "metrics": metrics, "device": device_info}
    if slc is not None and slc.result:
        r = slc.result
        device_info["busy_s"] = float(np.mean([
            r["busy_s"].get(d, 0.0) for d in range(w["chips"])]))
        device_info["window_s"] = r["window_s"]
        result["breakdown"] = {"device_ops": r["device_ops"],
                               "idle_gaps": r["idle_gaps"]}
        # the device operations the slice recorded, against which a
        # graph's node count shows whether the profiler dropped any
        result["slice_device_events"] = r["device_events"]
    result["phases_s"] = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    result["check"] = {k: [_finite(v["value"]), v["limit"]]
                       for k, v in shown.items()}
    bad = loaded_forbidden()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3, None
    for k, v in shown.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    return 0, result


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="TorR edge serving benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    rc, result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start=t_start)
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return rc
