"""Serving launcher: the multi-stream TorR window engine (port of the
``--torr-*`` path of ``repro.launch.serve``).

Examples:
    PYTHONPATH=src python -m repro_torch.launch.serve --torr-streams 8 \\
        --torr-frames 30
    # async dispatch/collect runtime with RT-60 deadline admission control
    # and the closed-loop QoS governor:
    PYTHONPATH=src python -m repro_torch.launch.serve --torr-streams 8 \\
        --torr-frames 30 --async --rt RT-60 --governor
    # on the CPU (the plain versions of the kernels), with every artifact:
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --torr-streams 4 --torr-frames 3 --async --rt RT-60 --governor \\
        --metrics-json m.json --flight-jsonl f.jsonl --trace-json t.json

It serves S synthetic TOOD streams (``data.tood_synth``) at ``repro``'s
launcher config (D=2048, B=8, M=64, K=16, N_max=16, delta_budget=256): each
stream's frames go through the encode front-end (``ops.encode_packed``,
the ``sign_project_pack`` kernel on the card) and their packed queries are
submitted to ``StreamEngine`` or, with ``--async``, ``--rt`` or
``--governor``, ``AsyncStreamEngine``. The engines run on the card unless
``--device cpu`` is given.

QoS control plane (``--governor``)
==================================

``--governor`` arms the closed loop of ``repro_torch.control``: per
dispatched step, the RT-deadline tracker's projected slack, the deepest
per-slot backlog and an EWMA of modeled window energy
(``perf.cycle_model`` priced on each window's own telemetry) drive a slack
ladder of knob plans (D' bank caps, bit-slice precision, tau offsets), and
the chosen plan is latched for the step. It requires (and with a bare
``--governor`` defaults to) an ``--rt`` operating point. The governor's
knobs are read from the environment by ``control.policy_from_env``
(``TORR_GOV_MARGIN``, ``TORR_GOV_HOLD``, ``TORR_GOV_ENERGY_MJ``,
``TORR_GOV_ALPHA``; defaults 0.25, 4, off, 0.2).

Observability (``--metrics-port/-json`` / ``--flight-jsonl`` / ``--trace-json``)
================================================================================

Any of the four flags arms ``repro_torch.obs`` on the engine, the deadline
tracker and the governor: ``--metrics-port N`` serves Prometheus text on
``http://127.0.0.1:N/metrics`` for the run (0 = an ephemeral port, printed
at startup), ``--metrics-json PATH`` dumps the final registry snapshot,
``--flight-jsonl PATH`` spills the flight recorder (one record per
dispatched step, replayable with ``obs.flight.replay`` into the governor's
plan timeline), and ``--trace-json PATH`` arms per-window causal tracing
and writes a Chrome trace-event JSON. With ``--rt`` armed as well, window
completions feed the RT-SLO burn-rate monitor (``obs.slo``).

Shutdown: SIGINT/SIGTERM unwind the serving loop; in-flight windows are
cancelled and every armed artifact is still written before the process
exits.

One card: ``--mesh`` takes 0 or 1 (``repro`` shards the stream slots over
more devices; the port serves one). Not offered yet, and brought by a
later slice of the port: the fault-tolerance flags (``--supervise``,
``--state-store``, ``--snapshot-every``, ``--fault-at``, ``--fault-kind``,
``--outputs-jsonl``), the network gateway (``--gateway-*``) and the LM
serving path (``--arch`` and its options).
"""
from __future__ import annotations

import argparse
import signal
import threading
import time

import numpy as np
import torch

from ..core.types import TorrConfig

# repro's launcher config; K >= N_max so a window cannot thrash its own
# cache out of reuse range
SERVE_CFG = dict(D=2048, B=8, M=64, K=16, N_max=16, delta_budget=256)


def _install_signal_handlers():
    """Route SIGINT/SIGTERM into KeyboardInterrupt so the serving loop
    unwinds through its cleanup path and writes its artifacts. Returns the
    previous handlers for restoration, or None off the main thread
    (signal.signal is main-thread-only)."""
    if threading.current_thread() is not threading.main_thread():
        return None

    def _raise(signum, _frame):
        raise KeyboardInterrupt(f"signal {signum}")

    previous = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            previous[sig] = signal.signal(sig, _raise)
        except (ValueError, OSError):  # exotic embeddings may refuse
            pass
    return previous


def _restore_signal_handlers(previous) -> None:
    if previous:
        for sig, handler in previous.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass


def run_torr_streams(n_streams: int, n_frames: int, n_slots: int = 0,
                     serial: bool = False, use_async: bool = False,
                     mesh_devices: int = 0, rt: str = "",
                     governor: bool = False, fused: str | None = None,
                     metrics_port: int | None = None, metrics_json: str = "",
                     flight_jsonl: str = "", flight_capacity: int = 4096,
                     trace_json: str = "", device=None):
    """Serve S synthetic TOOD streams through the batched window engine.

    ``use_async`` routes through the dispatch/collect
    :class:`~repro_torch.serving.async_engine.AsyncStreamEngine`; ``rt``
    ("RT-30"/"RT-60") arms the deadline admission controller and
    ``governor`` the QoS loop (both imply the async runtime);
    ``mesh_devices`` takes 0 or 1 (one card). ``fused`` picks the full
    path's lowering (None = the lowering's default). ``device`` is where
    the engine and the encode run (the card by default; ``"cpu"`` runs the
    plain versions).

    Any of ``metrics_port`` (HTTP exposition; 0 = ephemeral),
    ``metrics_json``, ``flight_jsonl`` or ``trace_json`` (which also arms
    per-window causal tracing) arms ``repro_torch.obs`` across the
    engine, tracker and governor; an armed ``rt`` also feeds the RT-SLO
    burn-rate monitor. Returns None when observability is off; otherwise a
    dict with the final ``registry``/``flight``/``tracer``/``slo``
    objects, the scraped ``metrics_text`` (when a server ran), the engine
    ``summary``, the window accounting: ``submitted``, ``served``,
    ``shed`` and ``lost`` (submitted windows neither served nor shed),
    the engine's ``steps``, and ``launches``: each kernel's launches after
    the warm-up (the encode's and the served steps')."""
    from ..data import tood_synth as ts
    from ..device import resolve_device
    from ..kernels import build, ops
    from ..runtime.fault import EngineDead
    from ..serving import tood_pipelines as tp
    from ..serving.stream_engine import StreamEngine

    if mesh_devices not in (0, 1):
        raise ValueError(f"mesh_devices={mesh_devices}: the port serves one "
                         "card (0 or 1)")
    use_async = use_async or bool(rt) or governor
    dev = resolve_device(device)
    cfg = TorrConfig(**SERVE_CFG)
    world = ts.make_world(0, M=cfg.M, d=cfg.feat_dim)
    sys_ = tp.build_system(world, cfg, torch.Generator().manual_seed(0))
    n_slots = n_slots or n_streams
    registry = flight = server = tracer = slo = None
    if metrics_port is not None or metrics_json or flight_jsonl or trace_json:
        from ..obs import FlightRecorder, MetricsRegistry, MetricsServer
        registry = MetricsRegistry()
        flight = FlightRecorder(flight_capacity, metrics=registry)
        if trace_json:
            from ..obs import Tracer
            tracer = Tracer(metrics=registry)
        if metrics_port is not None:
            server = MetricsServer(registry, port=metrics_port)
            print(f"[serve/torr] metrics endpoint "
                  f"http://127.0.0.1:{server.start()}/metrics")
    if use_async:
        from ..serving.async_engine import AsyncStreamEngine
        from ..serving.deadline import DeadlineTracker, policy_for
        if governor and not rt:
            rt = "RT-60"    # the governor is slack-driven: needs a deadline
        tracker = None
        if rt:
            if registry is not None:
                from ..obs import SLOMonitor
                slo = SLOMonitor(metrics=registry, flight=flight)
            tracker = DeadlineTracker(policy_for(rt), metrics=registry,
                                      slo=slo)
        gov = None
        if governor:
            from ..control import Governor, policy_from_env
            gov = Governor(cfg, policy_from_env(rt), metrics=registry)
        eng = AsyncStreamEngine(
            cfg, sys_.im, n_slots=n_slots, serial=serial, fused=fused,
            tracker=tracker, governor=gov, paused=True, metrics=registry,
            flight=flight, tracer=tracer, device=dev)
    else:
        eng = StreamEngine(cfg, sys_.im, n_slots=n_slots, serial=serial,
                           fused=fused, metrics=registry, flight=flight,
                           tracer=tracer, device=dev)

    R = torch.as_tensor(sys_.R).to(dev)
    n_tasks = world.relevance.shape[0]
    paths, valids = [], []
    eng.warmup()  # build, load and capture outside the timed drains
    # the kernel launches of the served run alone: the warm-up's (every
    # ladder level's capture and replay with a governor) are taken off
    launches0 = dict(build.LAUNCHES)
    if use_async:
        eng.start()
    t_total = 0.0
    submitted = served = shed = 0
    interrupted = False
    prev_handlers = None
    try:
        # handlers armed and the line printed inside the try: a signal that
        # arrives right after the line still lands in the flush below
        prev_handlers = _install_signal_handlers()
        print("[serve/torr] serving (SIGINT/SIGTERM flushes artifacts)",
              flush=True)
        # admit streams in waves of n_slots: slots < streams queues work
        for wave_start in range(0, n_streams, n_slots):
            wave = range(wave_start, min(wave_start + n_slots, n_streams))
            # synthesize and encode the wave's windows outside the timed
            # region: one encode call a stream, its frames' proposals
            windows = []   # (stream_id, words, valid, boxes), in order
            for s in wave:
                task = s % n_tasks
                eng.admit(f"stream{s}", sys_.task_w[task])
                frames = ts.simulate_sequence(world, task, n_frames, seed=s,
                                              n_max=cfg.N_max)
                feats = np.concatenate([f.feats for f in frames])
                words = ops.encode_packed(feats, R, device=dev)
                for t, f in enumerate(frames):
                    windows.append((f"stream{s}",
                                    words[t * cfg.N_max:(t + 1) * cfg.N_max],
                                    f.valid, f.boxes))
            futures = []   # (future, valid-mask), submission order
            t0 = time.time()
            for sid, q, fvalid, fboxes in windows:
                fut = eng.submit(sid, q, fvalid, fboxes)
                submitted += 1
                if use_async:
                    futures.append((fut, fvalid))
                else:
                    valids.append(fvalid)
            if use_async:
                from ..serving.deadline import WindowShed
                eng.flush()
                t_total += time.time() - t0
                for fut, vmask in futures:
                    try:
                        _wout, tel = fut.result()
                    except WindowShed:
                        shed += 1
                        continue
                    served += 1
                    paths.append(np.asarray(tel.path))
                    valids.append(vmask)
            else:
                results = eng.drain()
                eng.sync()
                t_total += time.time() - t0
                for s in wave:
                    for _wout, tel in results[f"stream{s}"]:
                        served += 1
                        paths.append(tel.path.cpu().numpy())
            for s in wave:
                eng.retire(f"stream{s}")
    except KeyboardInterrupt:
        # SIGINT/SIGTERM (or a ^C): stop serving, but the artifact flush
        # below still runs on an interrupted run
        interrupted = True
        print("[serve/torr] interrupted: cancelling in-flight windows "
              "and flushing observability artifacts")
    except EngineDead:
        eng.close(drain=False)      # join the workers, then fail the run
        raise
    finally:
        if prev_handlers is not None:
            _restore_signal_handlers(prev_handlers)

    if use_async:
        eng.close(drain=not interrupted)
    launches = {k: n - launches0.get(k, 0) for k, n in build.LAUNCHES.items()}
    mode = "async" if use_async else "sync"
    print(f"[serve/torr] streams={n_streams} slots={eng.n_slots} "
          f"frames/stream={n_frames} mode={mode} device={dev}")
    if paths:
        # count only real proposal lanes: padding lanes report as bypass
        pvals = np.concatenate(paths)[np.concatenate(valids)]
        print(f"[serve/torr] {eng.stats.windows} windows in "
              f"{t_total*1e3:.1f} ms ({eng.stats.windows/t_total:.1f} "
              f"windows/s, occupancy {eng.stats.occupancy:.2f})")
        print(f"[serve/torr] path mix: bypass={np.mean(pvals == 0):.2f} "
              f"delta={np.mean(pvals == 1):.2f} "
              f"full={np.mean(pvals == 2):.2f}")
    else:
        print("[serve/torr] no windows served")
    if shed:
        print(f"[serve/torr] shed {shed} windows past deadline")
    lost = 0 if interrupted else submitted - served - shed
    if lost:
        print(f"[serve/torr] LOST {lost} of {submitted} submitted windows")
    if use_async:
        summary = eng.deadline_summary()
        if summary is not None:
            print(f"[serve/torr] deadline: p99={summary['p99_ms']:.2f} ms "
                  f"jitter={summary['jitter_ms']:.2f} ms "
                  f"miss_rate={summary['miss_rate']:.3f} "
                  f"shed={summary['shed']} "
                  f"escalated={summary['escalated']}")
        gsum = eng.governor_summary()
        if gsum is not None:
            print(f"[serve/torr] governor: level={gsum['level']}"
                  f"/{gsum['n_levels'] - 1} "
                  f"plan=(banks={gsum['plan_banks']}, "
                  f"planes={gsum['plan_planes']}) "
                  f"switches={gsum['plan_switches']} "
                  f"energy_ewma={gsum['energy_ewma_mj']:.1f} mJ "
                  f"windows_by_level={gsum['windows_by_level']}")
        if slo is not None:
            ssum = slo.summary()
            print(f"[serve/torr] slo: alert={ssum['alert']} "
                  f"burn(fast={ssum['burn_fast']:.2f}, "
                  f"slow={ssum['burn_slow']:.2f}) "
                  f"missed={ssum['missed']}/{ssum['completed']} "
                  f"(objective {ssum['objective']:.2f})")

    if registry is None:
        if lost:
            raise SystemExit(3)
        return None
    # fold any telemetry the sync engine still defers before the registry
    # is read (a no-op on the async runtime, whose collector folds)
    eng.flush_telemetry()
    metrics_text = None
    if server is not None:
        import urllib.request
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics") as resp:
            metrics_text = resp.read().decode()
        n_fam = metrics_text.count("# TYPE ")
        print(f"[serve/torr] metrics: {n_fam} families exposed at /metrics")
        server.close()
    if metrics_json:
        from ..obs import write_json_snapshot
        write_json_snapshot(registry, metrics_json)
        print(f"[serve/torr] metrics snapshot -> {metrics_json}")
    if flight_jsonl:
        n_rec = flight.dump_jsonl(flight_jsonl)
        print(f"[serve/torr] flight recorder: {n_rec} step records -> "
              f"{flight_jsonl}")
    if trace_json:
        from ..obs import write_chrome_trace
        n_ev = write_chrome_trace(flight.records(), trace_json)
        print(f"[serve/torr] chrome trace: {n_ev} events "
              f"({tracer.minted} windows traced) -> {trace_json}")
    result = {"registry": registry, "flight": flight, "tracer": tracer,
              "slo": slo, "metrics_text": metrics_text,
              "summary": eng.summary(), "interrupted": interrupted,
              "submitted": submitted, "served": served, "shed": shed,
              "lost": lost, "steps": eng.stats.steps, "launches": launches}
    if lost:
        raise SystemExit(3)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Serve synthetic TOOD streams through the port's TorR "
                    "window engine.")
    ap.add_argument("--torr-streams", type=int, default=0,
                    help="serve N synthetic TOOD streams through the "
                         "multi-stream window engine and exit")
    ap.add_argument("--torr-frames", type=int, default=30)
    ap.add_argument("--torr-slots", type=int, default=0,
                    help="stream slots (defaults to --torr-streams)")
    ap.add_argument("--torr-serial", action="store_true",
                    help="the serial lowering (each slot through the "
                         "single-window switch step) instead of the "
                         "batched step")
    ap.add_argument("--torr-fused", default="", metavar="MODE",
                    choices=["", "switch", "prefix", "compact", "auto",
                             "off"],
                    help="full-path lowering: switch | prefix | compact "
                         "(reuse-aware compact-then-compute) | auto "
                         "(load-aware: compact vs hoisted per step from "
                         "the telemetry path-mix EWMA) | off (oracle); "
                         "default picks per lowering")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="dispatch/collect split: overlap host window "
                         "assembly with device steps (AsyncStreamEngine)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    choices=[0, 1],
                    help="devices to shard the stream slots over: the port "
                         "serves one card (0 or 1)")
    ap.add_argument("--rt", default="", choices=["", "RT-30", "RT-60"],
                    help="arm RT-deadline admission control at this "
                         "operating point (implies --async)")
    ap.add_argument("--governor", action="store_true",
                    help="close the QoS loop: slack-driven bank/precision "
                         "gating with the energy governor (implies --async; "
                         "defaults --rt to RT-60)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve Prometheus text on 127.0.0.1:PORT/metrics "
                         "for the run (0 = ephemeral port, printed at "
                         "startup)")
    ap.add_argument("--metrics-json", default="", metavar="PATH",
                    help="dump the final metrics registry snapshot as JSON")
    ap.add_argument("--flight-jsonl", default="", metavar="PATH",
                    help="spill the flight recorder (one record per "
                         "dispatched step) to JSONL")
    ap.add_argument("--flight-capacity", type=int, default=4096,
                    metavar="N", help="flight recorder ring size (steps)")
    ap.add_argument("--trace-json", default="", metavar="PATH",
                    help="arm per-window causal tracing and write a Chrome "
                         "trace-event JSON")
    ap.add_argument("--device", default=None,
                    help="where the engine runs (default: the card; cpu "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.torr_streams <= 0:
        ap.error("--torr-streams N is required (the LM serving path is not "
                 "ported)")
    run_torr_streams(args.torr_streams, args.torr_frames, args.torr_slots,
                     serial=args.torr_serial, use_async=args.use_async,
                     mesh_devices=args.mesh, rt=args.rt,
                     governor=args.governor, fused=args.torr_fused or None,
                     metrics_port=args.metrics_port,
                     metrics_json=args.metrics_json,
                     flight_jsonl=args.flight_jsonl,
                     flight_capacity=args.flight_capacity,
                     trace_json=args.trace_json, device=args.device)


if __name__ == "__main__":
    main()
