"""Serving launcher: batched LM prefill + decode with the optional TorR
reranker, and the multi-stream TorR window engine (port of
``repro.launch.serve``).

Examples:
    # an LM (the registry's architectures; random weights from a seed)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --rerank
    PYTHONPATH=src python -m repro_torch.launch.serve --arch \
        musicgen-large --smoke --batch 2 --prompt-len 16 --gen 8 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
        --batch 2 --prompt-len 16 --gen 8
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
    # supervised, with one injected dispatcher death, a JSONL session
    # store and the per-window output ledger (a SIGKILLed run resumes):
    PYTHONPATH=src python -m repro_torch.launch.serve --torr-streams 4 \\
        --torr-frames 10 --async --supervise --fault-at 5 \\
        --fault-kind dispatcher --state-store st.jsonl \\
        --outputs-jsonl out.jsonl
    # the network gateway on an ephemeral port, until SIGTERM:
    PYTHONPATH=src python -m repro_torch.launch.serve --gateway-port 0 \\
        --supervise

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

Fault tolerance (``--supervise`` / ``--state-store`` / ``--fault-at``)
=====================================================================

``--supervise`` (implied by ``--fault-at``, and implying ``--async``)
wraps the engine in a ``serving.supervisor.ServeSupervisor``: a worker
death rebuilds the engine (its graphs captured anew), re-admits every
stream warm from the session store and replays the windows no snapshot
covers. ``--state-store PATH`` makes that store a fsync'd JSONL file
(in memory otherwise), written every ``--snapshot-every`` served windows.
``--fault-at STEP --fault-kind dispatcher|collector`` injects one worker
death. ``--outputs-jsonl PATH`` appends one fsync'd record per resolved
window (stream, seq, best classes, scores digest); a supervised run that
was SIGKILLed and is run again with the same store skips each stream's
windows the store already covers (``resumed: skipped N windows``), so the
merged ledger equals a fault-free run's. A lost window exits 3.

Network gateway (``--gateway-port``)
====================================

``--gateway-port PORT`` (0 = ephemeral, printed in the ``listening``
line) serves ``serving.gateway.Gateway`` over the same engine stack
instead of synthetic streams: clients open ``tenant/stream`` sessions and
post packed windows over HTTP/1.1. ``--gateway-host/-rate/-burst/
-deadline-ms/-max-conns/-tenant-sessions`` set its limits,
``--gateway-seconds`` bounds the run, ``--gateway-sync`` drives the sync
engine through ``SyncDriver``. SIGINT/SIGTERM drains: stop accepting,
finish in-flight requests, write the artifacts, exit 0.

LM serving (``--arch``, when neither ``--torr-streams`` nor
``--gateway-port`` is given)
==========================================================================

``run_lm`` draws the architecture's weights (``--smoke``: its reduced
config) and a prompt of ``--batch`` x ``--prompt-len`` tokens from fixed
seeds, runs ``models.transformer.prefill`` and then ``--gen`` decode steps,
each sampling the next token by Gumbel-max at ``--temperature`` from a
seeded generator on the run's device (``jax.random.categorical`` cannot be
reproduced in torch). ``--rerank`` folds the TorR HDC reranker
(``serving.reranker.rerank_step``: the ``sign_project_pack`` and
``packed_hamming_batched`` kernels on the card) into every decode step's
logits from the previous step's hidden state, at ``TorrConfig(D=2048,
B=8, M=min(vocab, 256), K=8, N_max=batch, feat_dim=d_model)``; audio
models skip it, as the reference does. On the card the decode step is
replayed from a CUDA graph (``core.capture.GraphFamily``, keyed by the
config, the batch and the cache length), captured at the first step: the
counterpart of the reference's ``jax.jit``. Each replay copies the cache
into the graph's buffers and clones it out (every leaf of the nested
recurrent caches too; at xlstm-1.3b's full config and batch 4 its 42
mLSTM states C hold 2.82 GB). Every family of the registry serves: the
hybrid (``recurrentgemma-2b``: RG-LRU with a local-attention ring of
``sliding_window`` slots, which ``s_max`` does not size) and the ssm
(``xlstm-1.3b``: mLSTM and sLSTM; a prompt longer than ``mlstm_chunk``
must be a whole number of chunks) included. ``prefill`` under
``serve_quant="int8"`` returns the float cache as the reference's does,
so the launcher's decode there takes the float path; the int8 decode
starts from ``transformer.init_cache``.

``--mesh N`` shards the stream slots over the first N cards (-1: all; 0:
none), as ``repro``'s does over N devices, and implies ``--async``:
``AsyncStreamEngine(mesh=)`` pads the slots to a multiple of N and runs
one shard a card. N above the card count and ``--torr-serial`` with more
than one device are refused. With ``--device cpu`` it makes N CPU shards
(the counterpart of ``repro``'s N fake host devices): ``--torr-streams 6
--mesh 4`` serves 8 slots.
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


def stream_mesh_for(n: int, dev):
    """The stream mesh of ``--mesh n`` (None for 0): the first ``n`` cards
    (-1: all), or on the CPU ``n`` CPU shards."""
    from ..runtime import sharding as shd

    if n == 0:
        return None
    if dev.type == "cpu":
        if n < 0:
            raise ValueError("--mesh -1 counts cards; on the CPU give the "
                             "number of CPU shards")
        return shd.stream_mesh(devices=[dev] * n)
    return shd.stream_mesh(None if n < 0 else n)


def run_torr_streams(n_streams: int, n_frames: int, n_slots: int = 0,
                     serial: bool = False, use_async: bool = False,
                     mesh_devices: int = 0, rt: str = "",
                     governor: bool = False, fused: str | None = None,
                     metrics_port: int | None = None, metrics_json: str = "",
                     flight_jsonl: str = "", flight_capacity: int = 4096,
                     trace_json: str = "", supervise: bool = False,
                     state_store: str = "", snapshot_every: int = 1,
                     fault_at: int | None = None,
                     fault_kind: str = "dispatcher",
                     outputs_jsonl: str = "", device=None):
    """Serve S synthetic TOOD streams through the batched window engine.

    ``use_async`` routes through the dispatch/collect
    :class:`~repro_torch.serving.async_engine.AsyncStreamEngine`; ``rt``
    ("RT-30"/"RT-60") arms the deadline admission controller and
    ``governor`` the QoS loop (both imply the async runtime);
    ``mesh_devices`` shards the slots (:func:`stream_mesh_for`; implies the
    async runtime). ``fused`` picks the full
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
    the warm-up (the encode's and the served steps').

    Fault tolerance: ``supervise`` (implied by ``fault_at``, and implying
    the async runtime) wraps the engine in a
    :class:`~repro_torch.serving.supervisor.ServeSupervisor`;
    ``state_store`` points it at a JSONL session store (empty = in
    memory), written every ``snapshot_every`` served windows.
    ``fault_at``/``fault_kind`` inject one worker death; recovery replays
    the lost windows, and any lost window raises SystemExit(3).
    ``outputs_jsonl`` appends one fsync'd record per resolved window
    (stream, seq, best classes, scores digest); a supervised process
    killed mid-run resumes from its store, skipping each stream's windows
    the store already covers. With observability on, the returned dict
    also holds the supervisor's ``supervisor`` summary and
    ``resumed_skip``."""
    from ..data import tood_synth as ts
    from ..device import resolve_device
    from ..kernels import build, ops
    from ..runtime.fault import EngineDead
    from ..serving import tood_pipelines as tp
    from ..serving.stream_engine import StreamEngine

    supervise = supervise or fault_at is not None
    use_async = (use_async or bool(rt) or governor or supervise
                 or mesh_devices != 0)
    dev = resolve_device(device)
    mesh = stream_mesh_for(mesh_devices, dev)
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
    store, fault = _fault_plumbing(supervise, state_store, fault_at,
                                   fault_kind, registry)
    sup = None
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
        def make_engine():
            # the tracker and governor outlive rebuilds: their EMAs measure
            # the workload, not one engine; the FaultPlan fires once, so a
            # rebuilt engine runs clean
            return AsyncStreamEngine(
                cfg, sys_.im, n_slots=n_slots, serial=serial, fused=fused,
                mesh=mesh, tracker=tracker, governor=gov, paused=True,
                metrics=registry, flight=flight, tracer=tracer, store=store,
                snapshot_every=snapshot_every, fault_plan=fault, device=dev)

        if supervise:
            from ..serving.supervisor import ServeSupervisor
            sup = ServeSupervisor(make_engine, store, metrics=registry,
                                  flight=flight)
            eng = sup.engine
            if server is not None:
                server.set_ready(sup.health)    # /readyz mirrors recovery
        else:
            eng = make_engine()
    else:
        eng = StreamEngine(cfg, sys_.im, n_slots=n_slots, serial=serial,
                           fused=fused, metrics=registry, flight=flight,
                           tracer=tracer, store=store,
                           snapshot_every=snapshot_every, fault_plan=fault,
                           device=dev)
    front = sup if sup is not None else eng

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
    submitted = served = shed = resumed_skip = 0
    out_f = open(outputs_jsonl, "a", encoding="utf-8") \
        if outputs_jsonl else None
    out_lock = threading.Lock()

    def ledger_cb(sid, seq):
        # an async window's record is written as its future resolves (on
        # the collector), before that step's snapshot put, so a snapshot
        # covering a window implies its record is on disk: the resume
        # path's no-gap invariant
        def cb(fut):
            if fut.cancelled() or fut.exception() is not None:
                return
            with out_lock:
                _write_output(out_f, sid, seq, fut.result()[0])
        return cb

    interrupted = False
    engine_dead = None
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
            # (stream_id, words, valid, boxes, seq), in order
            windows = []
            for s in wave:
                task = s % n_tasks
                front.admit(f"stream{s}", sys_.task_w[task])
                frames = ts.simulate_sequence(world, task, n_frames, seed=s,
                                              n_max=cfg.N_max)
                # cross-process resume: the store already covers the first
                # latest_seq windows of this (deterministic) stream, which
                # a previous process served before it died
                skip = 0
                if sup is not None:
                    skip = min(store.latest_seq(f"stream{s}"), len(frames))
                    resumed_skip += skip
                frames = frames[skip:]
                if not frames:
                    continue
                feats = np.concatenate([f.feats for f in frames])
                words = ops.encode_packed(feats, R, device=dev)
                for t, f in enumerate(frames):
                    windows.append((f"stream{s}",
                                    words[t * cfg.N_max:(t + 1) * cfg.N_max],
                                    f.valid, f.boxes, skip + t))
            futures = []   # (future, valid-mask), submission order
            t0 = time.time()
            for sid, q, fvalid, fboxes, seq in windows:
                fut = front.submit(sid, q, fvalid, fboxes)
                submitted += 1
                if use_async:
                    if out_f is not None:
                        fut.add_done_callback(ledger_cb(sid, seq))
                    futures.append((fut, fvalid))
                else:
                    valids.append(fvalid)
            if use_async:
                from ..serving.deadline import WindowShed
                front.flush()
                t_total += time.time() - t0
                for fut, vmask in futures:
                    try:
                        _wout, tel = fut.result()
                    except WindowShed:
                        shed += 1
                        continue
                    except EngineDead:
                        continue    # lost: tallied by the zero-loss gate
                    served += 1
                    paths.append(np.asarray(tel.path))
                    valids.append(vmask)
            else:
                results = eng.drain()
                eng.sync()
                t_total += time.time() - t0
                for s in wave:
                    for seq, (wout, tel) in enumerate(
                            results[f"stream{s}"]):
                        served += 1
                        paths.append(tel.path.cpu().numpy())
                        if out_f is not None:
                            _write_output(out_f, f"stream{s}", seq, wout)
            for s in wave:
                front.retire(f"stream{s}")
    except KeyboardInterrupt:
        # SIGINT/SIGTERM (or a ^C): stop serving, but the artifact flush
        # below still runs on an interrupted run
        interrupted = True
        print("[serve/torr] interrupted: cancelling in-flight windows "
              "and flushing observability artifacts")
    except EngineDead as e:
        if sup is None:
            eng.close(drain=False)  # join the workers, then fail the run
            raise
        engine_dead = e         # terminal: the supervisor ran out of restarts
        print(f"[serve/torr] engine terminally dead: {e}")
    finally:
        if prev_handlers is not None:
            _restore_signal_handlers(prev_handlers)

    if sup is not None:
        try:
            sup.close(drain=not interrupted and engine_dead is None)
        except EngineDead:
            pass    # already counted as lost windows
        eng = sup.engine    # a recovery may have swapped the instance
    elif use_async:
        eng.close(drain=not interrupted)
    launches = {k: n - launches0.get(k, 0) for k, n in build.LAUNCHES.items()}
    mode = "async" if use_async else "sync"
    shards = "" if mesh is None else f" shards={len(mesh)}"
    print(f"[serve/torr] streams={n_streams} slots={eng.n_slots} "
          f"frames/stream={n_frames} mode={mode} device={dev}{shards}")
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
    sup_summary = None
    if sup is not None:
        sup_summary = sup.summary()
        print(f"[serve/torr] supervisor: restarts={sup_summary['restarts']} "
              f"replayed={sup_summary['windows_replayed']} "
              f"rerun={sup_summary['windows_rerun']} "
              f"degraded={sup_summary['degraded']}")
        if resumed_skip:
            print(f"[serve/torr] resumed: skipped {resumed_skip} windows "
                  "already covered by the state store")
    if lost:
        print(f"[serve/torr] LOST {lost} of {submitted} submitted windows")
    if out_f is not None:
        out_f.close()
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
        _close_store(store)
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
              "lost": lost, "steps": eng.stats.steps, "launches": launches,
              "supervisor": sup_summary, "resumed_skip": resumed_skip}
    _close_store(store)
    if lost:
        raise SystemExit(3)
    return result


def run_torr_gateway(n_slots: int = 8, serial: bool = False, rt: str = "",
                     governor: bool = False, fused: str | None = None,
                     metrics_port: int | None = None, metrics_json: str = "",
                     flight_jsonl: str = "", flight_capacity: int = 4096,
                     trace_json: str = "", supervise: bool = False,
                     state_store: str = "", snapshot_every: int = 1,
                     fault_at: int | None = None,
                     fault_kind: str = "dispatcher",
                     gateway_port: int = 0, gateway_host: str = "127.0.0.1",
                     gateway_rate: float = 200.0, gateway_burst: int = 100,
                     gateway_deadline_ms: float = 2000.0,
                     gateway_max_conns: int = 64,
                     gateway_tenant_sessions: int = 8,
                     run_seconds: float = 0.0, use_async: bool = True,
                     mesh_devices: int = 0, device=None):
    """Serve the TorR engine behind the network gateway until SIGTERM.

    The same engine stack as :func:`run_torr_streams` (config, synthetic
    TOOD world, observability, state store, chaos plan, supervisor), but
    instead of driving synthetic streams in-process, a
    :class:`~repro_torch.serving.gateway.Gateway` listens on
    ``gateway_host:gateway_port`` (0 = ephemeral, printed as a
    ``listening`` line once the socket accepts) and clients open tenant
    sessions over real sockets. SIGINT/SIGTERM triggers the graceful
    drain: stop accepting, finish in-flight requests, close the engine,
    write every armed artifact, exit 0. ``run_seconds > 0`` bounds the
    serve window; 0 serves until a signal arrives. ``use_async=False``
    drives the sync engine through the
    :class:`~repro_torch.serving.gateway.SyncDriver`. The engine runs on
    ``device`` (the card by default), its slots sharded as
    ``mesh_devices`` says (:func:`stream_mesh_for`; the async runtime
    only), and a supervisor's rebuilt engine is sharded again."""
    from ..data import tood_synth as ts
    from ..device import resolve_device
    from ..runtime.fault import EngineDead
    from ..serving import tood_pipelines as tp
    from ..serving.gateway import Gateway, GatewayLimits, SyncDriver

    supervise = supervise or fault_at is not None
    use_async = use_async or bool(rt) or governor or supervise
    if mesh_devices != 0 and not use_async:
        raise ValueError("a mesh shards the async runtime; it cannot drive "
                         "the sync engine")
    dev = resolve_device(device)
    mesh = stream_mesh_for(mesh_devices, dev)
    cfg = TorrConfig(**SERVE_CFG)
    world = ts.make_world(0, M=cfg.M, d=cfg.feat_dim)
    sys_ = tp.build_system(world, cfg, torch.Generator().manual_seed(0))

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
            print(f"[serve/gateway] metrics endpoint "
                  f"http://127.0.0.1:{server.start()}/metrics")
    store, fault = _fault_plumbing(supervise, state_store, fault_at,
                                   fault_kind, registry)
    sup = driver = None
    if use_async:
        from ..serving.async_engine import AsyncStreamEngine
        from ..serving.deadline import DeadlineTracker, policy_for
        if governor and not rt:
            rt = "RT-60"
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

        def make_engine():
            return AsyncStreamEngine(
                cfg, sys_.im, n_slots=n_slots, serial=serial, fused=fused,
                mesh=mesh, tracker=tracker, governor=gov, paused=True,
                metrics=registry, flight=flight, tracer=tracer, store=store,
                snapshot_every=snapshot_every, fault_plan=fault, device=dev)

        if supervise:
            from ..serving.supervisor import ServeSupervisor
            sup = ServeSupervisor(make_engine, store, metrics=registry,
                                  flight=flight)
            eng = sup.engine
            if server is not None:
                server.set_ready(sup.health)
        else:
            eng = make_engine()
        front = sup if sup is not None else eng
    else:
        from ..serving.stream_engine import StreamEngine
        eng = StreamEngine(cfg, sys_.im, n_slots=n_slots, serial=serial,
                           fused=fused, metrics=registry, flight=flight,
                           tracer=tracer, store=store,
                           snapshot_every=snapshot_every, fault_plan=fault,
                           device=dev)
        driver = SyncDriver(eng, metrics=registry)
        front = driver

    eng.warmup()
    if use_async:
        eng.start()

    limits = GatewayLimits(
        rate_per_s=gateway_rate, burst=gateway_burst,
        request_deadline_s=gateway_deadline_ms / 1e3,
        max_connections=gateway_max_conns,
        max_sessions_per_tenant=gateway_tenant_sessions)
    gw = Gateway(front, cfg, sys_.task_w, limits=limits,
                 host=gateway_host, port=gateway_port,
                 metrics=registry, flight=flight)
    if server is not None and sup is None:
        server.set_ready(gw._front_health)

    interrupted = False
    prev_handlers = None
    try:
        prev_handlers = _install_signal_handlers()
        gw.start()
        # the handshake line: printed only once the socket accepts
        print(f"[serve/gateway] listening on "
              f"http://{gateway_host}:{gw.port} "
              f"(SIGINT/SIGTERM drains and flushes artifacts) "
              f"device={dev}", flush=True)
        t_end = None if run_seconds <= 0 else time.time() + run_seconds
        while t_end is None or time.time() < t_end:
            time.sleep(0.2)
    except KeyboardInterrupt:
        interrupted = True
        print("[serve/gateway] signal received: draining", flush=True)
    finally:
        if prev_handlers is not None:
            _restore_signal_handlers(prev_handlers)

    drained = gw.drain(timeout=max(10.0, 2 * limits.request_deadline_s))
    gw.close()
    summary = gw.summary()
    print(f"[serve/gateway] drained={drained} sessions={summary['sessions']}")
    if sup is not None:
        try:
            sup.close(drain=False)
        except EngineDead:
            pass
        eng = sup.engine
        s = sup.summary()
        print(f"[serve/gateway] supervisor: restarts={s['restarts']} "
              f"replayed={s['windows_replayed']} rerun={s['windows_rerun']} "
              f"degraded={s['degraded']}")
    elif driver is not None:
        driver.close()
    else:
        try:
            eng.close(drain=False)
        except EngineDead:
            pass

    if registry is not None:
        eng.flush_telemetry()
        if server is not None:
            server.close()
        if metrics_json:
            from ..obs import write_json_snapshot
            write_json_snapshot(registry, metrics_json)
            print(f"[serve/gateway] metrics snapshot -> {metrics_json}")
        if flight_jsonl:
            n_rec = flight.dump_jsonl(flight_jsonl)
            print(f"[serve/gateway] flight recorder: {n_rec} records -> "
                  f"{flight_jsonl}")
        if trace_json:
            from ..obs import write_chrome_trace
            n_ev = write_chrome_trace(flight.records(), trace_json)
            print(f"[serve/gateway] chrome trace: {n_ev} events -> "
                  f"{trace_json}")
    _close_store(store)
    print(f"[serve/gateway] exit 0 (interrupted={interrupted})", flush=True)
    return {"registry": registry, "flight": flight, "drained": drained,
            "summary": summary,
            "supervisor": sup.summary() if sup is not None else None}


def _fault_plumbing(supervise, state_store, fault_at, fault_kind, registry):
    """The session store (JSONL at ``state_store``, else in memory when
    supervising, else None) and the chaos plan (None without
    ``fault_at``). The plan is shared by every rebuilt engine: it fires
    once, so a replacement engine runs clean."""
    store = fault = None
    if supervise or state_store:
        from ..serving.state_store import (InMemoryStateStore,
                                           JsonlStateStore)
        store = (JsonlStateStore(state_store, metrics=registry)
                 if state_store else InMemoryStateStore(metrics=registry))
    if fault_at is not None:
        from ..runtime.fault import FaultPlan
        fault = FaultPlan(at_step=fault_at, thread=fault_kind,
                          kind=fault_kind)
    return store, fault


def _close_store(store) -> None:
    if store is not None and hasattr(store, "close"):
        store.close()


def _write_output(f, sid, seq, wout) -> None:
    """Append one resolved window's output record, fsync'd (the SIGKILL
    recovery check diffs these ledgers across runs, so a record must
    never be half-written): the stream, its seq, and the gateway's
    response body for the window (best classes and the scores' digest)."""
    import json
    import os

    from ..serving.protocol import window_result_body

    rec = {"stream": sid, **window_result_body(seq, wout)}
    f.write(json.dumps(rec) + "\n")
    f.flush()
    os.fsync(f.fileno())


LM_DECODE = "lm_decode"      # the decode step's graph key


def _decode_segment(params, cfg, names):
    """The decode step as a function of tensors alone (the cache's leaves
    in ``names`` order, the tokens), for the graph family: it returns the
    leaves it updated in place, the logits and the hidden state."""
    from ..models import transformer as tf

    def step(leaves, tokens):
        cache, logits, hidden = tf.decode_step(
            params, dict(zip(names, leaves)), tokens, cfg,
            return_hidden=True)
        return tuple(cache[n] for n in names), logits, hidden

    return step


def sample(logits: torch.Tensor, temperature: float,
           generator: torch.Generator) -> torch.Tensor:
    """Gumbel-max: argmax(logits / temperature + g), g = -log(-log(u)) for
    uniforms u drawn from ``generator`` on the logits' device."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits / temperature - torch.log(-torch.log(u)),
                        dim=-1)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_lm(arch: str = "musicgen-large", smoke: bool = False,
           batch: int = 4, prompt_len: int = 32, gen: int = 32,
           rerank: bool = False, temperature: float = 0.8, device=None,
           jit: bool = True, record: bool = False) -> dict:
    """Batched prefill + ``gen`` decode steps of the registry's ``arch``
    with the optional reranker; prints the reference's ``[serve]`` lines
    and returns the results.

    The step after the first is timed: the first (``first_step_ms``)
    captures the decode graph on the card. ``launches`` counts the hand-
    written kernels from the second step to the end. ``record`` keeps each
    step's decode logits and hidden state (``steps``) for replays."""
    from ..configs import get, get_smoke
    from ..core import capture
    from ..device import resolve_device
    from ..kernels import build
    from ..models import transformer as tf
    from ..serving import reranker as rr

    dev = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get(arch)
    params = tf.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    B, S = batch, prompt_len
    rng = np.random.default_rng(0)
    shape = (B, S, cfg.n_codebooks) if cfg.family == "audio" else (B, S)
    prompt = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, shape).astype(np.int32)).to(dev)}
    if cfg.family == "vlm":
        prompt["vision"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.vision_dim)).astype(np.float32)
        ).to(dev, torch.bfloat16)

    _sync(dev)
    t0 = time.perf_counter()
    s_max = S + 64            # prefill's default: room for 64 tokens
    cache, logits = tf.prefill(params, prompt, cfg, s_max=s_max)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3

    reranking = rerank and cfg.family != "audio"
    if reranking:
        rcfg = TorrConfig(D=2048, B=8, M=min(cfg.vocab, 256), K=8,
                          N_max=B, feat_dim=cfg.d_model)
        rparams, rim = rr.init_reranker(
            rcfg, cfg.d_model, cfg.vocab, alpha=0.5,
            generator=torch.Generator().manual_seed(7))
        rparams, rim = rparams.to(dev), rim.to(dev)
        rstate = rr.init_state(rcfg, B, dev)

    graphs = (capture.GraphFamily() if jit and dev.type == "cuda"
              else capture.EAGER)
    names = tuple(cache)
    step = _decode_segment(params, cfg, names)
    key = (LM_DECODE, cfg, B, s_max)
    sampler = torch.Generator(dev).manual_seed(1)
    generated, bypassed, steps = [], [], []
    hidden = None
    t0 = time.perf_counter()
    for i in range(gen):
        if i == 1:
            _sync(dev)
            t1 = time.perf_counter()
            before = dict(build.LAUNCHES)
        if reranking and hidden is not None:
            logits, rstate, tel = rr.rerank_step(rparams, rstate, rim,
                                                 hidden, logits, rcfg)
            bypassed.append(tel["bypassed"])
        nxt = sample(logits, temperature, sampler)
        generated.append(nxt)
        leaves, logits, hidden = graphs.run(
            key, step, (tuple(cache[n] for n in names), nxt))
        cache = dict(zip(names, leaves))
        if record:
            steps.append((logits, hidden))
    _sync(dev)
    t_end = time.perf_counter()
    first_ms = ((t1 if gen > 1 else t_end) - t0) * 1e3
    steady = gen - 1
    decode_ms = (t_end - t1) * 1e3 / steady if steady else float("nan")
    launches = ({k: n - before[k] for k, n in build.LAUNCHES.items()}
                if steady else {k: 0 for k in build.LAUNCHES})
    bypass_rate = (float(torch.stack(bypassed).float().mean())
                   if bypassed else None)
    out = torch.stack(generated, dim=1).cpu().numpy()

    print(f"[serve] arch={cfg.name} batch={B} prompt={S} gen={gen} "
          f"device={dev.type}")
    mode = "eager" if graphs is capture.EAGER else "captured"
    print(f"[serve] prefill {prefill_ms:.1f} ms; decode {decode_ms:.1f} "
          f"ms/token ({B * 1e3 / decode_ms:.1f} tok/s, {mode}); first step "
          f"{first_ms:.1f} ms")
    if bypass_rate is not None:
        print(f"[serve] reranker bypass rate: {bypass_rate:.2f}")
    print(f"[serve] generated shape {out.shape}, sample: "
          f"{out[0].ravel()[:16]}")
    return dict(cfg=cfg, device=dev, tokens=out, prefill_ms=prefill_ms,
                first_step_ms=first_ms, decode_ms_per_token=decode_ms,
                tok_s=B * 1e3 / decode_ms, bypass_rate=bypass_rate,
                launches=launches, params=params, prompt=prompt, cache=cache,
                steps=steps, graphs=graphs)


def _check_lm_args(ap, args) -> None:
    """A full config only on the card: the CPU serves the smoke configs (a
    full one holds GBs of weights)."""
    from ..configs import get

    if args.device == "cpu" and not args.smoke:
        n = get(args.arch).param_count()
        ap.error(f"--arch {args.arch} at its full config holds {n / 1e9:.1f}"
                 f"B weights: pass --smoke to serve it on the CPU, or run "
                 f"on the card")


def _check_mesh_args(ap, args) -> None:
    """Refuse ``--mesh N`` above the card count (on the card) and
    ``--torr-serial`` over more than one device."""
    if args.mesh == 0:
        return
    if args.mesh < -1:
        ap.error(f"--mesh {args.mesh}: N >= 1, 0 (none) or -1 (all cards)")
    on_cpu = args.device is not None and \
        torch.device(args.device).type == "cpu"
    if not on_cpu:
        cards = torch.cuda.device_count()
        if args.mesh > cards:
            ap.error(f"--mesh {args.mesh}: requested {args.mesh} devices, "
                     f"only {cards} present")
        n = cards if args.mesh < 0 else args.mesh
    else:
        n = args.mesh
    if n > 1 and args.torr_serial:
        ap.error("--torr-serial runs the slots one after another and cannot "
                 "shard them; drop it or --mesh")


def main(argv=None) -> None:
    from ..configs import ARCHS

    ap = argparse.ArgumentParser(
        description="Serve an LM (prefill + decode, optionally reranked) "
                    "or synthetic TOOD streams through the port's TorR "
                    "window engine.")
    ap.add_argument("--arch", default="musicgen-large", choices=sorted(ARCHS),
                    help="the LM to serve when neither --torr-streams nor "
                         "--gateway-port is given (a registry name)")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--rerank", action="store_true",
                    help="fold the TorR HDC reranker into each decode "
                         "step's logits (not for audio)")
    ap.add_argument("--temperature", type=float, default=0.8)
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
                    help="shard stream slots over the first N cards, -1 = "
                         "all (implies --async; default 0 = no sharding; "
                         "with --device cpu, N CPU shards)")
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
    ap.add_argument("--supervise", action="store_true",
                    help="wrap the engine in a ServeSupervisor: worker "
                         "death rebuilds the engine, re-admits streams warm "
                         "from the state store and replays in-flight "
                         "windows (implies --async)")
    ap.add_argument("--state-store", default="", metavar="PATH",
                    help="file-backed JSONL session store (a SIGKILLed run "
                         "resumes from it); default with --supervise is "
                         "in memory")
    ap.add_argument("--snapshot-every", type=int, default=1, metavar="N",
                    help="write a stream's session snapshot through every "
                         "N served windows (default 1)")
    ap.add_argument("--fault-at", type=int, default=None, metavar="STEP",
                    help="chaos harness: kill the engine worker at this "
                         "dispatched-step index (implies --supervise)")
    ap.add_argument("--fault-kind", default="dispatcher",
                    choices=["dispatcher", "collector"],
                    help="which worker thread the injected fault kills "
                         "(default dispatcher)")
    ap.add_argument("--outputs-jsonl", default="", metavar="PATH",
                    help="append one fsync'd record per resolved window "
                         "(stream, seq, best classes, scores digest)")
    ap.add_argument("--gateway-port", type=int, default=None, metavar="PORT",
                    help="serve the network gateway on this port (0 = "
                         "ephemeral, printed at startup) instead of "
                         "driving synthetic streams in-process; runs until "
                         "SIGTERM, then drains")
    ap.add_argument("--gateway-host", default="127.0.0.1")
    ap.add_argument("--gateway-rate", type=float, default=200.0,
                    metavar="N", help="per-tenant token-bucket refill "
                    "rate, windows/s (default 200)")
    ap.add_argument("--gateway-burst", type=int, default=100, metavar="N",
                    help="per-tenant token-bucket depth (default 100)")
    ap.add_argument("--gateway-deadline-ms", type=float, default=2000.0,
                    metavar="MS", help="default per-request wait budget "
                    "before a window parks with 503 (default 2000)")
    ap.add_argument("--gateway-max-conns", type=int, default=64, metavar="N")
    ap.add_argument("--gateway-tenant-sessions", type=int, default=8,
                    metavar="N", help="per-tenant session quota (default 8)")
    ap.add_argument("--gateway-seconds", type=float, default=0.0,
                    metavar="S", help="bound the serve window (0 = until "
                    "a signal)")
    ap.add_argument("--gateway-sync", action="store_true",
                    help="drive the sync StreamEngine through the "
                         "SyncDriver instead of the async runtime "
                         "(incompatible with --rt/--governor/--supervise)")
    ap.add_argument("--device", default=None,
                    help="where the engine runs (default: the card; cpu "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    _check_mesh_args(ap, args)
    if args.gateway_port is not None:
        run_torr_gateway(
            n_slots=args.torr_slots or 8, serial=args.torr_serial,
            rt=args.rt, governor=args.governor,
            fused=args.torr_fused or None,
            metrics_port=args.metrics_port, metrics_json=args.metrics_json,
            flight_jsonl=args.flight_jsonl,
            flight_capacity=args.flight_capacity,
            trace_json=args.trace_json, supervise=args.supervise,
            state_store=args.state_store,
            snapshot_every=args.snapshot_every, fault_at=args.fault_at,
            fault_kind=args.fault_kind, gateway_port=args.gateway_port,
            gateway_host=args.gateway_host, gateway_rate=args.gateway_rate,
            gateway_burst=args.gateway_burst,
            gateway_deadline_ms=args.gateway_deadline_ms,
            gateway_max_conns=args.gateway_max_conns,
            gateway_tenant_sessions=args.gateway_tenant_sessions,
            run_seconds=args.gateway_seconds,
            use_async=not args.gateway_sync, mesh_devices=args.mesh,
            device=args.device)
        return
    if args.torr_streams <= 0:
        _check_lm_args(ap, args)
        run_lm(args.arch, smoke=args.smoke, batch=args.batch,
               prompt_len=args.prompt_len, gen=args.gen, rerank=args.rerank,
               temperature=args.temperature, device=args.device)
        return
    run_torr_streams(args.torr_streams, args.torr_frames, args.torr_slots,
                     serial=args.torr_serial, use_async=args.use_async,
                     mesh_devices=args.mesh, rt=args.rt,
                     governor=args.governor, fused=args.torr_fused or None,
                     metrics_port=args.metrics_port,
                     metrics_json=args.metrics_json,
                     flight_jsonl=args.flight_jsonl,
                     flight_capacity=args.flight_capacity,
                     trace_json=args.trace_json, supervise=args.supervise,
                     state_store=args.state_store,
                     snapshot_every=args.snapshot_every,
                     fault_at=args.fault_at, fault_kind=args.fault_kind,
                     outputs_jsonl=args.outputs_jsonl, device=args.device)


if __name__ == "__main__":
    main()
