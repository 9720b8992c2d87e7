"""Serving layer of the port: evaluation pipelines, the multi-stream
engine, its async runtime, fault tolerance and the network gateway (the
module map of ``repro.serving``, on one card).

Modules:

  * ``tood_pipelines``: dense / naive-HDC / TorR evaluation pipelines over
    the synthetic TOOD world (single stream, one window per call).
  * ``stream_engine``: the multi-stream batched window engine. API
    sketch::

        eng = StreamEngine(cfg, im, n_slots=16)   # on the card
        eng.admit("cam0", task_w0)          # bind stream -> slot, reset cache
        eng.submit("cam0", q_packed, valid, boxes)   # enqueue one window
        results = eng.step()                # one torr_multi_stream_step
        out, telemetry = results["cam0"]    # per-stream WindowOutput/telemetry
        eng.retire("cam0")                  # free the slot

    ``step()`` batches one pending window per admitted stream into a
    padded :class:`~repro_torch.core.types.StreamBatch`; each step segment
    replays a CUDA graph captured once per static key (``jit=True``).
  * ``async_engine``: the asynchronous serving runtime: the same slot
    contract behind a dispatch/collect thread split. API sketch::

        with AsyncStreamEngine(cfg, im, n_slots=16,
                               tracker=DeadlineTracker(policy_for("RT-60")),
                               ) as eng:                    # optional
            eng.admit("cam0", task_w0)
            fut = eng.submit("cam0", q_packed, valid, boxes)
            out, telemetry = fut.result()   # host-resident numpy trees
            eng.flush(); eng.retire("cam0")

    Host window assembly overlaps device steps; futures resolve from a
    collector thread; with admission control armed, late windows raise
    ``WindowShed`` instead of resolving.
  * ``deadline``: RT-30/RT-60 admission control: the pure decision table
    (admit / bypass-escalate / shed) and the tracker that projects window
    completion and emits cycle-model-compatible jitter/miss telemetry;
    ``WindowShed`` carries a ``retry_after_s`` hint.
  * ``state_store``: externalized per-stream session state: either
    engine snapshots a stream's cache rows and task weights into a
    pluggable :class:`~repro_torch.serving.state_store.StateStore`
    (in-memory or JSONL, ``repro``'s schema v1, so either package's file
    warm-starts the other's engine) every ``snapshot_every`` served
    windows, off the hot path; ``admit`` accepts a
    :class:`~repro_torch.serving.state_store.StreamSnapshot` for a warm
    start that is bit-identical to never having lost the slot.
  * ``supervisor``: fault-tolerant front-end over either engine::

        sup = ServeSupervisor(lambda: AsyncStreamEngine(..., store=store,
                                                        paused=True),
                              store)
        sup.admit("cam0", task_w0)          # warm-starts from the store
        fut = sup.submit("cam0", q, valid, boxes)
        sup.flush()                         # survives EngineDead: rebuild,
                                            # re-admit, replay, resolve

    On :class:`~repro_torch.runtime.fault.EngineDead` the supervisor
    rebuilds the engine from its factory (which captures its graphs
    anew), re-admits every stream from its latest snapshot and replays
    the uncovered journal suffix: recovered outputs are bit-identical to
    a fault-free run. A crash-loop breaker degrades the knob plan;
    bounded restarts fail pending futures with the terminal
    ``EngineDead``.
  * ``gateway`` / ``protocol``: the network tier: a stdlib threaded
    socket/HTTP front mapping multi-tenant ``tenant/stream`` sessions to
    engine slots, with per-tenant token-bucket rate limits, strict frame
    validation, seq-based idempotent retries, recovery-aware 503s and
    graceful drain::

        gw = Gateway(sup, cfg, task_bank, metrics=reg, port=0)
        gw.start()                  # POST /v1/session, POST /v1/window,
                                    # /healthz /readyz /metrics /v1/config
        gw.drain()                  # SIGTERM path: flush in-flight, exit 0

    Every failure mode is a typed client outcome (400/408/409/413/429/503
    + Retry-After); the error taxonomy and wire schema live in
    ``protocol.py``. ``SyncDriver`` adapts the sync ``StreamEngine`` to
    the future-returning submit surface the gateway needs.

Chaos injection: both engines accept a
:class:`~repro_torch.runtime.fault.FaultPlan` (``fault_plan=``) that kills
the dispatcher or collector at a chosen step exactly once: the
deterministic harness behind ``repro_torch.launch.serve
--fault-at/--fault-kind`` and the recovery tests.
"""
