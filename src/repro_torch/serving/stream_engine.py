"""Multi-stream batched window engine: slot scheduler over the batched step
(port of ``repro.serving.stream_engine``).

S independent streams are served through one ``torr_multi_stream_step`` per
``step()``: streams are admitted into fixed slots, each slot owns a stacked
row of ``TorrState`` (its query cache and task weights), and every step
drains one window per busy slot as a padded :class:`StreamBatch`.

Scheduling contract:

  * ``admit(stream_id, task_w)`` binds a stream to a free slot and resets
    that slot's cache (no cross-stream reuse leaks).
  * ``submit(stream_id, q_packed, valid, boxes)`` enqueues one window.
  * ``step()`` pops the head window of every busy slot, pads idle slots
    (valid all-False: the pipeline's pad branch leaves their cache
    untouched), and returns {stream_id: (WindowOutput, WindowTelemetry)}.
    A stream's ``queue_depth`` is its remaining backlog after the pop, so
    Alg. 1's per-stream load gating sees true per-stream pressure.
  * ``retire(stream_id)`` drops the stream's remaining backlog and frees
    the slot; admission asserts the recycled slot's queue is empty.

A step is ``_assemble`` (pop the head windows into one padded batch, under
an optional admission gate) then ``_dispatch`` (move the batch to the
device and launch the step), as in ``repro``; the async engine runs the
two on its dispatcher thread. A window stays where it was submitted:
numpy arrays and CPU tensors on the host, where ``_assemble`` writes them
into host buffers (pinned on the card, reused through the caching host
allocator) that ``_dispatch`` copies to the card once per leaf without a
wait; tensors on the card (the
encode's output) are gathered there with one stack per leaf. ``submit``
itself makes no device call.

``set_plan(plan)`` latches a :class:`~repro_torch.control.plan.KnobPlan`
(D' cap, bit-slice planes, tau offsets) for every later step, on every
lowering; ``set_plan(None)`` returns to the uncontrolled step.

``fused="auto"`` arms the load-aware kernel dispatch: every step the engine
folds an earlier step's full-path fraction into an EWMA and picks between
the hoisted lowering default and the reuse-aware compact dispatch
(``fused="compact"`` with a ``core.policy.bucket_ladder`` tier sized to the
predicted miss count). Every choice is bit-identical (compact overflow falls
back exactly), so auto is purely a scheduling knob.

Observability (``repro_torch.obs``): ``metrics=`` (a ``MetricsRegistry``)
and ``flight=`` (a ``FlightRecorder``) attach a ``StepObserver``;
``tracer=`` (a ``Tracer``) mints a per-window trace context at ``submit``.
The step's telemetry is folded one step late (the deferred fold): it is
copied to the host on a side stream that waits for that step alone, so the
host never waits for the step it just launched. ``fault_plan=`` (a
``runtime.fault.FaultPlan``) fires at the step boundaries.

``jit=True`` (the default, where ``repro`` has it) runs the step through
the engine's :class:`~repro_torch.core.capture.GraphFamily`: each static
key of a step segment (lowering, plan, bucket tier, decide pass, and the
compact overflow or the switch bank choice read on the host) is captured
once in a CUDA graph and replayed on every later step with that key;
``warmup()`` captures the current key. ``jit=False`` runs the same step
eagerly on the card, the comparison. On the CPU there is no graph and
``jit=True`` runs the eager step, the plain path there. A capture or
replay error raises; nothing falls back to the eager step.

The engine runs on ``cuda`` unless constructed with ``device="cpu"``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict

import numpy as np
import torch

from ..core import capture, pipeline, policy, query_cache
from ..core.item_memory import ItemMemory
from ..core.pipeline import TorrState, WindowOutput
from ..core.types import (PATH_FULL, StreamBatch, TorrConfig,
                          WindowTelemetry, map_tensors)
from ..device import resolve_device
from ..obs.bridge import StepObserver, telemetry_digest
from ..obs.spans import NULL_SPAN, span
from ..obs.trace import now_us, trace_scope

# admission-gate verdicts for `_assemble(gate=...)`; values align with
# `serving.deadline.Decision` (an IntEnum) so trackers can be used as gates
# without this module importing the deadline layer
GATE_ADMIT, GATE_ESCALATE, GATE_SHED = 0, 1, 2

# load-aware fused="auto" dispatch: EWMA weight of the newest folded step's
# full-path fraction, and the headroom the predicted full count is padded
# by before rounding up to a bucket-ladder tier (a mispredict is never
# wrong, since the compact dispatch falls back exactly on overflow, but the
# fallback rescans every row)
AUTO_ALPHA = 0.3
AUTO_HEADROOM = 2.0


@dataclasses.dataclass
class EngineStats:
    """Counters for the batched engine (host side)."""

    steps: int = 0
    windows: int = 0          # non-pad windows processed
    pad_slots: int = 0        # idle slot-steps (wasted lanes)
    admitted: int = 0
    retired: int = 0
    dropped: int = 0          # backlog windows discarded by retire()
    shed: int = 0             # windows shed by RT admission control
    telemetry_dropped: int = 0  # observed windows lost before the fold
                                # (futures cancelled mid-flight, collector
                                # drain on worker death)

    @property
    def occupancy(self) -> float:
        total = self.windows + self.pad_slots
        return self.windows / total if total else 0.0


def _host_words(x) -> np.ndarray:
    """Packed words as int32 bit patterns (numpy uint32, ``repro``'s dtype,
    is reinterpreted bit for bit)."""
    x = np.asarray(x)
    if x.dtype == np.uint32:
        return x.view(np.int32)
    if x.dtype != np.int32:
        raise TypeError(f"packed words must be int32 (or numpy uint32), "
                        f"got {x.dtype}")
    return x


def window_leaves(device, q_packed, valid, boxes) -> tuple:
    """One submitted window as (words, valid, boxes): a tensor already on
    the engine's card stays there, anything else becomes a host array."""
    def leaf(x, dtype, host):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda" and device.type == "cuda":
                if x.dtype != dtype:
                    raise TypeError(f"window leaf must be {dtype}, got "
                                    f"{x.dtype}")
                return x
            x = x.cpu().numpy()
        return host(x)
    return (leaf(q_packed, torch.int32, _host_words),
            leaf(valid, torch.bool, lambda a: np.asarray(a, bool)),
            leaf(boxes, torch.float32, lambda a: np.asarray(a, np.float32)))


class StreamEngine:
    """Fixed-slot scheduler feeding ``torr_multi_stream_step``."""

    # engine family stamped into minted trace contexts (async overrides)
    _ENGINE = "sync"

    def __init__(self, cfg: TorrConfig, im: ItemMemory, n_slots: int = 16,
                 jit: bool = True, serial: bool = False,
                 fused: str | None = None, bucket_cap: int | None = None,
                 decide: str | None = None, metrics=None, flight=None,
                 tracer=None, fault_plan=None, *, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.im = im.to(self.device)
        self.n_slots = n_slots
        # the step's captured graphs (None: the eager step, on the CPU
        # always); the state is each replay's output and the next's input
        self.graphs = (capture.GraphFamily()
                       if jit and self.device.type == "cuda" else None)
        # `serial` runs the slots one after another through the
        # single-window step; `fused` picks the full path's lowering (None
        # = the lowering's default, "off" = the per-proposal oracle,
        # "auto" = the load-aware compact-vs-hoisted choice per step);
        # `bucket_cap` and `decide` configure the compact dispatch
        self._serial = serial
        self._auto = fused == "auto"
        self._fused = None if self._auto else fused
        self._bucket_cap = bucket_cap
        self._decide = decide
        self._plan = None          # the latched KnobPlan (None = uncontrolled)
        # full-path fraction EWMA; starts pessimistic (a cold cache makes
        # every proposal a miss), so auto begins on the hoisted lowering.
        # The backlog holds (tel, flight record, trace contexts, ready
        # event) of dispatched steps; only entries at least one dispatch
        # old are folded while serving (see _fold_telemetry)
        self._full_ewma = 1.0
        self._tel_backlog: collections.deque = collections.deque()
        self._state: TorrState = pipeline.init_multi_stream_state(
            cfg, torch.zeros((n_slots, cfg.M)), self.device)
        self._pending = [collections.deque() for _ in range(n_slots)]
        self._slot_of: Dict[object, int] = {}
        self._free = list(range(n_slots - 1, -1, -1))
        self.stats = EngineStats()
        # observability: a registry and/or flight recorder attach a
        # StepObserver; without either the engine pays nothing but
        # NULL_SPAN's empty context managers
        self._obs = (StepObserver(metrics, flight)
                     if metrics is not None or flight is not None else None)
        self._tracer = tracer
        self._step_ctxs = None  # live ctx list while a traced step assembles
        sp = (lambda name: span(name, metrics)) \
            if metrics is not None or tracer is not None \
            else (lambda name: NULL_SPAN)
        self._sp_assemble = sp("host_assemble")
        self._sp_dispatch = sp("dispatch_enqueue")
        self._sp_observe = sp("host_observe")
        self._last_resolved = (self._fused, self._bucket_cap, self._decide)
        self._fault = fault_plan
        S, N = n_slots, cfg.N_max
        self._staging_shapes = (((S, N, cfg.words), torch.int32),
                                ((S, N), torch.bool),
                                ((S, N, 4), torch.float32),
                                ((S,), torch.int32))
        self._pad = None           # per-leaf pad lanes on the card
        # the side stream of the device-to-host copies
        self._copy_stream = None

    @property
    def state(self) -> TorrState:
        return self._state

    # -- admission control --------------------------------------------------

    def admit(self, stream_id, task_w) -> int:
        """Bind a stream to a free slot; returns the slot index."""
        if stream_id in self._slot_of:
            raise ValueError(f"stream {stream_id!r} already admitted")
        if not self._free:
            raise RuntimeError("no free stream slots; retire a stream first")
        slot = self._free.pop()
        # retire() drops a stream's un-popped backlog with the slot, so a
        # recycled slot must come back empty
        assert not self._pending[slot], (
            f"slot {slot} re-admitted with {len(self._pending[slot])} leaked "
            "backlog windows; retire() must drop them")
        self._slot_of[stream_id] = slot
        task_weights = self._state.task_weights.clone()
        task_weights[slot] = torch.as_tensor(task_w, dtype=torch.float32)
        self._state = TorrState(
            cache=query_cache.reset_slot(self._state.cache, self.cfg, slot),
            task_weights=task_weights,
        )
        self.stats.admitted += 1
        if self._obs is not None:
            self._obs.on_admit()
        return slot

    def retire(self, stream_id) -> None:
        """Release a stream's slot, dropping any un-popped backlog."""
        slot = self._slot_of.pop(stream_id)
        n_dropped = len(self._pending[slot])
        self.stats.dropped += n_dropped
        self._pending[slot].clear()
        self._free.append(slot)
        self.stats.retired += 1
        if self._obs is not None:
            self._obs.on_retire(n_dropped)

    # -- window flow --------------------------------------------------------

    def submit(self, stream_id, q_packed, valid, boxes) -> None:
        """Enqueue one window (packed queries, validity, boxes) for a
        stream. Host arrays stay on the host until the step that serves
        them; with a tracer armed, a per-window trace context is minted
        here (the window's admission timestamp) and rides the window."""
        slot = self._slot_of[stream_id]
        window = window_leaves(self.device, q_packed, valid, boxes)
        if self._tracer is not None:
            window += (self._tracer.mint(stream_id, self._ENGINE),)
        self._pending[slot].append(window)

    @staticmethod
    def _ctx_of(extra):
        """The window's TraceContext from ``submit``'s trailing payload
        (None when untraced). The async engine overrides: its payload
        carries (future, arrival, ctx)."""
        return extra[0] if extra else None

    def backlog(self, stream_id) -> int:
        return len(self._pending[self._slot_of[stream_id]])

    @property
    def busy(self) -> bool:
        return any(self._pending[s] for s in self._slot_of.values())

    def _empty_batch(self) -> StreamBatch:
        cfg, S, dev = self.cfg, self.n_slots, self.device
        return StreamBatch(
            q_packed=torch.zeros((S, cfg.N_max, cfg.words), dtype=torch.int32,
                                 device=dev),
            valid=torch.zeros((S, cfg.N_max), dtype=torch.bool, device=dev),
            boxes=torch.zeros((S, cfg.N_max, 4), dtype=torch.float32,
                              device=dev),
            queue_depth=torch.zeros((S,), dtype=torch.int32, device=dev),
        )

    def _gather(self, i, lanes, buf):
        """Leaf ``i`` of the batch from each served slot's lane: the
        staging buffer ``buf`` with the host lanes written in (idle slots
        zero) when no lane is on the card, else one stack on the card
        (idle slots the pad lane)."""
        if not any(isinstance(x, torch.Tensor) for x in lanes.values()):
            buf.zero_()
            host = buf.numpy()
            for slot, x in lanes.items():
                host[slot] = x
            return buf
        if self._pad is None:
            e = self._empty_batch()
            self._pad = (e.q_packed[0], e.valid[0], e.boxes[0])
        pad = self._pad[i]
        return torch.stack([
            pad if slot not in lanes else
            lanes[slot] if isinstance(lanes[slot], torch.Tensor) else
            torch.from_numpy(np.ascontiguousarray(lanes[slot])).to(
                self.device)
            for slot in range(self.n_slots)])

    def _assemble(self, gate=None):
        """Pop the head window of every busy slot into one padded batch.

        Returns ``(q, v, b, qd, served)``: the batch's leaves (host staging
        buffers, or tensors on the card where a lane is there; see
        :meth:`_gather`), ``qd`` the host queue depths, and ``served`` a
        list of ``(stream_id, slot, extra)`` of the non-pad lanes, where
        ``extra`` is whatever trailing payload ``submit`` queued alongside
        the window (the async engine's future and arrival time). Idle
        slots stay all-pad; ``qd`` is each served slot's *remaining*
        backlog after the pop, so Alg. 1's load gate sees true per-stream
        pressure.

        ``gate(stream_id, backlog_after_pop, extra) -> GATE_*`` is the
        optional admission hook (the async engine's RT-deadline
        controller): GATE_SHED drops the head (the gate owns failing its
        future) and the next queued window is offered in its place;
        GATE_ESCALATE serves the window with its queue-depth lane floored
        to ``cfg.q_hi`` so Alg. 1's ``H(N, q)`` goes high. With
        ``gate=None`` every window is admitted."""
        # the host buffers the step's host lanes are written into: pinned
        # on the card, where the caching host allocator hands a block out
        # again only after the copies enqueued from it have run
        pin = self.device.type == "cuda"
        bufs = [torch.empty(s, dtype=d, pin_memory=pin)
                for s, d in self._staging_shapes]
        qd_t = bufs[3]
        qd = qd_t.numpy()
        qd[:] = 0
        lanes = ({}, {}, {}, {})   # words, valid, boxes; the windows
        served = []  # (stream_id, slot, extra) of non-pad lanes this step
        for stream_id, slot in self._slot_of.items():
            dq = self._pending[slot]
            while dq:
                qw, vw, bw, *extra = dq[0]
                decision = GATE_ADMIT if gate is None else \
                    gate(stream_id, len(dq) - 1, extra)
                window = dq.popleft()
                if decision == GATE_SHED:
                    continue    # offer this slot's next queued window
                for i, x in enumerate(window[:3]):
                    lanes[i][slot] = x
                lanes[3][slot] = window
                qd[slot] = len(dq)
                if decision == GATE_ESCALATE:
                    qd[slot] = max(qd[slot], self.cfg.q_hi)
                served.append((stream_id, slot, extra))
                ctx = self._ctx_of(extra)
                if ctx is not None:
                    ctx.slot = slot
                    if ctx.decision is None:  # a gate may have stamped it
                        ctx.decision = ("admit", "escalate",
                                        "shed")[decision]
                    if self._step_ctxs is not None:
                        self._step_ctxs.append(ctx)
                break
        try:
            q, v, b = (self._gather(i, lanes[i], bufs[i]) for i in range(3))
        except Exception:
            # a window that does not fit the batch: the step's windows go
            # back to their queues, where a failing engine finds them
            for slot, window in lanes[3].items():
                self._pending[slot].appendleft(window)
            raise
        return q, v, b, qd_t, served

    def set_plan(self, plan) -> None:
        """Latch a knob plan (``control.plan.KnobPlan`` or None) for the
        following steps. Host-side only: it takes effect on the next
        dispatch. A plan built for another config raises here."""
        if plan is not None:
            plan.validate(self.cfg)
        self._plan = plan

    @property
    def plan(self):
        return self._plan

    # -- load-aware fused="auto" dispatch ------------------------------------

    def _observe_path_mix(self, path, n_valid) -> None:
        """Fold one step's full-path fraction into the EWMA. ``path`` is
        the step's [S, N_max] path trace and ``n_valid`` the [S] valid
        counts (host arrays); pad lanes report bypass, so the full count
        needs no mask."""
        nv = int(np.sum(n_valid))
        if nv:
            f = float(np.sum(np.asarray(path) == PATH_FULL)) / nv
            self._full_ewma += AUTO_ALPHA * (f - self._full_ewma)

    def _to_host(self, tree, ready):
        """Every tensor of ``tree`` as a host numpy array. On the card the
        copies run on a side stream that waits for ``ready`` (the event
        recorded right after the step that made them), not behind whatever
        was launched since, into pinned buffers; the caller keeps ``tree``
        alive until this returns."""
        if ready is None:
            return capture.tree_map(lambda x: x.numpy(), tree)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        stream = self._copy_stream
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            host = capture.tree_map(
                lambda x: torch.empty(x.shape, dtype=x.dtype,
                                      pin_memory=True).copy_(
                                          x, non_blocking=True), tree)
            done = stream.record_event()
        done.synchronize()
        return capture.tree_map(lambda x: x.numpy(), host)

    def _ready_event(self):
        """An event after everything launched so far on this thread's
        stream (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device).record_event()

    def _fold_one(self, tel, rec, ctxs, ready) -> None:
        """Move one backlogged step's telemetry to the host and consume it:
        the auto dispatcher's path-mix EWMA, the observer's digest and
        flight record (``rec``, or None), and the step's trace contexts."""
        tel_h = self._to_host(tel, ready)
        if self._auto:
            self._observe_path_mix(tel_h.path, tel_h.n_valid)
        digest = None
        if self._obs is not None:
            digest = self._obs.observe_step(tel_h, rec)
        if ctxs:
            if digest is None:
                digest = telemetry_digest(tel_h)
            self._trace_finish(ctxs, rec, digest)

    def _trace_finish(self, ctxs, rec, digest) -> None:
        """Complete one step's trace contexts: stamp the resolved plan and
        lowering (read back off the step's telemetry digest), link the
        flight step index, embed the per-window dicts into the flight
        record under ``"trace"``, and retire the contexts into the tracer
        ring."""
        plan = {"banks": digest.get("banks"), "planes": digest.get("planes")}
        if rec is not None:
            gov = rec.get("governor") or {}
            if gov.get("level") is not None:
                plan["level"] = gov["level"]
        lowering = {"fused": digest.get("fused"),
                    "decide": digest.get("decide"),
                    "bucket_tier": digest.get("bucket_tier")}
        step = rec.get("step") if rec is not None else None
        for ctx in ctxs:
            ctx.step = step
            ctx.plan = plan
            ctx.lowering = lowering
            self._tracer.complete(ctx)
        if rec is not None:
            rec["trace"] = [ctx.to_dict() for ctx in ctxs]

    def _fold_telemetry(self) -> None:
        """Fold the telemetry of steps at least one dispatch old. The
        newest stays in the backlog: reading it would wait for the step
        that may still run on the device. The async engine overrides this
        with a no-op (its collector folds)."""
        while len(self._tel_backlog) > 1:
            self._fold_one(*self._tel_backlog.popleft())

    def flush_telemetry(self) -> None:
        """Fold *every* backlogged step, the newest included (waits for any
        step still running). Call before reading summaries or spilling
        the flight recorder."""
        while self._tel_backlog:
            self._fold_one(*self._tel_backlog.popleft())

    def _resolve_fused(self):
        """(fused, bucket_cap, decide) for the next dispatch. Pinned modes
        pass through. In auto mode the predicted full-path rows (EWMA x
        lanes, padded by ``AUTO_HEADROOM``) round up to a bucket-ladder
        tier: a tier below full capacity dispatches the compact lowering,
        full capacity the lowering's hoisted default. The auto tier is an
        explicit ``bucket_cap``, so it wins over a latched plan's
        ``bucket_cap``."""
        if not self._auto:
            return self._fused, self._bucket_cap, self._decide
        self._fold_telemetry()
        n_rows = self.n_slots * self.cfg.N_max
        want = int(np.ceil(self._full_ewma * n_rows * AUTO_HEADROOM))
        tier = policy.bucket_tier(n_rows, want)
        if tier >= n_rows:
            return None, None, self._decide
        return "compact", tier, self._decide

    @property
    def full_path_ewma(self) -> float:
        """The auto dispatcher's current full-path fraction estimate."""
        return self._full_ewma

    def _dispatch(self, q, v, b, qd):
        """Move one assembled batch to the device (one copy per host leaf,
        asynchronous from pinned staging on the card), launch the step and
        advance the state. Returns the step's (out, tel)."""
        dev = self.device
        batch = StreamBatch(*(x.to(dev, non_blocking=True)
                              for x in (q, v, b, qd)))
        fused, bucket_cap, decide = self._resolve_fused()
        self._last_resolved = (fused, bucket_cap, decide)
        self._state, out, tel = pipeline.torr_stream_batch_step(
            self._state, self.im, batch, self.cfg, serial=self._serial,
            plan=self._plan, fused=fused, bucket_cap=bucket_cap,
            decide=decide, graphs=self.graphs)
        return out, tel

    def step(self) -> Dict[object, tuple[WindowOutput, WindowTelemetry]]:
        """Drain one window per busy slot through the batched step."""
        # the sync engine plays both worker roles: "dispatcher" faults fire
        # before assembly, "collector" faults after the telemetry fold
        if self._fault is not None:
            self._fault.maybe_fire("dispatcher", self.stats.steps)
        step_ctxs = None
        scope = NULL_SPAN
        if self._tracer is not None:
            step_ctxs = self._step_ctxs = []
            scope = trace_scope(step_ctxs)
        try:
            with scope:
                with self._sp_assemble:
                    q, v, b, qd, served = self._assemble()
                if not served:  # idle engine: skip the no-op device step
                    return {}
                with self._sp_dispatch:
                    out, tel = self._dispatch(q, v, b, qd)
        finally:
            self._step_ctxs = None
        self.stats.steps += 1
        self.stats.windows += len(served)
        self.stats.pad_slots += self.n_slots - len(served)

        if self._auto or self._obs is not None or self._tracer is not None:
            rec = None
            if self._obs is not None:
                rec = self._obs.on_dispatch(
                    len(served), self.n_slots - len(served),
                    requested=self._last_resolved, plan=self._plan,
                    full_ewma=self._full_ewma if self._auto else None)
                if rec is not None and self._tracer is not None:
                    rec["ts_us"] = now_us()
                    rec["queue_depth"] = int(qd.max())
            # deferred fold: this step's telemetry enters the backlog, and
            # only entries at least one dispatch old are consumed now
            self._tel_backlog.append((tel, rec, step_ctxs,
                                      self._ready_event()))
            with self._sp_observe:
                self._fold_telemetry()

        if self._fault is not None:
            self._fault.maybe_fire("collector", self.stats.steps)
        return {
            stream_id: (map_tensors(lambda x: x[slot], out),
                        map_tensors(lambda x: x[slot], tel))
            for stream_id, slot, _extra in served
        }

    def drain(self) -> Dict[object, list]:
        """Step until every backlog is empty; per-stream result lists."""
        acc: Dict[object, list] = {sid: [] for sid in self._slot_of}
        while self.busy:
            for sid, res in self.step().items():
                acc[sid].append(res)
        return acc

    def sync(self) -> None:
        """Block until all launched work has finished on the device; timing
        code calls this before reading the clock."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def summary(self) -> Dict[str, float]:
        """Engine counters as a flat dict (folds every deferred step's
        telemetry first)."""
        self.flush_telemetry()
        s = dataclasses.asdict(self.stats)
        s["occupancy"] = self.stats.occupancy
        if self._auto:
            s["full_path_ewma"] = self._full_ewma
        return s

    def warmup(self) -> None:
        """Run one all-pad step outside any timed region (a state no-op:
        every lane takes the pad branch) so the kernels are built and
        loaded first, and with ``jit`` the current key's graphs are
        captured (an all-pad step reads no overflow, and its switch bank
        choice is that of an empty window); its outputs are copied to the
        host once, so the pinned buffers of those copies are allocated
        here and reused by every later step; stats are not touched."""
        fused, bucket_cap, decide = self._resolve_fused()
        _state, out, tel = pipeline.torr_stream_batch_step(
            self._state, self.im, self._empty_batch(), self.cfg,
            serial=self._serial, plan=self._plan, fused=fused,
            bucket_cap=bucket_cap, decide=decide, graphs=self.graphs)
        self._to_host((out, tel), self._ready_event())
        self.sync()
