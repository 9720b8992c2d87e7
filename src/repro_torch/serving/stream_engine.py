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

``set_plan(plan)`` latches a :class:`~repro_torch.control.plan.KnobPlan`
(D' cap, bit-slice planes, tau offsets) for every later step, on every
lowering; ``set_plan(None)`` returns to the uncontrolled step.

``fused="auto"`` arms the load-aware kernel dispatch: every step the engine
folds an earlier step's full-path fraction into an EWMA and picks between
the hoisted lowering default and the reuse-aware compact dispatch
(``fused="compact"`` with a ``core.policy.bucket_ladder`` tier sized to the
predicted miss count). Every choice is bit-identical (compact overflow falls
back exactly), so auto is purely a scheduling knob.

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

from ..convert import words_from_numpy
from ..core import capture, pipeline, policy, query_cache
from ..core.item_memory import ItemMemory
from ..core.pipeline import TorrState, WindowOutput
from ..core.types import (PATH_FULL, StreamBatch, TorrConfig,
                          WindowTelemetry, map_tensors)
from ..device import resolve_device

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

    @property
    def occupancy(self) -> float:
        total = self.windows + self.pad_slots
        return self.windows / total if total else 0.0


def _words(x, device) -> torch.Tensor:
    """Packed words as an int32 tensor on ``device``; numpy uint32 words
    (``repro``'s dtype) are reinterpreted bit for bit."""
    if isinstance(x, np.ndarray):
        x = words_from_numpy(x)
    if x.dtype != torch.int32:
        raise TypeError(f"packed words must be int32 (or numpy uint32), "
                        f"got {x.dtype}")
    return x.to(device)


class StreamEngine:
    """Fixed-slot scheduler feeding ``torr_multi_stream_step``."""

    def __init__(self, cfg: TorrConfig, im: ItemMemory, n_slots: int = 16,
                 jit: bool = True, serial: bool = False,
                 fused: str | None = None, bucket_cap: int | None = None,
                 decide: str | None = None, *, device=None):
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
        # The backlog holds the (path, n_valid) of dispatched steps; only
        # entries at least one dispatch old are folded while serving
        self._full_ewma = 1.0
        self._tel_backlog: collections.deque = collections.deque()
        self._state: TorrState = pipeline.init_multi_stream_state(
            cfg, torch.zeros((n_slots, cfg.M)), self.device)
        self._pending = [collections.deque() for _ in range(n_slots)]
        self._slot_of: Dict[object, int] = {}
        self._free = list(range(n_slots - 1, -1, -1))
        self.stats = EngineStats()

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
        return slot

    def retire(self, stream_id) -> None:
        """Release a stream's slot, dropping any un-popped backlog."""
        slot = self._slot_of.pop(stream_id)
        self.stats.dropped += len(self._pending[slot])
        self._pending[slot].clear()
        self._free.append(slot)
        self.stats.retired += 1

    # -- window flow --------------------------------------------------------

    def submit(self, stream_id, q_packed, valid, boxes) -> None:
        """Enqueue one window (packed queries, validity, boxes) for a
        stream. Arrays may be numpy or tensors; they move to the engine's
        device here."""
        slot = self._slot_of[stream_id]
        self._pending[slot].append((
            _words(q_packed, self.device),
            torch.as_tensor(valid).to(self.device, torch.bool),
            torch.as_tensor(boxes).to(self.device, torch.float32),
        ))

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

    def _assemble(self):
        """Pop the head window of every busy slot into a padded batch.

        Returns ``(batch, served)`` with ``served`` the (stream_id, slot) of
        the non-pad lanes. Idle slots stay all-pad; each served slot's
        queue depth is its *remaining* backlog after the pop."""
        batch = self._empty_batch()
        qd = np.zeros((self.n_slots,), np.int32)
        served = []
        for stream_id, slot in self._slot_of.items():
            dq = self._pending[slot]
            if not dq:
                continue
            qw, vw, bw = dq.popleft()
            batch.q_packed[slot], batch.valid[slot] = qw, vw
            batch.boxes[slot] = bw
            qd[slot] = len(dq)
            served.append((stream_id, slot))
        batch.queue_depth = torch.from_numpy(qd).to(self.device)
        return batch, served

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

    def flush_telemetry(self, keep: int = 0) -> None:
        """Fold backlogged steps until ``keep`` remain. The engine keeps 1
        while serving: reading the newest step's telemetry would wait for
        the step that may still run on the device (0 waits for all)."""
        while len(self._tel_backlog) > keep:
            path, n_valid = self._tel_backlog.popleft()
            self._observe_path_mix(path.cpu().numpy(), n_valid.cpu().numpy())

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
        self.flush_telemetry(keep=1)
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

    def step(self) -> Dict[object, tuple[WindowOutput, WindowTelemetry]]:
        """Drain one window per busy slot through the batched step."""
        batch, served = self._assemble()
        if not served:  # idle engine: skip the no-op device step
            return {}
        fused, bucket_cap, decide = self._resolve_fused()
        self._state, out, tel = pipeline.torr_stream_batch_step(
            self._state, self.im, batch, self.cfg, serial=self._serial,
            plan=self._plan, fused=fused, bucket_cap=bucket_cap,
            decide=decide, graphs=self.graphs)
        if self._auto:      # deferred fold: this step's telemetry waits
            self._tel_backlog.append((tel.path, tel.n_valid))
            self.flush_telemetry(keep=1)
        self.stats.steps += 1
        self.stats.windows += len(served)
        self.stats.pad_slots += self.n_slots - len(served)
        return {
            stream_id: (map_tensors(lambda x: x[slot], out),
                        map_tensors(lambda x: x[slot], tel))
            for stream_id, slot in served
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
        choice is that of an empty window); stats are not touched."""
        fused, bucket_cap, decide = self._resolve_fused()
        pipeline.torr_stream_batch_step(self._state, self.im,
                                        self._empty_batch(), self.cfg,
                                        serial=self._serial, plan=self._plan,
                                        fused=fused, bucket_cap=bucket_cap,
                                        decide=decide, graphs=self.graphs)
        self.sync()
