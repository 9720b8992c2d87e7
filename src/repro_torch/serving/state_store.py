"""Externalized per-stream session state for fault-tolerant serving (port
of ``repro.serving.state_store``).

TorR's per-stream value is *state*: the depth-K query cache (packed
prototypes, per-class score accumulators, plan tags, age/validity), the
stream's task-weight row, and the engine-level control EWMAs. It lives in
an engine's stacked ``TorrState`` on the card; a dead worker discards it,
and every re-admitted stream would pay cold-cache full scans until reuse
re-establishes. This module pulls it out into a pluggable store so stream
slots survive their engine (and, file-backed, their process):

* :class:`StreamSnapshot`: one stream's externalizable state at a window
  boundary: the cache leaves as host numpy arrays in the schema's dtypes,
  the task-weight row, the count of served windows the snapshot covers
  (``window_seq``), and a small ``meta`` dict (engine path-mix EWMA,
  latched plan).
* :class:`StateStore`: the interface: ``put``/``get``/``latest_seq``/
  ``delete``/``keys``/``reap``. ``get`` of a TTL-expired session returns
  None (and reaps it).
* :class:`InMemoryStateStore`: dict-backed; the in-process supervisor's
  default (restart recovery inside one process).
* :class:`JsonlStateStore`: append-only JSONL, latest-record-wins, with
  fsync-per-put crash safety; a *process* can die (SIGKILL) and a fresh
  one warm-starts every stream from the file. ``compact()`` rewrites the
  log to one live record per stream.

Write-through is owned by the engines (``snapshot_every`` windows, from
the sync engine's deferred telemetry fold or the async collector, never
the dispatch path); recovery is owned by
:class:`~repro_torch.serving.supervisor.ServeSupervisor` and
``launch/serve.py``'s cross-process resume. Metrics (optional):
``torr_state_store_writes_total`` / ``torr_state_store_restores_total`` /
``torr_state_store_reaped_total``.

Schema (``STATE_SCHEMA_VERSION`` 1, ``repro``'s): cache leaves are stored
by field name with dtype and shape, base64-raw in the JSONL encoding, in
the dtypes of :data:`SCHEMA_DTYPES`. ``packed`` is uint32 there, as in
``repro``: the port keeps packed words as int32 bit patterns on the card
and *views* them as uint32 for a snapshot (and back on restore), never
casts, so a store written by either package warm-starts the other's
engine, and a word >= 2**31 crosses unchanged. Restore validates each
leaf against the schema and the engine's slot shape, so a schema drift
fails loudly instead of warm-starting garbage.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

STATE_SCHEMA_VERSION = 1

# CacheState leaf names, in field order (core.query_cache.CacheState);
# pinned here so snapshots taken by one engine build restore into another
CACHE_FIELDS = ("packed", "acc", "acc_tag", "out", "topk_key", "margin",
                "age", "valid")

# each leaf's dtype on the wire and on disk (``repro``'s CacheState dtypes)
SCHEMA_DTYPES = {
    "packed": np.dtype(np.uint32), "acc": np.dtype(np.int32),
    "acc_tag": np.dtype(np.int32), "out": np.dtype(np.float32),
    "topk_key": np.dtype(np.int32), "margin": np.dtype(np.float32),
    "age": np.dtype(np.int32), "valid": np.dtype(np.bool_),
}


@dataclasses.dataclass
class StreamSnapshot:
    """One stream's externalized session state at a window boundary."""

    stream_id: str
    window_seq: int                 # served windows this snapshot covers
    cache: Dict[str, np.ndarray]    # CACHE_FIELDS -> host arrays
    task_w: np.ndarray              # f32 [M] reasoner weight row
    meta: Dict = dataclasses.field(default_factory=dict)

    def validate(self) -> "StreamSnapshot":
        missing = [f for f in CACHE_FIELDS if f not in self.cache]
        if missing:
            raise ValueError(
                f"snapshot for {self.stream_id!r} missing cache leaves "
                f"{missing}; schema v{STATE_SCHEMA_VERSION} expects "
                f"{CACHE_FIELDS}")
        return self

    # -- JSON round-trip (the JSONL store's record format) -------------------

    def to_record(self) -> dict:
        return {
            "v": STATE_SCHEMA_VERSION,
            "stream_id": self.stream_id,
            "window_seq": int(self.window_seq),
            "cache": {k: _encode_array(v) for k, v in self.cache.items()},
            "task_w": _encode_array(np.asarray(self.task_w)),
            "meta": self.meta,
        }

    @classmethod
    def from_record(cls, rec: dict) -> "StreamSnapshot":
        if rec.get("v") != STATE_SCHEMA_VERSION:
            raise ValueError(
                f"state-store schema v{rec.get('v')} != "
                f"v{STATE_SCHEMA_VERSION}")
        return cls(
            stream_id=rec["stream_id"],
            window_seq=int(rec["window_seq"]),
            cache={k: _decode_array(v) for k, v in rec["cache"].items()},
            task_w=_decode_array(rec["task_w"]),
            meta=rec.get("meta", {}),
        ).validate()


def _encode_array(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def _decode_array(d: dict) -> np.ndarray:
    raw = base64.b64decode(d["data"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(
        d["shape"]).copy()


class StateStore:
    """Pluggable per-stream session-state store (TTL-reaped).

    ``ttl_s`` bounds how long a session outlives its last write: a crashed
    client that never retires leaves no immortal rows; ``reap()`` (called
    by ``get``/``keys`` and explicitly by owners) drops sessions whose
    newest snapshot is older than the TTL. ``clock`` is injectable for
    deterministic tests. ``metrics`` optionally wires the
    ``torr_state_store_*`` counters.
    """

    def __init__(self, ttl_s: float | None = None, clock=time.monotonic,
                 metrics=None):
        self.ttl_s = ttl_s
        self._clock = clock
        self._lock = threading.Lock()
        self._snaps: Dict[str, StreamSnapshot] = {}
        self._stamp: Dict[str, float] = {}
        self._m_writes = self._m_restores = self._m_reaped = None
        if metrics is not None:
            self._m_writes = metrics.counter(
                "torr_state_store_writes_total",
                "Stream-state snapshots written through to the store.")
            self._m_restores = metrics.counter(
                "torr_state_store_restores_total",
                "Stream-state snapshots read back for warm-start.")
            self._m_reaped = metrics.counter(
                "torr_state_store_reaped_total",
                "Sessions dropped by TTL reaping.")

    # -- write ---------------------------------------------------------------

    def put(self, snap: StreamSnapshot) -> None:
        snap.validate()
        with self._lock:
            cur = self._snaps.get(snap.stream_id)
            if cur is not None and cur.window_seq > snap.window_seq:
                return  # stale write (an abandoned engine's last delivery
                #         racing its replacement) must not regress coverage
            self._put_locked(snap)
            self._stamp[snap.stream_id] = self._clock()
        if self._m_writes is not None:
            self._m_writes.inc()

    def _put_locked(self, snap: StreamSnapshot) -> None:
        self._snaps[snap.stream_id] = snap

    # -- read ----------------------------------------------------------------

    def get(self, stream_id: str) -> Optional[StreamSnapshot]:
        """Newest snapshot for the stream, or None (absent / TTL-expired)."""
        with self._lock:
            self._reap_locked()
            snap = self._snaps.get(stream_id)
        if snap is not None and self._m_restores is not None:
            self._m_restores.inc()
        return snap

    def latest_seq(self, stream_id: str) -> int:
        """``window_seq`` of the newest snapshot (0 = none / expired)."""
        with self._lock:
            self._reap_locked()
            snap = self._snaps.get(stream_id)
        return snap.window_seq if snap is not None else 0

    def keys(self) -> List[str]:
        with self._lock:
            self._reap_locked()
            return sorted(self._snaps)

    # -- lifecycle -----------------------------------------------------------

    def delete(self, stream_id: str) -> None:
        """Drop a retired session's state (idempotent)."""
        with self._lock:
            self._snaps.pop(stream_id, None)
            self._stamp.pop(stream_id, None)

    def reap(self, now: float | None = None) -> List[str]:
        """Drop TTL-expired sessions; returns the reaped stream ids."""
        with self._lock:
            return self._reap_locked(now)

    def _reap_locked(self, now: float | None = None) -> List[str]:
        if self.ttl_s is None:
            return []
        now = self._clock() if now is None else now
        dead = [sid for sid, ts in self._stamp.items()
                if now - ts > self.ttl_s]
        for sid in dead:
            self._snaps.pop(sid, None)
            self._stamp.pop(sid, None)
        if dead and self._m_reaped is not None:
            self._m_reaped.inc(len(dead))
        return sorted(dead)


class InMemoryStateStore(StateStore):
    """Dict-backed store: in-process supervised restart recovery."""


class JsonlStateStore(StateStore):
    """Append-only JSONL store: latest record per stream wins.

    Crash safety: each ``put`` appends one line, flushes, and (by default)
    fsyncs: a SIGKILLed process loses at most the write in progress, and a
    torn trailing line is skipped on load (the previous snapshot of that
    stream still restores). ``delete`` appends a tombstone. ``compact()``
    rewrites the log to one live record per stream via tmp+rename.
    """

    def __init__(self, path: str | os.PathLike, ttl_s: float | None = None,
                 clock=time.monotonic, metrics=None, fsync: bool = True):
        super().__init__(ttl_s=ttl_s, clock=clock, metrics=metrics)
        self.path = os.fspath(path)
        self._fsync = fsync
        self._load()
        self._f = open(self.path, "a", encoding="utf-8")

    # -- persistence ---------------------------------------------------------

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue    # torn trailing write: previous record wins
                if rec.get("tombstone"):
                    self._snaps.pop(rec["stream_id"], None)
                    self._stamp.pop(rec["stream_id"], None)
                    continue
                try:
                    snap = StreamSnapshot.from_record(rec)
                except (KeyError, ValueError):
                    continue    # torn/alien record: skip, don't poison load
                cur = self._snaps.get(snap.stream_id)
                if cur is not None and cur.window_seq > snap.window_seq:
                    continue    # out-of-order append: newest seq wins
                self._snaps[snap.stream_id] = snap
                self._stamp[snap.stream_id] = self._clock()

    def _append(self, rec: dict) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())

    # -- overrides -----------------------------------------------------------

    def _put_locked(self, snap: StreamSnapshot) -> None:
        super()._put_locked(snap)
        self._append(snap.to_record())

    def delete(self, stream_id: str) -> None:
        with self._lock:
            present = stream_id in self._snaps
            self._snaps.pop(stream_id, None)
            self._stamp.pop(stream_id, None)
            if present:
                self._append({"v": STATE_SCHEMA_VERSION,
                              "stream_id": stream_id, "tombstone": True})

    def compact(self) -> int:
        """Rewrite the log to one live record per stream; returns the
        number of live records kept."""
        with self._lock:
            self._reap_locked()
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                for sid in sorted(self._snaps):
                    f.write(json.dumps(self._snaps[sid].to_record()) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "a", encoding="utf-8")
            return len(self._snaps)

    def close(self) -> None:
        self._f.close()


def snapshot_rows(state, slot: int, stream_id: str, window_seq: int,
                  meta: Optional[dict] = None):
    """Lazy per-slot snapshot handle over a stacked ``TorrState``.

    Returns ``(stream_id, window_seq, state, slot, meta)``: a *reference*
    to the post-step state tree, no device call at all, so taking it on
    the dispatch path costs nothing. This is sound because the port's
    state is functional: a step returns new tensors and never writes into
    the ones it was given (``core.pipeline`` works on clones,
    ``query_cache.reset_slot`` and :func:`restore_slot` clone before their
    row writes), and a captured step hands back clones of its graph's
    static outputs (``core.capture.GraphFamily.run``), never the buffers
    the next replay overwrites. So the tensors a snapshot holds stay as
    they were after its step until the snapshot is materialized, however
    many steps run meanwhile (held on the card by
    ``tests/test_torch_fault_card.py``). The caller (the sync engine's
    deferred fold, the async collector) forces it with
    :func:`materialize_snapshot` once the step has retired.
    """
    return (stream_id, window_seq, state, slot, dict(meta or {}))


def _host_state(state) -> dict:
    """A state tree's leaves as host arrays in the schema's dtypes, keyed
    by :data:`CACHE_FIELDS` plus ``"__task_w__"``, from a tree whose
    tensors are already on the host (``packed``'s int32 bit patterns
    viewed as uint32, never cast)."""
    def arr(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    host = {f: arr(getattr(state.cache, f)) for f in CACHE_FIELDS}
    host["packed"] = host["packed"].view(np.uint32)
    host["__task_w__"] = arr(state.task_weights)
    return host


def materialize_snapshot(pending, memo: Optional[dict] = None,
                         to_host=None) -> StreamSnapshot:
    """Force one :func:`snapshot_rows` payload to host numpy arrays.

    ``memo`` (keyed by the state tree's identity) caches the full host
    copy of each stacked leaf, so a fold snapshotting many slots of the
    same step pays one device-to-host copy per leaf, not per slot.
    ``to_host(tree)`` makes that copy: the engines pass their own, which
    on the card copies on a side stream after the step's event into
    pinned memory (never a ``.cpu()`` on the dispatcher's stream); without
    one, a plain copy to host memory. The snapshot's rows are views into
    that host copy, which is the snapshot's own: it shares no memory with
    the engine's state.
    """
    stream_id, window_seq, state, slot, meta = pending
    key = id(state)
    host = memo.get(key) if memo is not None else None
    if host is None:
        if to_host is None:
            from ..core.capture import tree_map
            host_tree = tree_map(lambda x: x.detach().cpu().clone(), state)
        else:
            host_tree = to_host(state)
        host = _host_state(host_tree)
        if memo is not None:
            memo[key] = host
    return StreamSnapshot(
        stream_id=stream_id,
        window_seq=window_seq,
        cache={f: host[f][slot] for f in CACHE_FIELDS},
        task_w=host["__task_w__"][slot],
        meta=meta,
    )


def restore_slot(state, cfg, slot: int, snap: StreamSnapshot):
    """Warm-start one slot of a stacked ``TorrState`` from a snapshot.

    Returns a new state tree with the slot's cache leaves and task-weight
    row overwritten by the snapshot's: each leaf is cloned on the state's
    device and the row written into the clone (``repro``'s ``.at[slot]
    .set``; ``query_cache.reset_slot`` does the same), so no tensor an
    earlier snapshot or step holds is written. Each row is validated
    against the schema's dtype (``packed`` is uint32 there, the port's
    int32 storage is a view of it) and the slot's shape, so schema drift
    fails loudly. The snapshot's ``acc_tag`` rides along, so stale-delta
    rejection across plan switches is preserved bit-exactly.
    """
    from ..core.pipeline import TorrState

    snap.validate()
    cache = state.cache
    new_leaves = {}
    for f in CACHE_FIELDS:
        cur = getattr(cache, f)
        row = np.asarray(snap.cache[f])
        want = tuple(cur.shape[1:])
        if tuple(row.shape) != want or row.dtype != SCHEMA_DTYPES[f]:
            raise ValueError(
                f"snapshot leaf {f!r} is {row.dtype}{row.shape}, slot wants "
                f"{SCHEMA_DTYPES[f]}{want} — config mismatch between "
                "snapshot and engine")
        if f == "packed":
            row = row.view(np.int32)
        new = cur.clone()
        new[slot] = torch.from_numpy(np.ascontiguousarray(row)).to(
            cur.device)
        new_leaves[f] = new
    cache = dataclasses.replace(cache, **new_leaves)
    task_w = state.task_weights.clone()
    task_w[slot] = torch.from_numpy(
        np.array(snap.task_w, np.float32)).to(task_w.device)
    return TorrState(cache=cache, task_weights=task_w)
