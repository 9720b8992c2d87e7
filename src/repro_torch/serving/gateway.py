"""Network-facing event gateway: multi-tenant ingestion over real sockets
(port of ``repro.serving.gateway``: the same routes, limits, reject
reasons, metrics and response bodies).

Everything below this tier already exists: admission control
(:mod:`repro_torch.serving.deadline`), crash recovery
(:mod:`repro_torch.serving.supervisor`), metrics/flight/tracing
(:mod:`repro_torch.obs`). What was missing is the place where *other people's
code* meets ours: a network front where backpressure, overload and
misbehaving clients happen. The :class:`Gateway` is that tier, built on
the design rule that **every failure mode is a typed, client-visible
outcome** — a malformed frame, a saturated tenant, an engine death
mid-recovery, a slow-loris header, a mid-flight disconnect: each maps to
a deterministic HTTP status with a machine-readable reason and (where
retrying helps) a ``Retry-After`` hint. No client input can surface as a
worker exception; no accepted window is silently lost.

Design notes
------------
* **Hand-rolled HTTP/1.1 over threads**, not ``http.server``: the
  robustness surface *is* the byte-level read path — bounded header and
  body buffers, an absolute per-request read deadline (slow-loris
  becomes 408, not a parked thread), per-write timeouts, a connection
  cap. Stdlib-only, one daemon thread per connection, keep-alive serial
  per connection.
* **Sessions are the tenancy unit.** ``POST /v1/session`` maps
  ``tenant/stream`` to an engine slot (fair admission: a per-tenant
  session quota keeps one tenant from hoarding slots; slot exhaustion is
  a 429 ``no_slot``, not an error). Per-tenant token buckets rate-limit
  window submissions (429 ``rate_limit`` + Retry-After).
* **Strict sequencing is the idempotency contract.** Each session
  carries a client sequence number. A shed window (429) rolls the
  sequence back — shed windows never advanced engine state, so the
  retry is bit-safe. A request-deadline expiry (503 ``deadline``) parks
  the in-flight future — the engine saw the window exactly once, and the
  client's retry of the *same* seq attaches to the parked future (or
  replays the cached result), which is what keeps chaos-retry output
  bit-identical to a fault-free run. A mid-flight disconnect cancels the
  future (accounted in ``torr_telemetry_dropped_total``) but the window
  may already have advanced state, so a later retry of that seq is a
  409 ``seq_consumed``.
* **Recovery awareness.** A supervised front exposes
  ``health()``/``retry_after_s()``; while the supervisor is rebuilding
  an engine the gateway fast-fails windows with 503 ``recovering`` plus
  a backoff-derived retry hint instead of queueing threads on the
  supervisor lock, and ``/readyz`` goes not-ready. A background pump
  thread calls ``front.heal()`` so recovery starts promptly even when no
  traffic is arriving.
* **Graceful drain.** :meth:`Gateway.drain` (SIGTERM in
  ``serve.py --gateway-port``) stops accepting, lets in-flight requests
  resolve, answers new windows with 503 ``draining``, then closes every
  connection — exit 0, nothing lost.

Metrics land in the shared :class:`repro_torch.obs.metrics.MetricsRegistry`
(``torr_gateway_*``); they reconcile exactly against a well-behaved
client's own counts.

On the card: the gateway's threads (accept, pump, one per connection)
make no device call of their own. Windows arrive as host arrays (the
decoded uint32 words viewed as int32, the port's layout) and reach the
card inside the engine: on an async engine's dispatcher stream, or on
the :class:`SyncDriver` pump thread's stream, which steps the sync
engine; results come back as host arrays.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import select
import socket
import threading
import time
from concurrent.futures import CancelledError, Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Dict, Optional

import numpy as np

from ..core.capture import tree_map
from ..runtime.fault import EngineDead
from .deadline import WindowShed
from . import protocol
from .protocol import ProtocolError

_STATUS_TEXT = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout", 409: "Conflict",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
}

_DROPPED_HELP = "Observed steps/windows lost before telemetry was folded."


@dataclasses.dataclass(frozen=True)
class GatewayLimits:
    """Tuning knobs for the network tier (docs/gateway.md)."""

    max_header_bytes: int = 8192       # request line + headers cap
    max_body_bytes: int = 2 << 20      # JSON body cap -> 413
    read_timeout_s: float = 5.0        # absolute budget to read one request
    idle_timeout_s: float = 30.0       # keep-alive wait for the next request
    write_timeout_s: float = 5.0       # per-send cap (slow readers)
    request_deadline_s: float = 2.0    # default wait for a window result
    max_connections: int = 64          # concurrent sockets -> 503 beyond
    rate_per_s: float = 200.0          # per-tenant token refill rate
    burst: int = 100                   # per-tenant bucket depth
    max_sessions_per_tenant: int = 8   # fair slot admission
    max_parked: int = 4                # deadline-expired futures kept/session
    poll_interval_s: float = 0.05      # future-wait poll + liveness cadence
    no_slot_retry_s: float = 0.25      # Retry-After when slots are exhausted


class _Disconnect(Exception):
    """Client went away mid-request; close the connection quietly."""


class _TokenBucket:
    """Per-tenant rate limiter. Returns 0.0 on admit, else the earliest
    delay after which one token will be available (the Retry-After)."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: int, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.last = now

    def take(self, now: float) -> float:
        self.tokens = min(self.burst,
                          self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate


@dataclasses.dataclass
class _Session:
    sid: str
    tenant: str
    slot: int
    task: int
    rt: str
    deadline_s: float
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    next_seq: int = 0
    # deadline-expired futures by seq, oldest first (bounded max_parked)
    parked: "collections.OrderedDict[int, Future]" = dataclasses.field(
        default_factory=collections.OrderedDict)
    cached_seq: int = -1        # newest completed seq with a cached body
    cached_body: bytes = b""


class SyncDriver:
    """Future-returning facade over the synchronous :class:`StreamEngine`.

    A pump thread steps the engine whenever it has backlog and resolves
    per-stream FIFO futures with host-resident ``(out, telemetry)``
    trees — giving the sync engine the same submit surface the gateway
    needs from :class:`AsyncStreamEngine`/:class:`ServeSupervisor`.
    Admission-control shedding is not supported here (drive sync engines
    without a tracker); a step-time failure fails every pending future
    with a typed :class:`EngineDead`.
    """

    def __init__(self, engine, metrics=None):
        self.engine = engine
        self._lock = threading.Lock()
        self._expect: Dict[object, collections.deque] = {}
        self._wake = threading.Event()
        self._stop = False
        self._dead: Optional[EngineDead] = None
        self._m_dropped = None
        if metrics is not None:
            self._m_dropped = metrics.counter(
                "torr_telemetry_dropped_total", _DROPPED_HELP)
        self._thread = threading.Thread(
            target=self._pump, name="torr-syncdriver", daemon=True)
        self._thread.start()

    def admit(self, stream_id, task_w, snapshot=None) -> int:
        with self._lock:
            if self._dead is not None:
                raise self._dead
            slot = self.engine.admit(stream_id, task_w, snapshot=snapshot)
            self._expect[stream_id] = collections.deque()
            return slot

    def retire(self, stream_id) -> None:
        with self._lock:
            pending = self._expect.pop(stream_id, ())
            self.engine.retire(stream_id)
        for fut in pending:
            fut.cancel()

    def submit(self, stream_id, q_packed, valid, boxes) -> Future:
        with self._lock:
            if self._dead is not None:
                raise self._dead
            if stream_id not in self._expect:
                raise KeyError(stream_id)
            self.engine.submit(stream_id, q_packed, valid, boxes)
            fut: Future = Future()
            self._expect[stream_id].append(fut)
        self._wake.set()
        return fut

    def health(self) -> dict:
        return {"ready": self._dead is None, "recovering": False,
                "terminal": self._dead is not None, "restarts": 0,
                "degraded": False}

    def close(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=10.0)

    def _pump(self) -> None:
        # the engine's device work (its steps; admit's slot writes) runs on
        # the default stream of whichever thread calls it, here and on the
        # connection threads, so it stays in one order on the card
        while not self._stop:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            while not self._stop:
                with self._lock:
                    if self._dead is not None or not self.engine.busy:
                        break
                    try:
                        results = self.engine.step()
                    except Exception as e:   # noqa: BLE001 — typed below
                        self._dead = EngineDead(
                            cause=e, thread="dispatcher",
                            inflight=sum(len(d)
                                         for d in self._expect.values()))
                        failed = [f for d in self._expect.values() for f in d]
                        for d in self._expect.values():
                            d.clear()
                        results = None
                    if results is None:
                        dead = self._dead
                        resolved = []
                    else:
                        resolved, failed = [], []
                        for sid, out_tel in results.items():
                            q = self._expect.get(sid)
                            if q:
                                resolved.append((q.popleft(), out_tel))
                # deliver outside the lock: callbacks may re-enter submit
                for fut, out_tel in resolved:
                    host = tree_map(lambda x: x.detach().cpu().numpy(),
                                    out_tel)
                    if fut.cancelled():
                        self.engine.stats.telemetry_dropped += 1
                        if self._m_dropped is not None:
                            self._m_dropped.inc()
                    else:
                        try:
                            fut.set_result(host)
                        except Exception:   # cancelled in the gap
                            if self._m_dropped is not None:
                                self._m_dropped.inc()
                if results is None:
                    for fut in failed:
                        if not fut.done():
                            fut.set_exception(dead)
                    break
            with self._lock:
                if self.engine.busy and self._dead is None:
                    self._wake.set()    # backlog grew while delivering


class Gateway:
    """Threaded socket HTTP front mapping tenant sessions to stream slots.

    ``front`` is anything with the admit/retire/submit surface —
    :class:`~repro_torch.serving.supervisor.ServeSupervisor`,
    :class:`~repro_torch.serving.async_engine.AsyncStreamEngine`, or a
    :class:`SyncDriver`; ``health()``/``retry_after_s()``/``heal()`` are
    consulted when present. ``task_bank`` is the ``[n_tasks, M]`` matrix
    of reasoner task-weight rows sessions select from.
    """

    def __init__(self, front, cfg, task_bank, *, limits: GatewayLimits
                 | None = None, host: str = "127.0.0.1", port: int = 0,
                 metrics=None, flight=None, clock=time.monotonic):
        self._front = front
        self._cfg = cfg
        self._task_bank = np.asarray(task_bank, np.float32)
        if self._task_bank.ndim != 2:
            raise ValueError("task_bank must be [n_tasks, M]")
        self.limits = limits or GatewayLimits()
        self._metrics = metrics
        self._flight = flight
        self._clock = clock
        self._glock = threading.Lock()
        self._sessions: Dict[str, _Session] = {}
        self._buckets: Dict[str, _TokenBucket] = {}
        self._conns: set = set()
        self._active_requests = 0
        self._draining = False
        self._stop = False
        self._threads: list = []

        self._m_req = self._m_rej = self._m_hist = None
        if metrics is not None:
            from ..obs.metrics import LATENCY_BUCKETS_S
            self._m_req = metrics.counter(
                "torr_gateway_requests_total",
                "Gateway HTTP requests by route and response status.",
                ["route", "status"])
            self._m_rej = metrics.counter(
                "torr_gateway_rejects_total",
                "Gateway rejections by typed reason (docs/gateway.md).",
                ["reason"])
            self._m_conns = metrics.counter(
                "torr_gateway_connections_total",
                "Accepted gateway TCP connections.")
            self._g_open = metrics.gauge(
                "torr_gateway_connections_open",
                "Currently open gateway connections.")
            self._g_sessions = metrics.gauge(
                "torr_gateway_sessions_open",
                "Open gateway sessions (tenant/stream pairs).")
            self._m_disc = metrics.counter(
                "torr_gateway_disconnects_total",
                "Client connections lost mid-request.")
            self._g_drain = metrics.gauge(
                "torr_gateway_draining",
                "1 while the gateway is draining (stopped accepting).")
            self._m_hist = metrics.histogram(
                "torr_gateway_request_seconds",
                "Request receipt to response-written wall time.",
                ["route"], buckets=LATENCY_BUCKETS_S)
            self._m_dropped = metrics.counter(
                "torr_telemetry_dropped_total", _DROPPED_HELP)
        else:
            self._m_dropped = None

        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(128)
        self.host = host
        self.port = self._lsock.getsockname()[1]

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> int:
        t = threading.Thread(target=self._accept_loop,
                             name="torr-gateway-accept", daemon=True)
        t.start()
        self._threads.append(t)
        p = threading.Thread(target=self._pump_loop,
                             name="torr-gateway-pump", daemon=True)
        p.start()
        self._threads.append(p)
        if self._flight is not None:
            self._flight.record(event="gateway_listening", port=self.port)
        return self.port

    def drain(self, timeout: float | None = 30.0) -> bool:
        """Graceful shutdown: stop accepting, flush in-flight requests,
        then close every connection. Returns True if in-flight work
        drained inside the timeout."""
        with self._glock:
            if self._draining:
                return True
            self._draining = True
        if self._metrics is not None:
            self._g_drain.set(1)
        if self._flight is not None:
            self._flight.record(event="gateway_drain_begin",
                                active=self._active_requests,
                                conns=len(self._conns))
        try:
            # a bare close() leaves the accept thread parked in accept();
            # shutdown wakes it, so close() joins it at once
            self._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        deadline = None if timeout is None else self._clock() + timeout
        drained = True
        while True:
            with self._glock:
                active = self._active_requests
            if active == 0:
                break
            if deadline is not None and self._clock() >= deadline:
                drained = False
                break
            time.sleep(0.01)
        with self._glock:
            sessions = list(self._sessions.values())
            conns = list(self._conns)
        for sess in sessions:
            with sess.lock:
                # cancelled futures are accounted by the delivery path
                # (engine collector / supervisor / SyncDriver) in
                # torr_telemetry_dropped_total — not double-counted here
                for fut in sess.parked.values():
                    fut.cancel()
                sess.parked.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._stop = True
        if self._flight is not None:
            self._flight.record(event="gateway_drain_end", drained=drained)
        return drained

    def close(self) -> None:
        if not self._draining:
            self.drain(timeout=5.0)
        self._stop = True
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self) -> "Gateway":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- background threads --------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _addr = self._lsock.accept()
            except OSError:
                return      # listener closed (drain/close)
            if self._draining or self._stop:
                self._refuse(conn, 503, "draining")
                continue
            with self._glock:
                over = len(self._conns) >= self.limits.max_connections
                if not over:
                    self._conns.add(conn)
            if over:
                self._refuse(conn, 503, "conn_limit")
                continue
            if self._metrics is not None:
                self._m_conns.inc()
                self._g_open.set(len(self._conns))
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="torr-gateway-conn", daemon=True)
            t.start()

    def _pump_loop(self) -> None:
        """Keep recovery moving without traffic: a supervised front only
        notices engine death inside submit/admit/flush, so an idle
        gateway would otherwise sit on a dead engine until the next
        request pays the full recovery latency."""
        while not self._stop:
            heal = getattr(self._front, "heal", None)
            if callable(heal):
                try:
                    heal()
                except EngineDead:
                    pass    # terminal: health() now reports it
                except Exception:   # noqa: BLE001 — pump must survive
                    pass
            time.sleep(0.05)

    def _refuse(self, conn, status: int, reason: str) -> None:
        try:
            conn.settimeout(self.limits.write_timeout_s)
            body = json.dumps({"error": reason}).encode()
            conn.sendall(self._head(status, len(body),
                                    "application/json", False) + body)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
        self._count("other", status, reason)

    # -- connection handling -------------------------------------------------

    def _serve_conn(self, conn) -> None:
        buf = bytearray()
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stop:
                try:
                    req = self._read_request(conn, buf)
                except ProtocolError as e:
                    self._send_error(conn, "other", e, keep=False)
                    return
                if req is None:
                    return      # clean close or idle timeout
                method, path, headers, body = req
                want_close = headers.get("connection", "").lower() == "close"
                keep = not want_close and not self._draining
                with self._glock:
                    self._active_requests += 1
                try:
                    keep = self._dispatch(conn, method, path, body, keep)
                finally:
                    with self._glock:
                        self._active_requests -= 1
                if not keep:
                    return
        except _Disconnect:
            if self._metrics is not None:
                self._m_disc.inc()
        except OSError:
            pass
        finally:
            with self._glock:
                self._conns.discard(conn)
            if self._metrics is not None:
                self._g_open.set(len(self._conns))
            try:
                conn.close()
            except OSError:
                pass

    def _recv(self, conn, timeout: float) -> bytes:
        conn.settimeout(max(timeout, 1e-4))
        try:
            chunk = conn.recv(65536)
        except socket.timeout:
            raise ProtocolError(408, "slow_client",
                                "read deadline exceeded") from None
        except OSError:
            raise _Disconnect() from None
        if chunk == b"":
            raise _Disconnect()
        return chunk

    def _read_request(self, conn, buf: bytearray):
        """Read one full request with bounded buffers and an absolute
        deadline. Returns None on clean idle close/timeout before any
        byte of a new request arrived."""
        lim = self.limits
        # wait for the first byte of a new request (idle keep-alive)
        if not buf:
            conn.settimeout(lim.idle_timeout_s)
            try:
                chunk = conn.recv(65536)
            except socket.timeout:
                return None
            except OSError:
                return None
            if chunk == b"":
                return None
            buf += chunk
        deadline = self._clock() + lim.read_timeout_s
        while b"\r\n\r\n" not in buf:
            if len(buf) > lim.max_header_bytes:
                raise ProtocolError(400, "bad_request", "headers too large")
            left = deadline - self._clock()
            if left <= 0:
                raise ProtocolError(408, "slow_client",
                                    "headers not received in time")
            buf += self._recv(conn, left)
        head, rest = bytes(buf).split(b"\r\n\r\n", 1)
        if len(head) > lim.max_header_bytes:
            raise ProtocolError(400, "bad_request", "headers too large")
        del buf[:]
        buf += rest
        try:
            lines = head.decode("latin-1").split("\r\n")
            method, path, version = lines[0].split(" ", 2)
        except (UnicodeDecodeError, ValueError):
            raise ProtocolError(400, "bad_request",
                                "malformed request line") from None
        if not version.startswith("HTTP/1."):
            raise ProtocolError(400, "bad_request",
                                f"unsupported version {version!r}")
        headers = {}
        for line in lines[1:]:
            if ":" not in line:
                raise ProtocolError(400, "bad_request",
                                    "malformed header line")
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
        if "transfer-encoding" in headers:
            raise ProtocolError(400, "bad_request",
                                "chunked bodies not supported")
        body = b""
        if method in ("POST", "PUT"):
            cl = headers.get("content-length")
            if cl is None or not cl.isdigit():
                raise ProtocolError(400, "bad_request",
                                    "Content-Length required")
            n = int(cl)
            if n > lim.max_body_bytes:
                raise ProtocolError(
                    413, "too_large",
                    f"body {n}B over cap {lim.max_body_bytes}B")
            while len(buf) < n:
                left = deadline - self._clock()
                if left <= 0:
                    raise ProtocolError(408, "slow_client",
                                        "body not received in time")
                buf += self._recv(conn, left)
            body = bytes(buf[:n])
            del buf[:n]
        return method, path, headers, body

    # -- response plumbing ---------------------------------------------------

    @staticmethod
    def _head(status: int, length: int, ctype: str, keep: bool,
              retry_after_s: float | None = None) -> bytes:
        lines = [
            f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'Unknown')}",
            f"Content-Type: {ctype}",
            f"Content-Length: {length}",
            f"Connection: {'keep-alive' if keep else 'close'}",
        ]
        if retry_after_s is not None:
            # RFC 7231 allows only integer seconds; keep sub-second
            # precision in the JSON body, round up here so a compliant
            # client never retries early
            lines.append(f"Retry-After: {max(0, int(retry_after_s + 0.999))}")
            lines.append(f"X-Retry-After-S: {retry_after_s:.6f}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    def _send(self, conn, status: int, body: bytes, ctype: str, keep: bool,
              retry_after_s: float | None = None) -> None:
        conn.settimeout(self.limits.write_timeout_s)
        try:
            conn.sendall(self._head(status, len(body), ctype, keep,
                                    retry_after_s) + body)
        except (OSError, socket.timeout):
            raise _Disconnect() from None

    def _send_json(self, conn, status: int, obj: dict, keep: bool,
                   retry_after_s: float | None = None) -> None:
        self._send(conn, status, json.dumps(obj).encode(),
                   "application/json", keep, retry_after_s)

    def _send_error(self, conn, route: str, err: ProtocolError,
                    keep: bool) -> None:
        self._count(route, err.status, err.reason)
        self._send_json(conn, err.status, err.body(), keep,
                        err.retry_after_s)

    def _count(self, route: str, status: int, reason: str | None) -> None:
        if self._metrics is None:
            return
        self._m_req.labels(route=route, status=str(status)).inc()
        if reason is not None and status >= 400:
            self._m_rej.labels(reason=reason).inc()

    # -- routing -------------------------------------------------------------

    _ROUTES = {"/healthz": "healthz", "/readyz": "readyz",
               "/metrics": "metrics", "/v1/config": "config",
               "/v1/session": "session", "/v1/window": "window"}

    def _dispatch(self, conn, method: str, path: str, body: bytes,
                  keep: bool) -> bool:
        path = path.split("?", 1)[0]
        route = self._ROUTES.get(path) or (
            "session" if path.startswith("/v1/session/") else "other")
        t0 = time.perf_counter()
        try:
            handler = getattr(self, f"_h_{route}", None)
            if handler is None:
                raise ProtocolError(404, "bad_request",
                                    f"no route {path!r}")
            handler(conn, method, path, body, keep)
        except ProtocolError as e:
            self._send_error(conn, route, e, keep)
            if e.status in (408, 413):
                keep = False    # the request stream is desynchronized
        except _Disconnect:
            raise
        except Exception as e:   # noqa: BLE001 — typed outcome, not a crash
            if self._flight is not None:
                self._flight.record(event="gateway_internal_error",
                                    route=route,
                                    error=f"{type(e).__name__}: {e}")
            self._send_error(conn, route, ProtocolError(
                500, "internal", f"{type(e).__name__}"), keep)
        finally:
            if self._m_hist is not None:
                self._m_hist.labels(route=route).observe(
                    time.perf_counter() - t0)
        return keep

    # -- endpoint handlers ---------------------------------------------------

    def _front_health(self) -> dict:
        h = getattr(self._front, "health", None)
        if callable(h):
            return h()
        return {"ready": True, "recovering": False, "terminal": False,
                "restarts": 0, "degraded": False}

    def _dead_reason(self) -> str:
        """503 reason for an EngineDead: ``recovering`` only when the
        front can actually recover (a supervisor with restarts left)."""
        state = self._front_health()
        if state.get("terminal") or \
                not callable(getattr(self._front, "heal", None)):
            return "engine_dead"
        return "recovering"

    def _front_retry_s(self) -> float:
        r = getattr(self._front, "retry_after_s", None)
        if callable(r):
            try:
                return float(r())
            except Exception:   # noqa: BLE001
                pass
        return self.limits.poll_interval_s * 2

    def _h_healthz(self, conn, method, path, body, keep) -> None:
        if method != "GET":
            raise ProtocolError(405, "bad_request", "GET only")
        self._count("healthz", 200, None)
        self._send_json(conn, 200, {"ok": True}, keep)

    def _h_readyz(self, conn, method, path, body, keep) -> None:
        if method != "GET":
            raise ProtocolError(405, "bad_request", "GET only")
        state = self._front_health()
        ready = bool(state.get("ready", True)) and not self._draining
        state = dict(state, draining=self._draining, ready=ready)
        status = 200 if ready else 503
        self._count("readyz", status, None)
        self._send_json(conn, status, state, keep,
                        None if ready else self._front_retry_s())

    def _h_metrics(self, conn, method, path, body, keep) -> None:
        if method != "GET":
            raise ProtocolError(405, "bad_request", "GET only")
        if self._metrics is None:
            raise ProtocolError(404, "bad_request", "metrics not armed")
        from ..obs.export import prometheus_text
        self._count("metrics", 200, None)
        self._send(conn, 200, prometheus_text(self._metrics).encode(),
                   "text/plain; version=0.0.4; charset=utf-8", keep)

    def _h_config(self, conn, method, path, body, keep) -> None:
        if method != "GET":
            raise ProtocolError(405, "bad_request", "GET only")
        self._count("config", 200, None)
        self._send_json(conn, 200, protocol.config_body(
            self._cfg, len(self._task_bank), self.limits), keep)

    def _h_session(self, conn, method, path, body, keep) -> None:
        if method == "POST" and path == "/v1/session":
            self._session_open(conn, body, keep)
        elif method == "DELETE" and path.startswith("/v1/session/"):
            self._session_close(conn, path[len("/v1/session/"):], keep)
        else:
            raise ProtocolError(405, "bad_request",
                                "POST /v1/session or DELETE "
                                "/v1/session/<tenant>/<stream>")

    def _session_open(self, conn, body: bytes, keep: bool) -> None:
        so = protocol.validate_session_open(
            protocol.parse_json_body(body), len(self._task_bank))
        sid = protocol.session_id(so.tenant, so.stream)
        from ..configs.torr_edge import rt_budget_s
        deadline_s = max(self.limits.request_deadline_s,
                         4.0 * rt_budget_s(so.rt))
        with self._glock:
            if self._draining:
                raise ProtocolError(503, "draining", "gateway is draining")
            existing = self._sessions.get(sid)
            if existing is not None:
                if existing.task != so.task or existing.rt != so.rt:
                    raise ProtocolError(
                        409, "session_exists",
                        f"{sid} already open with task={existing.task} "
                        f"rt={existing.rt}")
                self._count("session", 200, None)
                self._send_json(conn, 200, {
                    "session": sid, "slot": existing.slot,
                    "task": existing.task, "rt": existing.rt,
                    "next_seq": existing.next_seq}, keep)
                return
            wait = self._bucket(so.tenant).take(self._clock())
            if wait > 0.0:
                raise ProtocolError(429, "rate_limit",
                                    f"tenant {so.tenant} over rate",
                                    retry_after_s=wait)
            n_tenant = sum(1 for s in self._sessions.values()
                           if s.tenant == so.tenant)
            if n_tenant >= self.limits.max_sessions_per_tenant:
                raise ProtocolError(
                    429, "tenant_quota",
                    f"tenant {so.tenant} at session quota "
                    f"({self.limits.max_sessions_per_tenant})")
            state = self._front_health()
            if state.get("terminal"):
                raise ProtocolError(503, "engine_dead",
                                    "engine terminally failed")
            if state.get("recovering"):
                raise ProtocolError(503, "recovering",
                                    "engine is recovering",
                                    retry_after_s=self._front_retry_s())
            try:
                slot = self._front.admit(sid, self._task_bank[so.task])
            except EngineDead as e:
                # ordered before RuntimeError: EngineDead subclasses it
                raise ProtocolError(503, self._dead_reason(),
                                    f"engine died during admit: {e}",
                                    retry_after_s=self._front_retry_s()
                                    ) from e
            except ValueError as e:
                raise ProtocolError(409, "session_exists", str(e)) from e
            except RuntimeError as e:
                if "slot" in str(e):
                    raise ProtocolError(
                        429, "no_slot", "no free stream slots",
                        retry_after_s=self.limits.no_slot_retry_s) from e
                raise
            sess = _Session(sid=sid, tenant=so.tenant, slot=slot,
                            task=so.task, rt=so.rt, deadline_s=deadline_s)
            self._sessions[sid] = sess
            if self._metrics is not None:
                self._g_sessions.set(len(self._sessions))
        self._count("session", 200, None)
        self._send_json(conn, 200, {"session": sid, "slot": slot,
                                    "task": so.task, "rt": so.rt,
                                    "next_seq": 0}, keep)

    def _session_close(self, conn, sid: str, keep: bool) -> None:
        protocol.split_session_id(sid)
        with self._glock:
            sess = self._sessions.pop(sid, None)
            if self._metrics is not None:
                self._g_sessions.set(len(self._sessions))
        if sess is None:
            raise ProtocolError(404, "no_session", f"{sid} not open")
        with sess.lock:
            for fut in sess.parked.values():
                fut.cancel()
            sess.parked.clear()
        try:
            self._front.retire(sid)
        except (EngineDead, KeyError):
            pass    # a rebuilt engine simply won't re-admit it
        self._count("session", 200, None)
        self._send_json(conn, 200, {"closed": sid}, keep)

    def _h_window(self, conn, method, path, body, keep) -> None:
        if method != "POST":
            raise ProtocolError(405, "bad_request", "POST only")
        wr = protocol.validate_window(protocol.parse_json_body(body),
                                      self._cfg)
        with self._glock:
            if self._draining:
                raise ProtocolError(503, "draining", "gateway is draining")
            sess = self._sessions.get(wr.session)
            if sess is None:
                raise ProtocolError(404, "no_session",
                                    f"{wr.session} not open")
            wait = self._bucket(sess.tenant).take(self._clock())
        if wait > 0.0:
            raise ProtocolError(429, "rate_limit",
                                f"tenant {sess.tenant} over rate",
                                retry_after_s=wait)
        state = self._front_health()
        if state.get("terminal"):
            raise ProtocolError(503, "engine_dead",
                                "engine terminally failed")
        if state.get("recovering"):
            raise ProtocolError(503, "recovering", "engine is recovering",
                                retry_after_s=self._front_retry_s())
        deadline_s = wr.deadline_s or sess.deadline_s
        with sess.lock:
            self._window_locked(conn, sess, wr, deadline_s, keep)

    def _window_locked(self, conn, sess: _Session, wr, deadline_s: float,
                       keep: bool) -> None:
        seq = wr.seq
        if seq == sess.next_seq:
            try:
                # the wire's uint32 words as the port's int32 bit patterns
                # (a view: a word >= 2**31 crosses unchanged)
                fut = self._front.submit(sess.sid, wr.q.view(np.int32),
                                         wr.valid, wr.boxes)
            except KeyError:
                raise ProtocolError(404, "no_session",
                                    f"{sess.sid} lost its slot") from None
            except WindowShed as e:
                raise ProtocolError(429, "shed", str(e),
                                    retry_after_s=e.retry_after_s) from e
            except EngineDead as e:
                raise ProtocolError(503, self._dead_reason(),
                                    f"engine died on submit: {e}",
                                    retry_after_s=self._front_retry_s()
                                    ) from e
            sess.next_seq += 1
            self._settle(conn, sess, seq, fut, deadline_s, keep)
        elif seq == sess.next_seq - 1 and seq in sess.parked:
            fut = sess.parked.pop(seq)
            self._settle(conn, sess, seq, fut, deadline_s, keep)
        elif seq == sess.next_seq - 1 and seq == sess.cached_seq:
            # idempotent retry of the newest completed window
            self._count("window", 200, None)
            self._send(conn, 200, sess.cached_body, "application/json",
                       keep)
        elif seq == sess.next_seq - 1:
            raise ProtocolError(
                409, "seq_consumed",
                f"seq {seq} was consumed but its result is gone "
                "(disconnected mid-flight?); resume at "
                f"seq {sess.next_seq}")
        else:
            raise ProtocolError(
                409, "out_of_order",
                f"expected seq {sess.next_seq}, got {seq}")

    def _settle(self, conn, sess: _Session, seq: int, fut: Future,
                deadline_s: float, keep: bool) -> None:
        """Wait for one submitted window's future, watching the client
        socket for liveness; every exit is a typed outcome."""
        t_end = self._clock() + deadline_s
        poll = self.limits.poll_interval_s
        while True:
            try:
                wout, _wtel = fut.result(timeout=poll)
                break
            except FutureTimeout:
                pass
            except CancelledError:
                raise ProtocolError(503, "draining",
                                    "window cancelled during drain"
                                    ) from None
            except WindowShed as e:
                # shed windows never advanced engine state: roll the
                # sequence back so the client's retry of the same seq is
                # a fresh, bit-safe submission
                if seq == sess.next_seq - 1:
                    sess.next_seq -= 1
                raise ProtocolError(429, "shed", str(e),
                                    retry_after_s=e.retry_after_s) from e
            except EngineDead as e:
                raise ProtocolError(503, self._dead_reason(), str(e),
                                    retry_after_s=self._front_retry_s()
                                    ) from e
            except Exception as e:   # noqa: BLE001
                raise ProtocolError(500, "internal",
                                    f"{type(e).__name__}") from e
            if self._clock() >= t_end:
                self._park(sess, seq, fut)
                raise ProtocolError(
                    503, "deadline",
                    f"window {seq} still in flight after "
                    f"{deadline_s * 1e3:.0f} ms; retry the same seq to "
                    "collect it", retry_after_s=self._front_retry_s())
            if not _client_alive(conn):
                # the window may already have advanced engine state, so
                # the seq stays consumed; the engine/supervisor accounts
                # the cancelled delivery in torr_telemetry_dropped_total
                if not fut.cancel() and fut.done() \
                        and fut.exception() is None:
                    self._cache(sess, seq, fut.result()[0])
                if self._metrics is not None:
                    self._m_disc.inc()
                    self._m_rej.labels(reason="disconnect").inc()
                raise _Disconnect()
        body = json.dumps(
            protocol.window_result_body(seq, wout)).encode()
        sess.cached_seq, sess.cached_body = seq, body
        self._count("window", 200, None)
        self._send(conn, 200, body, "application/json", keep)

    def _cache(self, sess: _Session, seq: int, wout) -> None:
        sess.cached_seq = seq
        sess.cached_body = json.dumps(
            protocol.window_result_body(seq, wout)).encode()

    def _park(self, sess: _Session, seq: int, fut: Future) -> None:
        sess.parked[seq] = fut
        while len(sess.parked) > self.limits.max_parked:
            _old_seq, old = sess.parked.popitem(last=False)
            old.cancel()

    def _bucket(self, tenant: str) -> _TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = _TokenBucket(
                self.limits.rate_per_s, self.limits.burst, self._clock())
        return b

    # -- introspection -------------------------------------------------------

    def summary(self) -> dict:
        with self._glock:
            return {
                "port": self.port,
                "sessions": len(self._sessions),
                "connections": len(self._conns),
                "active_requests": self._active_requests,
                "draining": self._draining,
            }


def _client_alive(conn) -> bool:
    """True while the client socket is readable-empty or quiet. A peer
    close shows as readable-with-EOF; buffered pipelined bytes count as
    alive (they stay queued — requests are served serially)."""
    try:
        r, _, _ = select.select([conn], [], [], 0)
        if not r:
            return True
        return conn.recv(1, socket.MSG_PEEK) != b""
    except (BlockingIOError, InterruptedError):
        return True
    except OSError:
        return False
