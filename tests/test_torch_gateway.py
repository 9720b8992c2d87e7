"""Port parity: the network gateway and its wire protocol
(``repro_torch.serving.gateway``, ``repro_torch.serving.protocol``) against
``repro``'s.

Mirrors ``tests/test_gateway.py`` over the port: the happy path and
idempotent retries, the malformed-frame battery (400s, and the gateway
keeps serving), 413, the slow-loris read deadline, rate limits and quotas
(429 with Retry-After, the request ledger reconciling), shed windows
rolling the sequence back, deadline parking, a mid-flight disconnect,
engine death as a 503, drain, the ``SyncDriver`` front, a supervised
engine's crash recovery seen from the socket, and SIGTERM draining the
launcher's gateway to exit 0. Then parity: the same scripted sessions and
windows through ``repro``'s gateway and the port's (both on ephemeral
ports) give identical status lines, retry headers and JSON bodies, errors
included, over a scripted front and over real engines; and the two
``protocol`` modules agree on every malformed frame.

Every socket, subprocess, ``result`` and ``flush`` has a timeout, and
every gateway, engine and driver is closed in a ``finally``.
"""
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from concurrent.futures import Future
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro.runtime.fault import EngineDead as JEngineDead
from repro.serving import gateway as jgateway
from repro.serving import protocol as jprotocol
from repro.serving.async_engine import AsyncStreamEngine as JAsync
from repro.serving.deadline import WindowShed as JWindowShed
from repro_torch.obs import MetricsRegistry
from repro_torch.runtime.fault import EngineDead, FaultPlan
from repro_torch.serving import gateway, protocol
from repro_torch.serving.async_engine import AsyncStreamEngine
from repro_torch.serving.deadline import WindowShed
from repro_torch.serving.gateway import SyncDriver
from repro_torch.serving.state_store import InMemoryStateStore
from repro_torch.serving.stream_engine import StreamEngine
from repro_torch.serving.supervisor import ServeSupervisor

from test_torch_engine import JCFG, TCFG, _make_inputs, _memories

CFG = TCFG
SRC = str(Path(__file__).resolve().parents[1] / "src")
FLUSH_S = 120


# --- plumbing ---------------------------------------------------------------

class _FakeFront:
    """Minimal admit/submit/retire front with scriptable outcomes (no
    health/heal: the gateway falls back to its defaults). ``dead`` and
    ``shed`` are the package's EngineDead and WindowShed."""

    def __init__(self, n_slots=4, dead=EngineDead, shed=WindowShed):
        self.n_slots = n_slots
        self.slots = {}
        self.futures = []
        self.mode = "ok"            # ok | pending | shed | dead
        self.shed_retry_s = 0.7
        self._n = 0
        self._dead, self._shed = dead, shed

    def admit(self, sid, task_w, snapshot=None):
        if self.mode == "dead":
            raise self._dead(RuntimeError("boom"), 0, "disp")
        if len(self.slots) >= self.n_slots:
            raise RuntimeError("no free stream slot")
        self.slots[sid] = slot = len(self.slots)
        return slot

    def retire(self, sid):
        del self.slots[sid]

    def submit(self, sid, q, valid, boxes):
        fut = Future()
        self._n += 1
        if self.mode == "ok":
            wout = SimpleNamespace(
                best=[self._n, 0], scores=np.full((4,), self._n, np.float32))
            fut.set_result((wout, {}))
        elif self.mode == "shed":
            fut.set_exception(self._shed(sid, 0.01,
                                         retry_after_s=self.shed_retry_s))
        elif self.mode == "dead":
            fut.set_exception(self._dead(RuntimeError("boom"), 1, "disp"))
        self.futures.append(fut)
        return fut


def _gw(front=None, module=gateway, registry=MetricsRegistry, **limit_kw):
    reg = registry()
    limits = module.GatewayLimits(**limit_kw)
    task_bank = np.eye(4, CFG.M, dtype=np.float32)
    gw = module.Gateway(front if front is not None else _FakeFront(), CFG,
                        task_bank, limits=limits, metrics=reg, port=0)
    gw.start()
    return gw, reg


def _req(port, method, path, body=None, timeout=15.0, raw=None):
    """One-shot request; returns (status, headers_lowercase, parsed_body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = raw if raw is not None else (
            json.dumps(body).encode() if body is not None else None)
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"}
                     if data else {})
        r = conn.getresponse()
        rawb = r.read()
        hdr = {k.lower(): v for k, v in r.getheaders()}
        try:
            return r.status, hdr, json.loads(rawb)
        except ValueError:
            return r.status, hdr, rawb
    finally:
        conn.close()


def _open_session(port, tenant="t0", stream="s0", task=0, rt="RT-60"):
    st, _, body = _req(port, "POST", "/v1/session",
                       {"tenant": tenant, "stream": stream, "task": task,
                        "rt": rt})
    assert st == 200, body
    return body


def _frame(seed=0, deadline_ms=None, session="t0/s0", seq=0, q=None,
           valid=None, boxes=None):
    rng = np.random.default_rng(seed)
    body = {
        "session": session, "seq": seq,
        "q": protocol.encode_array(rng.integers(
            0, 1 << 32, (CFG.N_max, CFG.words), dtype=np.uint32)
            if q is None else q),
        "valid": protocol.encode_array(np.ones(CFG.N_max, bool)
                                       if valid is None else valid),
        "boxes": protocol.encode_array(
            rng.random((CFG.N_max, 4)).astype(np.float32)
            if boxes is None else boxes),
    }
    if deadline_ms is not None:
        body["deadline_ms"] = deadline_ms
    return body


# --- happy path + idempotency ----------------------------------------------

def test_config_health_and_session_roundtrip():
    gw, _ = _gw()
    try:
        st, _, cfg = _req(gw.port, "GET", "/v1/config")
        assert st == 200
        assert cfg["N_max"] == CFG.N_max and cfg["words"] == CFG.words
        assert cfg["n_tasks"] == 4 and "limits" in cfg
        assert _req(gw.port, "GET", "/healthz")[0] == 200
        st, _, state = _req(gw.port, "GET", "/readyz")
        assert st == 200 and state["ready"] is True

        body = _open_session(gw.port)
        assert body["slot"] == 0 and body["next_seq"] == 0
        assert _open_session(gw.port)["slot"] == 0      # idempotent
        st, _, b = _req(gw.port, "POST", "/v1/session",
                        {"tenant": "t0", "stream": "s0", "task": 1})
        assert st == 409 and b["error"] == "session_exists"

        st, _, first = _req(gw.port, "POST", "/v1/window", _frame(seq=0))
        assert st == 200 and first["seq"] == 0
        assert re.fullmatch(r"[0-9a-f]{64}", first["scores_sha256"])
        st, _, replay = _req(gw.port, "POST", "/v1/window", _frame(seq=0))
        assert st == 200 and replay == first
        st, _, b = _req(gw.port, "POST", "/v1/window", _frame(seq=5))
        assert st == 409 and b["error"] == "out_of_order"
        assert "expected seq 1" in b["detail"]

        st, _, b = _req(gw.port, "DELETE", "/v1/session/t0/s0")
        assert st == 200 and b["closed"] == "t0/s0"
        st, _, b = _req(gw.port, "POST", "/v1/window", _frame(seq=1))
        assert st == 404 and b["error"] == "no_session"
    finally:
        gw.close()


def _malformed(good):
    """The malformed-frame battery: (frame, field named in the detail)."""
    cases = []
    f = dict(good)
    del f["q"]
    cases.append((f, "q"))
    cases.append((dict(good, seq=True), "seq"))
    cases.append((dict(good, seq=-1), "seq"))
    cases.append((dict(good, session="not-a-session-id"), "session"))
    cases.append((dict(good, deadline_ms=0), "deadline_ms"))
    cases.append((dict(good, q=dict(good["q"], dtype="float32")), "q"))
    cases.append((dict(good, q=dict(good["q"], dtype="int32")), "q"))
    cases.append((dict(good, q=dict(good["q"], shape=[1, 1])), "q"))
    cases.append((dict(good, q=dict(good["q"],
                                    data=good["q"]["data"][:8])), "q"))
    cases.append((dict(good, q=dict(good["q"], data="!!!not base64!!!")),
                  "q"))
    cases.append((dict(good, boxes=protocol.encode_array(
        np.full((CFG.N_max, 4), np.nan, np.float32))), "boxes"))
    cases.append((dict(good, valid=protocol.encode_array(
        np.ones(CFG.N_max, np.uint8))), "valid"))
    cases.append((dict(good, q=[1, 2]), "q"))
    return cases


def test_malformed_frames_are_400s_and_the_gateway_survives():
    gw, _ = _gw()
    try:
        _open_session(gw.port)
        good = _frame(seq=0)
        for raw in (b"{nope", b"", b"[1,2]", b'"str"'):
            st, _, b = _req(gw.port, "POST", "/v1/window", raw=raw)
            assert st == 400, (raw, b)
            assert b["error"] in ("bad_request", "bad_frame")
        for frame, field in _malformed(good):
            st, _, b = _req(gw.port, "POST", "/v1/window", frame)
            assert st == 400, (field, st, b)
            assert field in b["detail"] or b["error"] == "bad_frame", b
        assert _req(gw.port, "GET", "/v1/nope")[0] == 404
        assert _req(gw.port, "DELETE", "/v1/window", good)[0] == 405
        s = socket.create_connection(("127.0.0.1", gw.port), timeout=5)
        try:
            s.sendall(b"GARBAGE\r\n\r\n")
            resp = s.recv(4096)
        finally:
            s.close()
        assert b"400" in resp.split(b"\r\n", 1)[0]
        st, _, b = _req(gw.port, "POST", "/v1/window", good)
        assert st == 200 and b["seq"] == 0
    finally:
        gw.close()


def test_oversized_body_is_413():
    gw, _ = _gw(max_body_bytes=1024)
    try:
        _open_session(gw.port)
        st, hdr, b = _req(gw.port, "POST", "/v1/window", _frame(seq=0))
        assert st == 413 and b["error"] == "too_large"
        assert hdr.get("connection") == "close"
        assert _req(gw.port, "GET", "/healthz")[0] == 200
    finally:
        gw.close()


def test_slow_loris_hits_the_read_deadline():
    gw, _ = _gw(read_timeout_s=0.3)
    try:
        t0 = time.monotonic()
        s = socket.create_connection(("127.0.0.1", gw.port), timeout=10)
        try:
            s.sendall(b"POST /v1/window HTTP/1.1\r\nContent-")   # stall
            resp = s.recv(4096)
        finally:
            s.close()
        assert b"408" in resp.split(b"\r\n", 1)[0], resp
        assert time.monotonic() - t0 < 5.0
        s = socket.create_connection(("127.0.0.1", gw.port), timeout=10)
        try:
            s.sendall(b"POST /v1/window HTTP/1.1\r\n"
                      b"Content-Length: 1000\r\n\r\n" + b"x" * 100)
            resp = s.recv(4096)
        finally:
            s.close()
        assert b"408" in resp.split(b"\r\n", 1)[0], resp
        assert _req(gw.port, "GET", "/healthz")[0] == 200
    finally:
        gw.close()


# --- overload: rate limits, quotas, shed -----------------------------------

def test_rate_limit_429_with_retry_after_and_ledger_reconcile():
    gw, reg = _gw(rate_per_s=0.5, burst=3)
    try:
        _open_session(gw.port)          # consumes 1 token
        statuses, hints = [], []
        for seq in (0, 1, 2, 3):
            st, hdr, b = _req(gw.port, "POST", "/v1/window", _frame(seq=seq))
            statuses.append(st)
            if st == 429:
                assert b["error"] == "rate_limit"
                assert int(hdr["retry-after"]) >= 1
                hints.append(float(hdr["x-retry-after-s"]))
                assert b["retry_after_s"] == pytest.approx(hints[-1],
                                                           abs=1e-4)
        assert statuses[:2] == [200, 200] and 429 in statuses
        assert all(h <= int(h + 0.999) for h in hints)
        snap = reg.snapshot()["torr_gateway_requests_total"]["series"]
        server = {(s["labels"]["route"], s["labels"]["status"]): s["value"]
                  for s in snap}
        assert server[("window", "200")] == statuses.count(200)
        assert server[("window", "429")] == statuses.count(429)
        assert server[("session", "200")] == 1
    finally:
        gw.close()


def test_tenant_quota_and_slot_exhaustion_are_429s():
    gw, _ = _gw(front=_FakeFront(n_slots=2), max_sessions_per_tenant=1)
    try:
        _open_session(gw.port, tenant="a", stream="s0")
        st, _, b = _req(gw.port, "POST", "/v1/session",
                        {"tenant": "a", "stream": "s1", "task": 0})
        assert st == 429 and b["error"] == "tenant_quota"
        _open_session(gw.port, tenant="b", stream="s0")
        st, hdr, b = _req(gw.port, "POST", "/v1/session",
                          {"tenant": "c", "stream": "s0", "task": 0})
        assert st == 429 and b["error"] == "no_slot"
        assert "retry-after" in hdr
    finally:
        gw.close()


def test_shed_rolls_back_seq_and_propagates_the_hint():
    front = _FakeFront()
    gw, reg = _gw(front=front)
    try:
        _open_session(gw.port)
        front.mode = "shed"
        st, hdr, b = _req(gw.port, "POST", "/v1/window", _frame(seq=0))
        assert st == 429 and b["error"] == "shed"
        assert float(hdr["x-retry-after-s"]) == pytest.approx(0.7)
        assert int(hdr["retry-after"]) == 1
        front.mode = "ok"
        st, _, b = _req(gw.port, "POST", "/v1/window", _frame(seq=0))
        assert st == 200 and b["seq"] == 0
        snap = reg.snapshot()["torr_gateway_rejects_total"]["series"]
        reasons = {s["labels"]["reason"]: s["value"] for s in snap}
        assert reasons.get("shed") == 1
    finally:
        gw.close()


# --- deadlines, parking, disconnects ---------------------------------------

def test_deadline_503_parks_and_the_same_seq_collects():
    front = _FakeFront()
    front.mode = "pending"
    gw, _ = _gw(front=front, request_deadline_s=0.2, poll_interval_s=0.02)
    try:
        _open_session(gw.port)
        t0 = time.monotonic()
        st, hdr, b = _req(gw.port, "POST", "/v1/window",
                          _frame(seq=0, deadline_ms=200))
        assert st == 503 and b["error"] == "deadline"
        assert "retry the same seq" in b["detail"]
        assert 0.15 < time.monotonic() - t0 < 5.0
        wout = SimpleNamespace(best=[7, 7], scores=np.zeros(4, np.float32))
        front.futures[-1].set_result((wout, {}))
        st, _, b = _req(gw.port, "POST", "/v1/window",
                        _frame(seq=0, deadline_ms=200))
        assert st == 200 and b["seq"] == 0 and b["best"] == [7, 7]
        st, _, b2 = _req(gw.port, "POST", "/v1/window",
                         _frame(seq=0, deadline_ms=200))
        assert st == 200 and b2 == b
    finally:
        gw.close()


def test_mid_flight_disconnect_cancels_and_consumes_the_seq():
    front = _FakeFront()
    front.mode = "pending"
    gw, reg = _gw(front=front, request_deadline_s=30.0,
                  poll_interval_s=0.02)
    try:
        _open_session(gw.port)
        frame = json.dumps(_frame(seq=0)).encode()
        s = socket.create_connection(("127.0.0.1", gw.port), timeout=10)
        try:
            s.sendall(b"POST /v1/window HTTP/1.1\r\n"
                      b"Content-Type: application/json\r\n"
                      + f"Content-Length: {len(frame)}\r\n\r\n".encode()
                      + frame)
            for _ in range(200):
                if front.futures:
                    break
                time.sleep(0.01)
            assert front.futures
            time.sleep(0.1)
        finally:
            s.close()
        for _ in range(300):
            if front.futures[0].cancelled():
                break
            time.sleep(0.01)
        assert front.futures[0].cancelled()
        snap = reg.snapshot()
        assert snap["torr_gateway_disconnects_total"]["series"][0][
            "value"] >= 1
        reasons = {x["labels"]["reason"]: x["value"]
                   for x in snap["torr_gateway_rejects_total"]["series"]}
        assert reasons.get("disconnect", 0) >= 1
        st, _, b = _req(gw.port, "POST", "/v1/window", _frame(seq=0))
        assert st == 409 and b["error"] == "seq_consumed"
        assert "resume at seq 1" in b["detail"]
        front.mode = "ok"
        st, _, b = _req(gw.port, "POST", "/v1/window", _frame(seq=1))
        assert st == 200 and b["seq"] == 1
    finally:
        gw.close()


def test_engine_dead_is_a_503_and_the_gateway_stays_up():
    front = _FakeFront()
    gw, _ = _gw(front=front)
    try:
        _open_session(gw.port)
        front.mode = "dead"
        st, _, b = _req(gw.port, "POST", "/v1/window", _frame(seq=0))
        assert st == 503 and b["error"] == "engine_dead"
        assert _req(gw.port, "GET", "/healthz")[0] == 200
        st, _, b = _req(gw.port, "POST", "/v1/session",
                        {"tenant": "t9", "stream": "s0", "task": 0})
        assert st == 503 and b["error"] == "engine_dead"
    finally:
        gw.close()


def test_drain_refuses_new_work_and_reports_not_ready():
    gw, reg = _gw()
    try:
        _open_session(gw.port)
        assert gw.drain(timeout=5.0) is True
        assert gw.summary()["draining"] is True
        try:
            st, _, b = _req(gw.port, "GET", "/readyz", timeout=5)
            assert st == 503 and b["error"] == "draining", (st, b)
        except OSError:
            pass
        snap = reg.snapshot()
        assert snap["torr_gateway_draining"]["series"][0]["value"] == 1
    finally:
        gw.close()


# --- real engines behind the gateway ---------------------------------------

def test_sync_driver_front_serves_windows():
    im, _ = _memories()
    eng = StreamEngine(CFG, im, n_slots=2, device="cpu")
    front = SyncDriver(eng)
    gw = None
    try:
        gw, _ = _gw(front=front, request_deadline_s=60.0)
        _open_session(gw.port)
        for seq in range(3):
            st, _, b = _req(gw.port, "POST", "/v1/window",
                            _frame(seed=seq, seq=seq), timeout=120)
            assert st == 200 and b["seq"] == seq
            assert re.fullmatch(r"[0-9a-f]{64}", b["scores_sha256"])
        st, _, b = _req(gw.port, "DELETE", "/v1/session/t0/s0")
        assert st == 200
    finally:
        if gw is not None:
            gw.close()
        front.close()


def _drive_through_gateway(port, n_windows, deadline_ms=None):
    """Serial client with bounded Retry-After-honouring retries; returns
    (bodies, statuses_seen)."""
    bodies, seen = [], []
    seq = 0
    for w in range(n_windows):
        frame = _frame(seed=1000 + w, seq=seq, deadline_ms=deadline_ms)
        for _attempt in range(400):
            st, hdr, b = _req(port, "POST", "/v1/window", frame, timeout=120)
            seen.append(st)
            if st == 200:
                bodies.append(b)
                seq += 1
                break
            assert st in (429, 503), (st, b)
            time.sleep(min(float(hdr.get("x-retry-after-s", 0.05)), 0.5))
        else:
            raise AssertionError(f"window {w} never served: {seen[-5:]}")
    return bodies, seen


def _supervised_gateway_run(fault, backoff_s, n_windows):
    im, _ = _memories()
    store = InMemoryStateStore()

    def make_engine():
        return AsyncStreamEngine(CFG, im, n_slots=2, paused=True,
                                 store=store, snapshot_every=1,
                                 fault_plan=fault, device="cpu")

    sup = ServeSupervisor(make_engine, store, backoff_s=backoff_s)
    gw = None
    try:
        sup.engine.warmup()
        sup.engine.start()
        gw, _ = _gw(front=sup, request_deadline_s=0.25,
                    poll_interval_s=0.02)
        _open_session(gw.port)
        bodies, seen = _drive_through_gateway(gw.port, n_windows,
                                              deadline_ms=250)
    finally:
        if gw is not None:
            gw.drain(timeout=5.0)
            gw.close()
        sup.close(drain=False)
    assert sup.join_abandoned(timeout=30)
    return bodies, seen, sup.summary()


def test_gateway_chaos_recovery_bit_identical():
    """An injected dispatcher death under the supervisor, seen from the
    socket: the client gets recovery-aware 503s, retries the same seq,
    and the responses equal a fault-free run's."""
    n_windows = 8
    ref, _seen, _ = _supervised_gateway_run(None, 0.02, n_windows)
    got, seen, summary = _supervised_gateway_run(
        FaultPlan(at_step=3, thread="dispatcher"), 0.6, n_windows)
    assert summary["restarts"] == 1, summary
    assert any(s == 503 for s in seen), seen
    assert [b["seq"] for b in got] == list(range(n_windows))
    assert got == ref


def _launcher_env():
    return dict(os.environ, PYTHONPATH=SRC, PYTHONUNBUFFERED="1")


def test_sigterm_drains_and_exits_zero():
    """SIGTERM mid-traffic: the launcher's gateway drains in-flight work,
    and the process exits 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--gateway-port", "0", "--supervise", "--torr-slots", "2"],
        env=_launcher_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    port = None
    try:
        t0 = time.time()
        while time.time() - t0 < 120:
            line = proc.stdout.readline()
            m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
            if not line and proc.poll() is not None:
                break
        assert port, "no gateway handshake"
        _open_session(port)
        st, _, cfg = _req(port, "GET", "/v1/config")
        assert st == 200, cfg
        rng = np.random.default_rng(0)
        frame = {
            "session": "t0/s0", "seq": 0,
            "q": protocol.encode_array(rng.integers(
                0, 1 << 32, (cfg["N_max"], cfg["words"]), dtype=np.uint32)),
            "valid": protocol.encode_array(np.ones(cfg["N_max"], bool)),
            "boxes": protocol.encode_array(
                rng.random((cfg["N_max"], 4)).astype(np.float32)),
        }
        st, _, b = _req(port, "POST", "/v1/window", frame, timeout=120)
        assert st == 200, b
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out[-3000:]
        assert "drained=True" in out and "exit 0" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_run_torr_gateway_in_process_sync_driver():
    """``run_torr_gateway(use_async=False)`` for a bounded window: the
    ``SyncDriver`` path starts, serves nothing, drains and returns."""
    from repro_torch.launch import serve
    res = serve.run_torr_gateway(n_slots=1, use_async=False,
                                 run_seconds=0.2, device="cpu",
                                 metrics_json="")
    assert res["drained"] is True and res["supervisor"] is None


# --- parity with repro's gateway --------------------------------------------

def _script(port, front):
    """A scripted client session; every response as (status, retry
    headers, connection header, body)."""
    out = []

    def rec(method, path, body=None, raw=None):
        st, hdr, b = _req(port, method, path, body, raw=raw)
        out.append((st, hdr.get("retry-after"), hdr.get("x-retry-after-s"),
                    hdr.get("connection"), b))

    rec("GET", "/v1/config")
    rec("GET", "/healthz")
    rec("GET", "/readyz")
    rec("POST", "/v1/session", {"tenant": "t0", "stream": "s0", "task": 0})
    rec("POST", "/v1/session", {"tenant": "t0", "stream": "s0", "task": 0})
    rec("POST", "/v1/session", {"tenant": "t0", "stream": "s0", "task": 1})
    rec("POST", "/v1/session", {"tenant": "t0", "stream": "s1", "task": 9})
    rec("POST", "/v1/session", {"tenant": "bad id", "stream": "s1",
                                "task": 0})
    rec("POST", "/v1/window", _frame(seq=0))
    rec("POST", "/v1/window", _frame(seq=0))
    rec("POST", "/v1/window", _frame(seq=4))
    for raw in (b"{nope", b"[1,2]"):
        rec("POST", "/v1/window", raw=raw)
    for frame, _field in _malformed(_frame(seq=1)):
        rec("POST", "/v1/window", frame)
    front.mode = "shed"
    rec("POST", "/v1/window", _frame(seq=1))
    front.mode = "dead"
    rec("POST", "/v1/window", _frame(seq=1))
    front.mode = "ok"
    rec("POST", "/v1/window", _frame(seq=1))
    rec("GET", "/v1/nope")
    rec("DELETE", "/v1/window")
    rec("DELETE", "/v1/session/t0/s0")
    rec("DELETE", "/v1/session/t0/s0")
    rec("POST", "/v1/window", _frame(seq=2))
    return out


def test_scripted_session_bodies_equal_repro():
    """The same scripted requests through repro's gateway and the port's,
    each over its package's scripted front: identical statuses, retry
    headers and bodies, errors included."""
    from repro.obs import MetricsRegistry as JRegistry
    runs = []
    for module, front, reg in (
            (jgateway, _FakeFront(dead=JEngineDead, shed=JWindowShed),
             JRegistry),
            (gateway, _FakeFront(), MetricsRegistry)):
        gw, _ = _gw(front=front, module=module, registry=reg)
        try:
            runs.append(_script(gw.port, front))
        finally:
            gw.close()
    jrun, trun = runs
    assert len(jrun) == len(trun)
    for i, (j, t) in enumerate(zip(jrun, trun)):
        assert j == t, (i, j, t)


def test_engine_bodies_equal_repro():
    """Two sessions over real engines, windows posted in seq order with
    words >= 2**31 on the wire: repro's gateway over its async engine and
    the port's over its own return identical response bodies."""
    from repro.obs import MetricsRegistry as JRegistry
    im, jm = _memories()
    S, T = 2, 3
    steps = _make_inputs(CFG, S, T)
    bodies = []
    for module, make, reg in (
            (jgateway, lambda: JAsync(JCFG, jm, n_slots=S), JRegistry),
            (gateway, lambda: AsyncStreamEngine(CFG, im, n_slots=S,
                                                device="cpu"),
             MetricsRegistry)):
        eng = make()
        gw = None
        got = []
        try:
            gw, _ = _gw(front=eng, module=module, registry=reg,
                        request_deadline_s=60.0)
            for s in range(S):
                _open_session(gw.port, stream=f"s{s}", task=s)
            for t, (q, valid, boxes, _qd) in enumerate(steps):
                assert (q >= 2**31).any()
                for s in range(S):
                    st, _, b = _req(gw.port, "POST", "/v1/window", _frame(
                        session=f"t0/s{s}", seq=t, q=q[s], valid=valid[s],
                        boxes=boxes[s]), timeout=120)
                    got.append((st, b))
        finally:
            if gw is not None:
                gw.close()
            eng.close()
        bodies.append(got)
    assert all(st == 200 for st, _ in bodies[1])
    assert bodies[0] == bodies[1]


def test_protocol_parity_on_malformed_frames():
    """The two ``protocol`` modules accept and refuse the same frames with
    the same status, reason and detail, and decode the same arrays."""
    good = _frame(seq=3, deadline_ms=125)
    frames = [good] + [f for f, _ in _malformed(good)] + [
        dict(good, deadline_ms=True), dict(good, deadline_ms=600_001),
        dict(good, session=5), dict(good, session="a/b/c"), [1], "x"]

    def outcome(mod, frame, cfg):
        try:
            wr = mod.validate_window(frame, cfg)
        except mod.ProtocolError as e:
            return ("error", e.status, e.reason, e.detail, e.body())
        return ("ok", wr.session, wr.seq, wr.q.dtype.str, wr.q.tobytes(),
                wr.valid.tobytes(), wr.boxes.tobytes(), wr.deadline_s)

    for i, frame in enumerate(frames):
        assert outcome(protocol, frame, CFG) == \
            outcome(jprotocol, frame, JCFG), i
    for raw in (b"{nope", b"[1]", b"\xff\xfe", b'{"a": 1}'):
        outs = []
        for mod in (protocol, jprotocol):
            try:
                outs.append(("ok", mod.parse_json_body(raw)))
            except mod.ProtocolError as e:
                outs.append((e.status, e.reason))
        assert outs[0][0] == outs[1][0] and \
            (outs[0][0] == "ok" or outs[0] == outs[1]), raw
    for body in ({"tenant": "t", "stream": "s", "task": 3, "rt": "RT-30"},
                 {"tenant": "t", "stream": "s", "task": 4},
                 {"tenant": "t", "stream": "s", "task": 0, "rt": "RT-10"},
                 {"tenant": "", "stream": "s", "task": 0}):
        got = []
        for mod in (protocol, jprotocol):
            try:
                got.append(mod.validate_session_open(body, 4))
            except mod.ProtocolError as e:
                got.append((e.status, e.reason, e.detail))
        assert repr(got[0]) == repr(got[1]) or got[0] == got[1], body
    assert protocol.REJECT_REASONS == jprotocol.REJECT_REASONS
    assert protocol.PROTOCOL_VERSION == jprotocol.PROTOCOL_VERSION
    wout = SimpleNamespace(best=np.array([3, -1], np.int32),
                           scores=np.arange(8, dtype=np.float32))
    assert protocol.window_result_body(2, wout) == \
        jprotocol.window_result_body(2, wout)
