"""Gateway wire protocol: framing, strict validation, typed rejections
(port of ``repro.serving.protocol``, the same wire format).

The network tier (:mod:`repro_torch.serving.gateway`) speaks JSON over
HTTP/1.1. This module owns everything about the *bytes* so the gateway
can stay about *connections*: array encoding, request validation, the
error taxonomy, and the client-visible retry contract. Every invalid
input maps to a :class:`ProtocolError` carrying an HTTP status and a
machine-readable ``reason`` token — the gateway turns those into
responses, so a malformed frame can never surface as a worker exception.

Wire shapes
-----------
Arrays travel as ``{"dtype", "shape", "data": <base64>}`` — the exact
encoding :mod:`repro_torch.serving.state_store` uses for snapshots, so a
window captured off the wire replays against a store snapshot without a
re-encode. Decoding is strict: the declared dtype and shape must match
the schema expected for that field (a client cannot smuggle an f64 query
or a [N, 5] box tensor past validation), and the payload length must
equal ``prod(shape) * itemsize`` exactly.

Requests
--------
``POST /v1/session``   ``{"tenant", "stream", "task", "rt"?}``
``POST /v1/window``    ``{"session", "seq", "q", "valid", "boxes",
                         "deadline_ms"?}``
``DELETE /v1/session/<tenant>/<stream>``

Identifiers are ``[A-Za-z0-9_.-]{1,64}``; a session id is
``"<tenant>/<stream>"``. ``seq`` is the client's per-session submission
index (0-based, strictly sequential): the idempotency key the gateway's
retry/dedupe contract is built on.

Packed words travel as ``uint32 [N_max, words]``, as in ``repro``; the
port keeps them as int32 bit patterns, so the gateway *views* the decoded
array as int32 before it reaches an engine (a word >= 2**31 crosses
unchanged). A served window's ``scores_sha256`` hashes the C-contiguous
float32 host bytes of its scores, so a response of either package's
gateway for the same window is byte-equal.

Error contract
--------------
400 ``bad_request``/``bad_frame`` malformed JSON, schema or dtype errors
408 ``slow_client``   header/body arrived slower than the read deadline
409 ``out_of_order``/``seq_consumed`` sequence contract violations
413 ``too_large``     body over ``GatewayLimits.max_body_bytes``
429 ``rate_limit``/``tenant_quota``/``no_slot``/``shed`` + Retry-After
503 ``recovering``/``engine_dead``/``deadline``/``draining`` + Retry-After
"""
from __future__ import annotations

import base64
import binascii
import dataclasses
import json
import re
from typing import Optional

import numpy as np

PROTOCOL_VERSION = 1

_ID_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")

# client-visible reject reasons (the label set of
# torr_gateway_rejects_total — keep this closed and small)
REJECT_REASONS = (
    "bad_request", "bad_frame", "slow_client", "out_of_order",
    "seq_consumed", "too_large", "rate_limit", "tenant_quota", "no_slot",
    "shed", "recovering", "engine_dead", "deadline", "draining",
    "disconnect", "internal", "no_session", "session_exists", "conn_limit",
)


class ProtocolError(Exception):
    """A client-attributable failure with an HTTP status and retry hint.

    ``reason`` is one of :data:`REJECT_REASONS`; ``retry_after_s`` (when
    set) is surfaced as a ``Retry-After`` header so supervised clients
    back off instead of hammering."""

    def __init__(self, status: int, reason: str, detail: str = "",
                 retry_after_s: Optional[float] = None):
        assert reason in REJECT_REASONS, reason
        self.status = int(status)
        self.reason = reason
        self.detail = detail
        self.retry_after_s = retry_after_s
        super().__init__(f"{status} {reason}: {detail}")

    def body(self) -> dict:
        out = {"error": self.reason, "detail": self.detail}
        if self.retry_after_s is not None:
            out["retry_after_s"] = round(float(self.retry_after_s), 6)
        return out


# -- array wire format -------------------------------------------------------

def encode_array(a: np.ndarray) -> dict:
    """Encode a host array for the wire (state-store-compatible shape)."""
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(obj, *, dtype, shape, field: str) -> np.ndarray:
    """Strictly decode one wire array against its schema.

    The *declared* dtype/shape must equal the schema (no casts — an f64
    query is a client bug, not something to silently round), and the
    payload must hold exactly the right number of bytes."""
    if not isinstance(obj, dict):
        raise ProtocolError(400, "bad_frame",
                            f"{field}: expected an encoded array object")
    want_dtype = np.dtype(dtype)
    if obj.get("dtype") != str(want_dtype):
        raise ProtocolError(
            400, "bad_frame",
            f"{field}: dtype {obj.get('dtype')!r} != {want_dtype}")
    got_shape = obj.get("shape")
    if not isinstance(got_shape, list) or \
            [int(s) for s in got_shape] != [int(s) for s in shape]:
        raise ProtocolError(
            400, "bad_frame",
            f"{field}: shape {got_shape!r} != {list(shape)}")
    data = obj.get("data")
    if not isinstance(data, str):
        raise ProtocolError(400, "bad_frame", f"{field}: missing data")
    try:
        raw = base64.b64decode(data.encode("ascii"), validate=True)
    except (binascii.Error, UnicodeEncodeError) as e:
        raise ProtocolError(400, "bad_frame",
                            f"{field}: base64 decode failed ({e})") from e
    n_want = int(np.prod(shape, dtype=np.int64)) * want_dtype.itemsize
    if len(raw) != n_want:
        raise ProtocolError(
            400, "bad_frame",
            f"{field}: payload {len(raw)}B != expected {n_want}B")
    return np.frombuffer(raw, dtype=want_dtype).reshape(shape).copy()


# -- request schemas ---------------------------------------------------------

def _require(body: dict, key: str, typ, detail: str = ""):
    if not isinstance(body, dict):
        raise ProtocolError(400, "bad_request", "body must be a JSON object")
    if key not in body:
        raise ProtocolError(400, "bad_request", f"missing field {key!r}")
    v = body[key]
    # bool is an int subclass; an int field must still reject true/false
    if typ is int and isinstance(v, bool) or not isinstance(v, typ):
        raise ProtocolError(
            400, "bad_request",
            detail or f"field {key!r} must be {getattr(typ, '__name__', typ)}")
    return v


def parse_json_body(raw: bytes) -> dict:
    try:
        body = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(400, "bad_request",
                            f"body is not valid JSON ({e})") from e
    if not isinstance(body, dict):
        raise ProtocolError(400, "bad_request", "body must be a JSON object")
    return body


def validate_id(value, field: str) -> str:
    if not isinstance(value, str) or not _ID_RE.match(value):
        raise ProtocolError(
            400, "bad_request",
            f"{field} must match [A-Za-z0-9_.-]{{1,64}}")
    return value


def session_id(tenant: str, stream: str) -> str:
    return f"{tenant}/{stream}"


def split_session_id(sid) -> tuple:
    if not isinstance(sid, str) or sid.count("/") != 1:
        raise ProtocolError(400, "bad_request",
                            "session must be '<tenant>/<stream>'")
    tenant, stream = sid.split("/", 1)
    return validate_id(tenant, "tenant"), validate_id(stream, "stream")


@dataclasses.dataclass(frozen=True)
class SessionOpen:
    tenant: str
    stream: str
    task: int
    rt: str


@dataclasses.dataclass(frozen=True)
class WindowRequest:
    session: str
    seq: int
    q: np.ndarray        # uint32 [N_max, words] (the wire's dtype)
    valid: np.ndarray    # bool   [N_max]
    boxes: np.ndarray    # f32    [N_max, 4]
    deadline_s: Optional[float]   # per-request gateway wait budget


def validate_session_open(body: dict, n_tasks: int) -> SessionOpen:
    tenant = validate_id(_require(body, "tenant", str), "tenant")
    stream = validate_id(_require(body, "stream", str), "stream")
    task = _require(body, "task", int)
    if not 0 <= task < n_tasks:
        raise ProtocolError(400, "bad_request",
                            f"task {task} out of range [0, {n_tasks})")
    rt = body.get("rt", "RT-60")
    if rt not in ("RT-30", "RT-60"):
        raise ProtocolError(400, "bad_request",
                            "rt must be 'RT-30' or 'RT-60'")
    return SessionOpen(tenant=tenant, stream=stream, task=task, rt=rt)


def validate_window(body: dict, cfg) -> WindowRequest:
    sid = _require(body, "session", str)
    split_session_id(sid)
    seq = _require(body, "seq", int)
    if seq < 0:
        raise ProtocolError(400, "bad_request", "seq must be >= 0")
    q = decode_array(_require(body, "q", dict,
                              "field 'q' must be an encoded array"),
                     dtype=np.uint32, shape=(cfg.N_max, cfg.words),
                     field="q")
    valid = decode_array(_require(body, "valid", dict,
                                  "field 'valid' must be an encoded array"),
                         dtype=np.bool_, shape=(cfg.N_max,), field="valid")
    boxes = decode_array(_require(body, "boxes", dict,
                                  "field 'boxes' must be an encoded array"),
                         dtype=np.float32, shape=(cfg.N_max, 4),
                         field="boxes")
    if not np.isfinite(boxes).all():
        raise ProtocolError(400, "bad_frame",
                            "boxes: non-finite coordinates")
    deadline_s = None
    if "deadline_ms" in body:
        dl = body["deadline_ms"]
        if isinstance(dl, bool) or not isinstance(dl, (int, float)) \
                or not (0 < dl <= 600_000):
            raise ProtocolError(400, "bad_request",
                                "deadline_ms must be in (0, 600000]")
        deadline_s = float(dl) / 1e3
    return WindowRequest(session=sid, seq=seq, q=q, valid=valid,
                         boxes=boxes, deadline_s=deadline_s)


# -- response bodies ---------------------------------------------------------

def _host_array(x) -> np.ndarray:
    """A result leaf (numpy array, or a tensor on any device) on the
    host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def window_result_body(seq: int, wout) -> dict:
    """The served-window response: the decision payload (`best`) plus a
    digest of the full score tensor: the same ``scores_sha256`` the
    launcher's output ledger records (the C-contiguous float32 host bytes
    of the scores), so wire responses and on-disk ledgers reconcile bit
    for bit."""
    import hashlib
    scores = np.ascontiguousarray(_host_array(wout.scores), np.float32)
    return {
        "seq": int(seq),
        "best": _host_array(wout.best).tolist(),
        "scores_sha256": hashlib.sha256(scores.tobytes()).hexdigest(),
    }


def config_body(cfg, n_tasks: int, limits) -> dict:
    return {
        "protocol": PROTOCOL_VERSION,
        "N_max": int(cfg.N_max),
        "words": int(cfg.words),
        "D": int(cfg.D),
        "M": int(cfg.M),
        "n_tasks": int(n_tasks),
        "limits": {
            "max_body_bytes": int(limits.max_body_bytes),
            "rate_per_s": float(limits.rate_per_s),
            "burst": int(limits.burst),
            "max_sessions_per_tenant": int(limits.max_sessions_per_tenant),
            "request_deadline_s": float(limits.request_deadline_s),
        },
        "rt": ["RT-30", "RT-60"],
    }
