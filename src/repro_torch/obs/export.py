"""Metrics exposition: Prometheus text format, JSON dumps, HTTP endpoint
(port of ``repro.obs.export``).

Three consumers of :class:`repro_torch.obs.metrics.MetricsRegistry` snapshots:

* :func:`prometheus_text` — the Prometheus text exposition format
  (version 0.0.4: ``# HELP``/``# TYPE`` headers, ``_bucket{le=...}``
  cumulative histogram rows, escaped label values). Works on either a
  live registry or an already-taken ``snapshot()`` dict, so CI artifacts
  and the live endpoint render identically.
* :func:`write_json_snapshot` — the JSON artifact shape bench-smoke
  uploads (schema: the raw ``snapshot()`` dict under ``"metrics"`` plus a
  ``"format"`` tag).
* :class:`MetricsServer` — a stdlib ``http.server`` daemon thread serving
  ``/metrics`` (text) and ``/metrics.json``; this is what
  ``launch/serve.py --metrics-port`` starts. Zero dependencies, one
  thread, scrape-safe (every request renders a fresh snapshot).

The server also answers ``/healthz`` (process liveness — always 200
while the thread runs) and ``/readyz`` (readiness: an optional ``ready``
callable, typically ``ServeSupervisor.health``, decides 200 vs 503 — a
recovering or terminally-failed supervisor reports not-ready). The
gateway serves the same two probes on its own port via
:func:`health_response`, so orchestrators can point one probe config at
either tier.
"""
from __future__ import annotations

import http.server
import json
import threading
from typing import Union

from .metrics import MetricsRegistry

_ESCAPES = str.maketrans({"\\": r"\\", '"': r"\"", "\n": r"\n"})
_HELP_ESCAPES = str.maketrans({"\\": r"\\", "\n": r"\n"})


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels: dict, extra: str = "") -> str:
    parts = [f'{k}="{str(v).translate(_ESCAPES)}"' for k, v in labels.items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_le(edge: float) -> str:
    return _fmt_value(edge) if edge == int(edge) else repr(float(edge))


def prometheus_text(source: Union[MetricsRegistry, dict]) -> str:
    """Render a registry (or a ``snapshot()`` dict) as exposition text."""
    snap = source.snapshot() if isinstance(source, MetricsRegistry) else source
    lines = []
    for name in sorted(snap):
        fam = snap[name]
        if fam["help"]:
            lines.append(f"# HELP {name} "
                         f"{fam['help'].translate(_HELP_ESCAPES)}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for series in fam["series"]:
            labels = series["labels"]
            if fam["type"] == "histogram":
                cum = 0
                for edge, n in zip(series["bucket_edges"], series["buckets"]):
                    cum += n
                    le = 'le="' + _fmt_le(edge) + '"'
                    lines.append(f"{name}_bucket{_fmt_labels(labels, le)}"
                                 f" {cum}")
                lines.append(
                    f"{name}_bucket" + _fmt_labels(labels, 'le="+Inf"')
                    + f" {series['count']}")
                lines.append(f"{name}_sum{_fmt_labels(labels)}"
                             f" {_fmt_value(series['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)}"
                             f" {series['count']}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)}"
                             f" {_fmt_value(series['value'])}")
    return "\n".join(lines) + "\n"


def write_json_snapshot(registry: MetricsRegistry, path: str) -> None:
    """Dump the registry snapshot as a CI-artifact JSON file."""
    with open(path, "w") as f:
        json.dump({"format": "torr-metrics-snapshot-v1",
                   "metrics": registry.snapshot()}, f, indent=1)
        f.write("\n")


def health_response(ready) -> tuple:
    """Evaluate a readiness source into ``(status, body_dict)``.

    ``ready`` may be None (always ready), a bool, a zero-arg callable
    returning either a bool or a health dict with a ``"ready"`` key
    (:meth:`ServeSupervisor.health`). A raising callable is *not ready*
    — a probe must never 200 because the health check itself crashed."""
    state = {"ready": True}
    if callable(ready):
        try:
            ready = ready()
        except Exception as e:   # noqa: BLE001 — fail closed
            ready = {"ready": False, "error": f"{type(e).__name__}: {e}"}
    if isinstance(ready, dict):
        state = dict(ready)
        state["ready"] = bool(state.get("ready", True))
    elif ready is not None:
        state = {"ready": bool(ready)}
    return (200 if state["ready"] else 503), state


class _Handler(http.server.BaseHTTPRequestHandler):
    registry: MetricsRegistry = None  # patched per-server subclass
    ready = None                      # optional readiness callable

    def do_GET(self):  # noqa: N802 (stdlib handler contract)
        path = self.path.split("?", 1)[0]
        status = 200
        if path in ("/metrics", "/"):
            body = prometheus_text(self.registry).encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/metrics.json":
            body = json.dumps(self.registry.snapshot()).encode()
            ctype = "application/json"
        elif path == "/healthz":
            body = json.dumps({"ok": True}).encode()
            ctype = "application/json"
        elif path == "/readyz":
            status, state = health_response(type(self).ready)
            body = json.dumps(state).encode()
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # scrapes are not serving events
        pass


class MetricsServer:
    """``/metrics`` + health-probe endpoint on a daemon thread.

    ``port=0`` binds an ephemeral port; read the bound one from ``.port``
    after :meth:`start`. The thread is a daemon so a crashed serving loop
    never hangs on the scrape endpoint. ``ready`` (optional callable,
    e.g. ``supervisor.health``) backs ``/readyz``.
    """

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1", ready=None):
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": registry, "ready": staticmethod(ready)
                        if callable(ready) else ready})
        self._httpd = http.server.ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="torr-metrics",
            daemon=True)
        self.port = self._httpd.server_address[1]

    def start(self) -> int:
        self._thread.start()
        return self.port

    def set_ready(self, ready) -> None:
        """(Re)wire the ``/readyz`` readiness source — the supervisor is
        usually built after the scrape server, so launchers wire it in
        late (``server.set_ready(sup.health)``)."""
        self._httpd.RequestHandlerClass.ready = \
            staticmethod(ready) if callable(ready) else ready

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
