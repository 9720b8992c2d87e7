"""Serving observability: metrics registry, flight recorder, span timers,
per-window causal tracing, Chrome-trace export, and the RT-SLO burn-rate
engine (port of ``repro.obs``, by copy: the modules are pure Python and
numpy, and the bridge reads the port's ``core.types``).

Zero *new* dependencies: stdlib + numpy, plus the ``core.types`` name
vocabulary (``PATH_NAMES``/``FUSED_NAMES``/``DECIDE_NAMES``) the bridge
decodes telemetry with. Metric catalog, flight schema, trace-context
model and SLO semantics live in ``docs/observability.md``.
"""
from .bridge import StepObserver, telemetry_digest
from .export import (MetricsServer, health_response, prometheus_text,
                     write_json_snapshot)
from .flight import (FLIGHT_SCHEMA_VERSION, FlightRecorder, load_jsonl,
                     plan_timeline, replay)
from .metrics import (LATENCY_BUCKETS_S, Counter, Gauge, Histogram,
                      MetricsRegistry, default_registry, quantile,
                      snapshot_quantile)
from .slo import (SLO_OK, SLO_PAGE, SLO_WARN, SLOMonitor, SLOPolicy,
                  burn_rate)
from .spans import NULL_SPAN, current_span, span, span_stack
from .trace import (TRACE_SCHEMA_VERSION, TraceContext, Tracer, now_us,
                    trace_scope)
from .trace_export import chrome_trace, write_chrome_trace

__all__ = [
    "Counter", "FLIGHT_SCHEMA_VERSION", "FlightRecorder", "Gauge",
    "Histogram", "LATENCY_BUCKETS_S", "MetricsRegistry", "MetricsServer",
    "NULL_SPAN", "SLOMonitor", "SLOPolicy", "SLO_OK", "SLO_PAGE",
    "SLO_WARN", "StepObserver", "TRACE_SCHEMA_VERSION", "TraceContext",
    "Tracer", "burn_rate", "chrome_trace", "current_span",
    "default_registry", "health_response", "load_jsonl", "now_us",
    "plan_timeline",
    "prometheus_text", "quantile", "replay", "snapshot_quantile", "span",
    "span_stack", "telemetry_digest", "trace_scope", "write_chrome_trace",
    "write_json_snapshot",
]
