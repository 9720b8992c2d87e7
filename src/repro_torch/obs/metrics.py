"""Process-local metrics registry: counters, gauges, fixed-bucket histograms
(port of ``repro.obs.metrics``).

The serving observability tier: a zero-dependency, best-effort
metrics substrate in the mold of production CLIP-serving backends'
``metrics.py`` counters/gauges/histograms — *not* a client-library clone.
Three metric kinds, each with optional labels:

  * :class:`Counter`   — monotonically increasing float (``inc``);
  * :class:`Gauge`     — instantaneous float (``set``/``inc``/``dec``);
  * :class:`Histogram` — fixed cumulative buckets + sum + count
    (``observe``), Prometheus-shaped so exposition is a straight dump.

Hot-path contract
=================

Increments are **lock-cheap**: a child (one labeled time series) mutates
plain Python floats without taking any lock. Under CPython's GIL a lost
update is possible only when two threads race the same read-modify-write —
acceptable for best-effort serving metrics, and the price of keeping
``inc()`` off every engine hot path's critical section. Registry- and
metric-level *structure* (new metric families, new label sets) is guarded
by one registry lock; :meth:`MetricsRegistry.snapshot` copies under that
lock, so a snapshot is an isolated, immutable view (mutating the registry
afterwards never changes an already-taken snapshot).

Label cardinality is bounded per metric family (``max_series``, default
512): the 513th distinct label set raises instead of silently eating
memory — an unbounded-label bug should fail loudly in CI, not OOM a
serving host.

Naming follows the Prometheus conventions: families are snake_case with a
``torr_`` prefix and unit suffixes (``_total``, ``_seconds``, ``_mj``);
the full catalog lives in ``docs/observability.md``. Exposition (text
format + JSON + the HTTP endpoint) lives in :mod:`repro_torch.obs.export`.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Default latency buckets for span/step histograms: 100 us .. 10 s, the
# envelope between a single fused dispatch and a badly backlogged step.
LATENCY_BUCKETS_S = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0,
)


class _Child:
    """One labeled time series of a counter/gauge. Unlocked mutation."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount

    def set(self, value: float) -> None:
        self.value = float(value)


class _HistChild:
    """One labeled histogram series: cumulative bucket counts + sum."""

    __slots__ = ("counts", "sum")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # +1 for the +Inf bucket
        self.sum = 0.0

    def observe(self, value: float, edges: Sequence[float]) -> None:
        # linear scan: span histograms have ~16 edges and the scan is
        # cheaper than bisect's function-call overhead at that width
        i = 0
        for edge in edges:
            if value <= edge:
                break
            i += 1
        self.counts[i] += 1
        self.sum += value

    @property
    def count(self) -> int:
        return sum(self.counts)


class _Metric:
    """Shared family machinery: name, help, label schema, child table."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Tuple[str, ...]):
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._children: Dict[Tuple[str, ...], object] = {}
        if not labelnames:
            self._default = self._children[()] = self._new_child()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **labels: str):
        """The child for one label set (created on first use, then cached).

        Raises ``ValueError`` on a label-name mismatch or when the family
        would exceed the registry's ``max_series`` cardinality bound."""
        if tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(labels)}")
        key = tuple(str(labels[ln]) for ln in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._registry._lock:
                child = self._children.get(key)
                if child is None:
                    if len(self._children) >= self._registry.max_series:
                        raise ValueError(
                            f"metric {self.name!r} exceeded max_series="
                            f"{self._registry.max_series} label sets "
                            f"(cardinality bound)")
                    child = self._children[key] = self._new_child()
        return child

    def _series(self) -> Iterable[Tuple[Tuple[str, ...], object]]:
        return list(self._children.items())


class Counter(_Metric):
    kind = "counter"

    def _new_child(self) -> _Child:
        return _Child()

    def inc(self, amount: float = 1.0) -> None:
        """Unlabeled fast path (labelless families only)."""
        self._default.inc(amount)

    @property
    def value(self) -> float:
        return self._default.value


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self) -> _Child:
        return _Child()

    def set(self, value: float) -> None:
        self._default.set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default.dec(amount)

    @property
    def value(self) -> float:
        return self._default.value


class HistogramChild:
    """Bound (child, edges) pair so ``observe`` needs no edge lookup."""

    __slots__ = ("_child", "_edges")

    def __init__(self, child: _HistChild, edges: Sequence[float]):
        self._child = child
        self._edges = edges

    def observe(self, value: float) -> None:
        self._child.observe(value, self._edges)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets: Sequence[float]):
        edges = tuple(float(b) for b in buckets)
        if not edges or any(e2 <= e1 for e1, e2 in zip(edges, edges[1:])):
            raise ValueError(
                f"histogram {name!r} buckets must be a non-empty strictly "
                f"increasing sequence, got {buckets}")
        if any(math.isinf(e) for e in edges):
            raise ValueError("the +Inf bucket is implicit; do not pass it")
        self.buckets = edges
        super().__init__(registry, name, help, labelnames)

    def _new_child(self) -> _HistChild:
        return _HistChild(len(self.buckets))

    def labels(self, **labels: str) -> HistogramChild:
        return HistogramChild(super().labels(**labels), self.buckets)

    def observe(self, value: float) -> None:
        """Unlabeled fast path (labelless families only)."""
        self._default.observe(value, self.buckets)


class MetricsRegistry:
    """A process-local family table with snapshot/exposition support.

    ``max_series`` bounds label cardinality *per family* (see module
    docstring). Family registration is idempotent when the (kind, labels,
    buckets) schema matches — ``registry.counter(...)`` from two call
    sites returns the same family — and raises on a schema conflict.
    """

    def __init__(self, max_series: int = 512):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self.max_series = max_series

    def _register(self, cls, name: str, help: str,
                  labelnames: Sequence[str] = (), **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labelnames = tuple(labelnames)
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != labelnames
                        or kw.get("buckets") is not None
                        and getattr(existing, "buckets", None)
                        != tuple(kw["buckets"])):
                    raise ValueError(
                        f"metric {name!r} already registered with a "
                        f"different schema")
                return existing
            metric = (cls(self, name, help, labelnames, kw["buckets"])
                      if cls is Histogram
                      else cls(self, name, help, labelnames))
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=tuple(buckets))

    # -- read side ----------------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        """Deep-copied, JSON-safe view of every family.

        ``{name: {"type", "help", "labelnames", "series": [...]}}`` where a
        counter/gauge series is ``{"labels": {...}, "value": v}`` and a
        histogram series additionally carries ``"buckets"`` (cumulative
        counts aligned with ``"bucket_edges"``), ``"sum"`` and ``"count"``.
        The copy is taken under the registry lock, so later mutation never
        leaks into an already-taken snapshot.
        """
        with self._lock:
            metrics = dict(self._metrics)
        out: Dict[str, dict] = {}
        for name, m in sorted(metrics.items()):
            series = []
            for key, child in m._series():
                labels = dict(zip(m.labelnames, key))
                if isinstance(child, _HistChild):
                    counts = list(child.counts)
                    series.append({
                        "labels": labels,
                        "bucket_edges": list(m.buckets),
                        "buckets": counts,
                        "sum": child.sum,
                        "count": sum(counts),
                    })
                else:
                    series.append({"labels": labels, "value": child.value})
            out[name] = {"type": m.kind, "help": m.help,
                         "labelnames": list(m.labelnames), "series": series}
        return out

    def collect(self) -> Mapping[str, _Metric]:
        """Live family table (read-only use; exposition iterates this)."""
        with self._lock:
            return dict(self._metrics)


def quantile(series: Mapping, q: float) -> float:
    """Estimate quantile ``q`` from one histogram *snapshot series*.

    ``series`` is one entry of ``snapshot()[name]["series"]`` — the dict
    carrying ``bucket_edges`` (finite upper bounds), ``buckets``
    (per-bucket counts, one extra for +Inf) and ``count``. The estimate
    interpolates linearly inside the bucket the quantile rank lands in,
    assuming uniform density between edges (the first bucket's lower
    bound is 0 — latency-shaped; Prometheus' ``histogram_quantile`` makes
    the same assumptions, so the two agree). A rank landing in the
    overflow bucket clamps to the last finite edge — the estimator never
    invents mass beyond what the buckets bound, also matching Prometheus.

    Raises ``ValueError`` outside ``0 <= q <= 1``; returns ``nan`` for an
    empty series. Benchmark post-processing derives p99s from
    snapshots through this instead of re-keeping raw sample lists.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    edges = series["bucket_edges"]
    counts = series["buckets"]
    total = series.get("count", sum(counts))
    if total <= 0:
        return float("nan")
    rank = q * total
    cum = 0.0
    lo = 0.0
    for edge, n in zip(edges, counts):
        if cum + n >= rank:
            if n <= 0 or rank <= cum:
                return float(lo)
            return float(lo + (edge - lo) * (rank - cum) / n)
        cum += n
        lo = edge
    return float(edges[-1])   # rank fell in the +Inf bucket: clamp


def snapshot_quantile(snapshot: Mapping, name: str, q: float,
                      labels: Optional[Mapping] = None) -> float:
    """:func:`quantile` over a full ``MetricsRegistry.snapshot()`` dict.

    Picks the ``name`` family's series matching ``labels`` (``None`` =
    the single/unlabeled series); returns ``nan`` when the family or
    series is absent, so artifact post-processing never crashes on a
    partially-instrumented run.
    """
    fam = snapshot.get(name)
    if fam is None or fam.get("type") != "histogram":
        return float("nan")
    for series in fam["series"]:
        if labels is None or series["labels"] == dict(labels):
            return quantile(series, q)
    return float("nan")


_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide default registry (what ``launch/serve.py`` and the
    benchmark harness expose when no explicit registry is wired)."""
    return _default_registry
