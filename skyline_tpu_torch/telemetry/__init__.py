"""Unified telemetry plane: histograms, per-query spans, Prometheus export.

Counterpart of ``skyline_tpu/telemetry/__init__.py``. ``Telemetry`` is one
hub object the engine records into: named ``Counters``, get-or-create
``Histogram``s, the ``SpanRecorder`` ring, and the planes that hang off it —
the ``KernelProfiler`` and ``FlightRecorder`` (``profiler.py``), the
``SloEngine``, the EXPLAIN ring (``explain.py``), the audit ring
(``audit.py``), and, attached by the engine, the ``WorkloadCharacterizer``
and the ``DispatchTuner``.

Slots of the reference's hub whose planes are not ported yet stay as they
are on the reference's flat (non-sharded, non-clustered) worker: ``fleet``,
``health``, ``cluster``, ``opslog`` and ``clusterview`` are ``None`` and
``replication`` is ``[]``. ``fleet_doc`` builds the ``/fleet`` document both
HTTP surfaces serve.
"""

from __future__ import annotations

import threading

from skyline_tpu_torch.metrics.collector import Counters
from skyline_tpu_torch.metrics.tracing import NULL_TRACER, Tracer
from skyline_tpu_torch.telemetry.audit import AuditRecorder
from skyline_tpu_torch.telemetry.explain import ExplainRecorder, QueryPlan
from skyline_tpu_torch.telemetry.fleet import fleet_doc
from skyline_tpu_torch.telemetry.freshness import FreshnessTracker
from skyline_tpu_torch.telemetry.histogram import DEFAULT_EDGES, Histogram
from skyline_tpu_torch.telemetry.profiler import FlightRecorder, KernelProfiler
from skyline_tpu_torch.telemetry.prometheus import CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE
from skyline_tpu_torch.telemetry.prometheus import flatten_gauges
from skyline_tpu_torch.telemetry.prometheus import render as render_prometheus
from skyline_tpu_torch.telemetry.slo import SloEngine
from skyline_tpu_torch.telemetry.spans import SpanRecorder, mint_trace_id
from skyline_tpu_torch.telemetry.workload import WorkloadCharacterizer
from skyline_tpu_torch.utils.knobs import env_int


def _extend_labeled(dst: dict | None, src: dict) -> dict:
    """Merge labeled-series maps by EXTENDING each family's series list, so
    several providers of one family coexist."""
    out = {k: list(v) for k, v in (dst or {}).items()}
    for family, series in src.items():
        out.setdefault(family, []).extend(series)
    return out


class Telemetry:
    """One shared hub: counters + named histograms + the span ring.

    Everything on it is safe from any thread. ``histogram`` is
    get-or-create so call sites never coordinate registration.
    """

    def __init__(self, span_capacity: int = 4096):
        self.counters = Counters()
        self.spans = SpanRecorder(span_capacity)
        self._hists: dict[tuple, Histogram] = {}
        self._lock = threading.Lock()
        # the per-kernel dispatch profiler, the decision flight recorder and
        # the SLO burn-rate engine
        self.profiler = KernelProfiler(spans=self.spans)
        self.flight = FlightRecorder(env_int("SKYLINE_FLIGHT_RING", 256))
        self.slo = SloEngine(self)
        # per-query EXPLAIN plans and the audit plane's verdict ring
        self.explain = ExplainRecorder(env_int("SKYLINE_EXPLAIN_RING", 256))
        self.audit = AuditRecorder(env_int("SKYLINE_AUDIT_RING", 256))
        # attached by the engine: the workload characterizer and the
        # dispatch tuner (None when their gates are off)
        self.workload = None
        self.tuner = None
        # the reference's sharded, cluster and replication planes; a flat
        # engine leaves them empty
        self.fleet = None
        self.health = None
        self.cluster = None
        self.opslog = None
        self.replication: list = []
        self.clusterview = None

    def inc(self, name: str, n: int = 1) -> None:
        """Bump a named monotonic counter."""
        self.counters.inc(name, n)

    def histogram(
        self,
        name: str,
        unit: str = "ms",
        labels: tuple[tuple[str, str], ...] | None = None,
    ) -> Histogram:
        """Get-or-create a histogram; ``labels`` (a ``((key, value), ...)``
        tuple) keys a distinct series inside the same Prometheus family."""
        key = (name, tuple(labels) if labels else None)
        h = self._hists.get(key)
        if h is None:
            with self._lock:
                h = self._hists.get(key)
                if h is None:
                    h = Histogram(name, unit=unit, labels=labels)
                    self._hists[key] = h
        return h

    def histograms(self) -> list[Histogram]:
        with self._lock:
            return list(self._hists.values())

    def mint_trace_id(self) -> str:
        return mint_trace_id()

    def latency_snapshot(self) -> dict[str, dict]:
        """{hist name: {count, mean, p50, p90, p99, ...}}. Labeled series
        get a ``name{k=v}`` key so families don't collide."""
        out = {}
        for h in self.histograms():
            key = h.name
            if h.labels:
                key += "{" + ",".join(f"{k}={v}" for k, v in h.labels) + "}"
            out[key] = h.snapshot()
        return out

    def render_prometheus(
        self,
        gauges: dict[str, float] | None = None,
        extra_counters: dict[str, float] | None = None,
        prefix: str = "skyline",
        extra_labeled_counters: dict | None = None,
    ) -> str:
        counters = dict(self.counters.snapshot())
        # span-ring overwrites are silent data loss for trace readers; the
        # drop counter is always exposed, zero included
        counters["telemetry.spans_dropped"] = self.spans.dropped
        counters.setdefault("degraded_answers", 0)
        # the kernel build cache: a rising miss count means rebuilds
        from skyline_tpu_torch.utils.compile_cache import compile_cache_stats

        cc = compile_cache_stats()
        counters["compile_cache.hits"] = cc["hits"]
        counters["compile_cache.misses"] = cc["misses"]
        if extra_counters:
            counters.update(extra_counters)
        labeled_counters = labeled_gauges = None
        if self.fleet is not None:
            labeled_counters, labeled_gauges = self.fleet.labeled_series()
        if self.cluster is not None:
            host_counters, host_gauges = self.cluster.labeled_series()
            if host_counters:
                labeled_counters = {**(labeled_counters or {}), **host_counters}
            if host_gauges:
                labeled_gauges = {**(labeled_gauges or {}), **host_gauges}
        for provider in list(self.replication):
            try:
                fn = getattr(provider, "labeled_series", provider)
                repl_counters, repl_gauges = fn()
            except Exception:
                continue  # a failing provider must not break the exposition
            if repl_counters:
                labeled_counters = _extend_labeled(labeled_counters, repl_counters)
            if repl_gauges:
                labeled_gauges = _extend_labeled(labeled_gauges, repl_gauges)
        if extra_labeled_counters:
            labeled_counters = {**(labeled_counters or {}), **extra_labeled_counters}
        return render_prometheus(
            counters=counters,
            gauges=gauges,
            histograms=self.histograms(),
            prefix=prefix,
            labeled_counters=labeled_counters,
            labeled_gauges=labeled_gauges,
        )


__all__ = [
    "AuditRecorder",
    "Counters",
    "DEFAULT_EDGES",
    "ExplainRecorder",
    "FlightRecorder",
    "FreshnessTracker",
    "Histogram",
    "KernelProfiler",
    "NULL_TRACER",
    "PROMETHEUS_CONTENT_TYPE",
    "QueryPlan",
    "SloEngine",
    "SpanRecorder",
    "Telemetry",
    "Tracer",
    "WorkloadCharacterizer",
    "flatten_gauges",
    "fleet_doc",
    "mint_trace_id",
    "render_prometheus",
]
