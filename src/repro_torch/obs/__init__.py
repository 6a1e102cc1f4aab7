"""Observability: named metrics, spans and live telemetry (stdlib + torch).

- :mod:`.trace` — nestable ``span("name", **attrs)`` context managers, a
  process :class:`Tracer` with JSONL + Chrome-trace (Perfetto) export, a
  ring mode, ``torch.profiler.record_function`` passthrough, and
  :func:`fence` (a device synchronize, only while tracing);
- :mod:`.metrics` — a thread-safe :class:`MetricsRegistry` of counters,
  gauges and log-bucketed histograms with snapshot/diff/merge semantics;
- :mod:`.flight` — :class:`FlightRecorder`: always-on ring-buffer tracing
  with latency/error-triggered Perfetto dumps;
- :mod:`.exposition` — Prometheus/JSON rendering of a registry snapshot,
  the :class:`TelemetryServer` HTTP endpoints (``/metricsz`` ``/healthz``
  ``/statusz`` ``/tracez``) and the :class:`PeriodicSampler` JSONL series;
- :mod:`.slo` — :class:`SLOObjective`s evaluated by an :class:`SLOMonitor`
  with multi-window burn rates into a healthy/degraded/unhealthy state
  the scoring service consumes as an overload signal;
- :mod:`.report` — :class:`BenchReport` writes schema-versioned
  ``BENCH_<name>.json`` artifacts (machine fingerprint with the torch
  version, CUDA device and data mesh, metric snapshots, span rollups).
"""
from .exposition import PeriodicSampler, TelemetryServer, render_json, render_prometheus
from .flight import FlightRecorder
from .metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, diff_snapshots, format_summary_table,
    get_registry, merge_snapshots, reset_registry,
)
from .report import BenchReport, bench_path, fingerprint, validate_bench
from .slo import SLOMonitor, SLOObjective, parse_slo_spec
from .trace import (
    Tracer, disable_tracing, enable_tracing, fence, get_tracer, span, tracing_enabled,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "diff_snapshots", "merge_snapshots", "format_summary_table",
    "get_registry", "reset_registry",
    "BenchReport", "bench_path", "fingerprint", "validate_bench",
    "Tracer", "span", "fence", "enable_tracing", "disable_tracing",
    "tracing_enabled", "get_tracer",
    "FlightRecorder",
    "TelemetryServer", "PeriodicSampler", "render_prometheus", "render_json",
    "SLOMonitor", "SLOObjective", "parse_slo_spec",
]
