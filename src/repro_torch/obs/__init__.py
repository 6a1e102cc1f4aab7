"""Observability: named metrics and wall-clock spans (stdlib + torch)."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, get_registry
from .trace import disable_tracing, enable_tracing, fence, get_tracer, span

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "disable_tracing", "enable_tracing", "fence", "get_tracer", "span",
]
