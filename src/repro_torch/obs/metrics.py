"""Thread-safe named metrics: counters and log-bucketed histograms.

A :class:`MetricsRegistry` is a flat namespace of named series.  An
``inc``/``observe`` is a lock acquire plus an integer/dict update, cheap
enough for the hot paths it measures (``QueryCounter`` bumps, the
serving batcher's per-request latencies).

Histograms are log-bucketed (``RES`` sub-buckets per octave, ~9%
relative width), so quantile summaries (p50/p90/p99) cost O(#buckets).
No dependencies beyond the stdlib.
"""
from __future__ import annotations

import math
import threading
from typing import Dict

__all__ = ["Counter", "Histogram", "MetricsRegistry", "get_registry"]


class Counter:
    """Monotonic accumulator; ``inc`` is safe from any thread."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += int(n)

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}


class Histogram:
    """Log-bucketed distribution with quantile summaries.

    Bucket ``i`` covers ``[2^(i/RES), 2^((i+1)/RES))``, so any quantile
    estimate is within one bucket width (~``2^(1/RES)−1`` relative) of
    exact.  Non-positive observations land in a dedicated underflow
    bucket and only influence count/sum/min.
    """

    RES = 8                      # sub-buckets per power of two (~9% width)
    _UNDER = -(10 ** 9)          # bucket index for values ≤ 0

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, v: float) -> int:
        if v <= 0.0:
            return self._UNDER
        return math.floor(math.log2(v) * self.RES)

    def observe(self, v: float) -> None:
        v = float(v)
        i = self._index(v)
        with self._lock:
            self.buckets[i] = self.buckets.get(i, 0) + 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def quantile(self, q: float) -> float:
        """Estimate the ``q``-quantile from the bucket histogram (the
        geometric bucket midpoint, clamped to the observed min/max)."""
        if self.count == 0:
            return math.nan
        rank = q * (self.count - 1)
        seen = 0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen > rank:
                if i == self._UNDER:
                    return self.min
                mid = 2.0 ** ((i + 0.5) / self.RES)
                return min(max(mid, self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.mean if self.count else None,
            "p50": self.quantile(0.50) if self.count else None,
            "p90": self.quantile(0.90) if self.count else None,
            "p99": self.quantile(0.99) if self.count else None,
        }

    def snapshot(self) -> dict:
        return {"type": "histogram", **self.summary()}


class MetricsRegistry:
    """Named series with get-or-create semantics, safe across threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able {name: instrument snapshot} for every series."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in items}


_global_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (instrumented subsystems mirror
    their per-instance accounting into it as named series)."""
    return _global_registry
