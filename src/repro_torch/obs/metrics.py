"""Thread-safe named metrics: counters, gauges and log-bucketed histograms.

A :class:`MetricsRegistry` is a flat namespace of named series.  An
``inc``/``observe`` is a lock acquire plus an integer/dict update, cheap
enough for the hot paths it measures (``QueryCounter`` bumps, the
serving batcher's per-request latencies).

Snapshots are plain JSON-able dicts, so three derived operations cover
every reporting need:

- ``registry.snapshot()``  — point-in-time values/summaries;
- ``diff_snapshots(a, b)`` — work done *between* two snapshots
  (counters/histogram buckets subtract; gauges keep the later value);
- ``merge_snapshots(a, b)`` — combine series from parallel actors
  (counters/buckets add, min/max widen).

Histograms are log-bucketed (``RES`` sub-buckets per octave, ~9%
relative width), so quantile summaries (p50/p90/p99) cost O(#buckets)
and merging is exact.  No dependencies beyond the stdlib.
"""
from __future__ import annotations

import math
import threading
from typing import Dict

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "reset_registry", "diff_snapshots", "merge_snapshots",
    "format_summary_table",
]


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


class Gauge:
    """Last-written value (a lag, a log position); ``set`` from any thread."""

    def __init__(self, name: str = ""):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}


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
        return {"type": "histogram", **self.summary(),
                "buckets": {str(k): v for k, v in self.buckets.items()}}

    def merge(self, other: "Histogram") -> "Histogram":
        """In-place ⊎: bucket-wise add (exact — the grid is shared)."""
        with self._lock:
            for i, c in other.buckets.items():
                self.buckets[i] = self.buckets.get(i, 0) + c
            self.count += other.count
            self.sum += other.sum
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        return self


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

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able {name: instrument snapshot} for every series."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


# ------------------------------------------------------ snapshot algebra --
def _diff_hist(a: dict, b: dict) -> dict:
    """Histogram work b−a: bucket/count/sum subtract; min/max/quantiles
    cannot be recovered for the window, so they are re-estimated from
    the differenced buckets."""
    buckets = dict(b.get("buckets", {}))
    for k, v in (a.get("buckets") or {}).items():
        buckets[k] = buckets.get(k, 0) - v
        if buckets[k] <= 0:
            buckets.pop(k)
    count = b["count"] - a["count"]
    out = {
        "type": "histogram",
        "count": count,
        "sum": b["sum"] - a["sum"],
        "min": None, "max": None,
        "mean": (b["sum"] - a["sum"]) / count if count else None,
        "p50": None, "p90": None, "p99": None,
        "buckets": buckets,
    }
    if count > 0 and buckets:
        h = Histogram()
        h.buckets = {int(k): v for k, v in buckets.items()}
        h.count = count
        h.sum = out["sum"]
        idx = sorted(h.buckets)
        h.min = 2.0 ** (idx[0] / h.RES) if idx[0] != h._UNDER else 0.0
        h.max = 2.0 ** ((idx[-1] + 1) / h.RES)
        out.update(p50=h.quantile(.5), p90=h.quantile(.9), p99=h.quantile(.99),
                   min=h.min, max=h.max)
    return out


def diff_snapshots(before: Dict[str, dict], after: Dict[str, dict]) -> Dict[str, dict]:
    """Work done between two snapshots of the SAME registry."""
    out = {}
    for name, b in after.items():
        a = before.get(name)
        if a is None or a["type"] != b["type"]:
            out[name] = dict(b)
        elif b["type"] == "counter":
            out[name] = {"type": "counter", "value": b["value"] - a["value"]}
        elif b["type"] == "gauge":
            out[name] = dict(b)
        else:
            out[name] = _diff_hist(a, b)
    return out


def merge_snapshots(a: Dict[str, dict], b: Dict[str, dict]) -> Dict[str, dict]:
    """⊎ of snapshots from parallel actors (counters/buckets add)."""
    out = {k: dict(v) for k, v in a.items()}
    for name, m in b.items():
        cur = out.get(name)
        if cur is None or cur["type"] != m["type"]:
            out[name] = dict(m)
        elif m["type"] == "counter":
            cur["value"] += m["value"]
        elif m["type"] == "gauge":
            cur["value"] = m["value"]
        else:
            h = Histogram()
            for src in (cur, m):
                for k, v in (src.get("buckets") or {}).items():
                    h.buckets[int(k)] = h.buckets.get(int(k), 0) + v
            h.count = cur["count"] + m["count"]
            h.sum = cur["sum"] + m["sum"]
            mins = [x["min"] for x in (cur, m) if x.get("min") is not None]
            maxs = [x["max"] for x in (cur, m) if x.get("max") is not None]
            h.min = min(mins) if mins else math.inf
            h.max = max(maxs) if maxs else -math.inf
            out[name] = h.snapshot()
    return out


def format_summary_table(snapshot: Dict[str, dict], title: str = "metrics") -> str:
    """One-screen fixed-width rendering of a snapshot — what the launch
    CLIs print on exit instead of ad-hoc prints."""
    lines = [f"── {title} " + "─" * max(0, 62 - len(title))]
    width = max([len(n) for n in snapshot] or [8])
    for name in sorted(snapshot):
        m = snapshot[name]
        if m["type"] == "counter":
            lines.append(f"{name:<{width}}  {m['value']:>12,}")
        elif m["type"] == "gauge":
            lines.append(f"{name:<{width}}  {m['value']:>12.4g}")
        else:
            if not m["count"]:
                continue
            lines.append(
                f"{name:<{width}}  n={m['count']:<8,} "
                f"mean={m['mean']:.3g} p50={m['p50']:.3g} "
                f"p90={m['p90']:.3g} p99={m['p99']:.3g} max={m['max']:.3g}")
    lines.append("─" * 64)
    return "\n".join(lines)


# ---------------------------------------------------------- process-wide --
_global_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (instrumented subsystems mirror
    their per-instance accounting into it as named series)."""
    return _global_registry


def reset_registry() -> None:
    """Clear the process-wide registry (tests and benchmark phases)."""
    _global_registry.clear()
