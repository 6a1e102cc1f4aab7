"""Arithmetic shared by the per-layer metrics' readers."""
from __future__ import annotations

import math
from typing import Dict, Optional

from .profile import Trace


def roofline_pct(trace: Trace, kernel: str) -> Optional[float]:
    """Σ least time of the kernel's calls over the device time of the work
    launched inside them, in percent; None where the window made no call."""
    bound = sum(c["bound_s"] for c in trace.calls if c["kernel"] == kernel)
    device = trace.device_s_in([f"bench.{kernel}"])
    if not bound or not device:
        return None
    return 100.0 * bound / device


def per(trace: Trace, what: str, over: str, scale: float = 1.0) -> Optional[float]:
    n = trace.counters.get(over)
    v = trace.counters.get(what)
    if not n or v is None:
        return None
    return scale * v / n


def device_ms_per(trace: Trace, ranges, over: str) -> Optional[float]:
    n = trace.counters.get(over)
    s = trace.device_s_in(ranges)
    if not n or s is None:
        return None
    return 1e3 * s / n


def bucket_quantile(buckets: Dict[int, int], res: int, q: float) -> Optional[float]:
    """The q-quantile of a log-bucketed histogram's counts (the port's
    ``obs.metrics.Histogram`` buckets: bucket i covers [2^(i/res),
    2^((i+1)/res))), as the bucket's geometric midpoint."""
    total = sum(buckets.values())
    if not total:
        return None
    rank, seen = q * (total - 1), 0
    for i in sorted(buckets):
        seen += buckets[i]
        if seen > rank:
            return 2.0 ** ((i + 0.5) / res)
    return None
