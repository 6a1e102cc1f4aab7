"""The window arithmetic of the end-to-end metrics."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def per_request_s(starts: Sequence[float], ends: Sequence[float]) -> float:
    """Seconds a request over a closed loop's window: from the first
    request's start to the last one's end, over the number of requests.
    Every request that started in the window has finished, so the window
    holds whole requests only."""
    if not starts or len(starts) != len(ends):
        raise ValueError("per_request_s takes one start and one end a request, at least one")
    return (max(ends) - min(starts)) / len(starts)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of all values, by linear interpolation between
    order statistics (numpy's default)."""
    if len(values) == 0:
        raise ValueError("percentile of no values")
    return float(np.percentile(np.asarray(values, np.float64), q))

