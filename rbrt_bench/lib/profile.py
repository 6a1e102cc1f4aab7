"""A traced window: what ran on the device, and which host range
launched it.

:func:`traced` runs a callable under ``torch.profiler`` (host and CUDA
activity) and returns a :class:`Trace`.  Device busy time is the union of
the intervals of the device's kernels, copies and fills over the host
wall time of the call, which ends with a synchronize (the profiler's own
host cost counts as idle).  A kernel is attributed to a host range (a
``record_function`` range, such as the port's spans while tracing is on,
or the benchmark's own wrappers) through its launch's correlation id:
it belongs to every range of that name whose interval holds the launch.
The method is ``chip_smoke.py``'s ``profile_window``.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    """One traced window, with what the loop and the wrappers counted
    in it."""

    window_s: float
    ops: List[Tuple[float, float, str, Optional[int]]]   # (start µs, end µs, name, corr)
    launches: Dict[int, float]                          # corr → launch µs
    ranges: Dict[str, Tuple[List[float], List[float]]]  # name → union of its ranges, µs
    raw_ranges: Dict[str, List[Tuple[float, float]]]     # name → its ranges, µs
    n_kernels: int = 0                                    # ops that are kernels
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    calls: List[dict] = dataclasses.field(default_factory=list)

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, -1.0
        for s, e, _, _ in self.ops:
            busy += max(0.0, e - max(s, end))
            end = max(end, e)
        return busy / 1e6

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)

    def in_range(self, corr: Optional[int], names: Iterable[str]) -> bool:
        t = self.launches.get(corr)
        if t is None:
            return False
        for name in names:
            starts, ends = self.ranges.get(name, ([], []))
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ends[i]:
                return True
        return False

    def device_s_in(self, names: Iterable[str]) -> Optional[float]:
        """Device seconds of the ops launched inside any range of these
        names; None where the window holds no such range."""
        names = tuple(names)
        if not any(self.ranges.get(n, ([], []))[0] for n in names):
            return None
        return sum(e - s for s, e, _, corr in self.ops if self.in_range(corr, names)) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for s, e, name, _ in self.ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest gaps between device ops, named by the innermost host
        range open at the gap's start ("host" where none is)."""
        gaps, end = [], None
        for s, e, _, _ in self.ops:
            if end is not None and s > end:
                gaps.append((s - end, end))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for dur, t in gaps[:n]:
            out.append([self._range_at(t), dur / 1e6])
        return out

    def _range_at(self, t: float) -> str:
        best, best_start = "host", -1.0
        for name, iv in self.raw_ranges.items():
            for s, e in iv:
                if s <= t <= e and s > best_start:
                    best, best_start = name, s
        return best[:120]


def traced(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` under the profiler, ended by a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return trace_from_events(events, window_s)


def trace_from_events(events: List[dict], window_s: float) -> Trace:
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"],
                  e.get("args", {}).get("correlation"))
                 for e in events if e.get("cat") in DEVICE_CATS)
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    spans: Dict[str, List[Tuple[float, float]]] = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            s = float(e["ts"])
            spans.setdefault(e["name"], []).append((s, s + float(e.get("dur", 0))))
    ranges = {}
    for name, iv in spans.items():
        iv.sort()
        starts, ends = [], []
        for s, e in iv:                     # the union: nested ranges merge
            if ends and s <= ends[-1]:
                ends[-1] = max(ends[-1], e)
            else:
                starts.append(s)
                ends.append(e)
        ranges[name] = (starts, ends)
    return Trace(window_s=window_s, ops=ops, launches=launches, ranges=ranges,
                 raw_ranges=spans,
                 n_kernels=sum(1 for e in events if e.get("cat") == "kernel"))
