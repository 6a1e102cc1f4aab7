"""Nestable wall-clock spans with thread-local stacks and Chrome-trace export.

Default-off: ``span(...)`` returns a shared no-op context manager unless
tracing was enabled, so instrumented hot paths (message emission, level
steps, the serving batcher) pay one truthiness check when disabled.
Enabled, each span records its wall time (``perf_counter``), thread,
nesting depth and attributes into the process-wide :class:`Tracer`.

Two export formats:

- ``dump_jsonl(path)`` — one event per line;
- ``dump_chrome_trace(path)`` — Chrome's Trace Event JSON ("X" complete
  events), loadable in ``chrome://tracing`` / https://ui.perfetto.dev.

A tracer in ring mode (``set_ring``) keeps only its newest events: the
flight recorder's always-on tracing with bounded memory.

Profiler passthrough: while ``torch_annotations`` is on, each span also
enters ``torch.profiler.record_function`` under its name, so a
``torch.profiler`` capture shows the host spans above the kernels they
launched.

CUDA work is asynchronous: a span closes when the host has enqueued its
kernels, not when they finished.  :func:`fence` synchronizes the device,
but only while tracing is enabled, so the disabled path never
serializes the stream.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

__all__ = ["Tracer", "span", "fence", "enable_tracing", "disable_tracing",
           "tracing_enabled", "get_tracer"]


class Tracer:
    """Process-wide span recorder; ``enable_tracing()`` switches it on."""

    def __init__(self, torch_annotations: bool = True):
        self.enabled = False
        self.torch_annotations = torch_annotations
        self.events: List[dict] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        # every thread's span stack, so clear() can reset them all: a span
        # leaked across an enable/disable cycle must not skew the depth of
        # every later span on its thread
        self._stacks: List[list] = []
        self._t0 = time.perf_counter()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
            with self._lock:
                self._stacks.append(st)
        return st

    def record(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            for st in self._stacks:
                del st[:]
        self._t0 = time.perf_counter()

    # --------------------------------------------------------- ring buffer --
    @property
    def ring_capacity(self) -> Optional[int]:
        """Flight-recorder capacity, or None when unbounded."""
        return self.events.maxlen if isinstance(self.events, deque) else None

    def set_ring(self, capacity: int) -> None:
        """Keep only the newest ``capacity`` events (overwrite-oldest, O(1)
        a span): always-on tracing with bounded memory."""
        if capacity <= 0:
            raise ValueError(f"ring capacity must be positive, got {capacity}")
        with self._lock:
            self.events = deque(self.events, maxlen=capacity)

    def set_unbounded(self) -> None:
        """Back to the unbounded list sink (full-trace capture mode)."""
        with self._lock:
            self.events = list(self.events)

    # ------------------------------------------------------------- rollups --
    def rollup(self) -> Dict[str, dict]:
        """Per-span-name {count, total_ms, max_ms} aggregate."""
        with self._lock:
            events = list(self.events)
        out: Dict[str, dict] = {}
        for e in events:
            r = out.setdefault(e["name"], {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
            r["count"] += 1
            r["total_ms"] += e["dur_ms"]
            r["max_ms"] = max(r["max_ms"], e["dur_ms"])
        for r in out.values():
            r["total_ms"] = round(r["total_ms"], 3)
            r["max_ms"] = round(r["max_ms"], 3)
        return out

    # ------------------------------------------------------------- exports --
    def dump_jsonl(self, path: str) -> int:
        with self._lock:
            events = list(self.events)
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        return len(events)

    def to_chrome_trace(self) -> dict:
        """Trace Event Format dict (open in Perfetto / chrome://tracing)."""
        with self._lock:
            events = list(self.events)
        trace = []
        for e in events:
            args = {k: v for k, v in e.items() if k not in ("name", "ts_ms", "dur_ms", "tid")}
            trace.append({
                "name": e["name"], "ph": "X", "cat": "obs",
                "ts": round(e["ts_ms"] * 1e3, 3),     # µs
                "dur": round(e["dur_ms"] * 1e3, 3),
                "pid": 1, "tid": e["tid"],
                "args": args,
            })
        return {"traceEvents": trace, "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path: str) -> int:
        doc = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])


class _Span:
    """Recording context manager (only built while tracing is enabled)."""

    __slots__ = ("tracer", "name", "attrs", "t0", "_prof")

    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self._prof = None

    def __enter__(self):
        tr = self.tracer
        tr._stack().append(self)
        if tr.torch_annotations:
            self._prof = torch.profiler.record_function(self.name)
            self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        tr = self.tracer
        stack = tr._stack()
        while stack and stack[-1] is not self:    # pop leaked inner spans
            stack.pop()
        if stack:
            stack.pop()
        ev = {
            "name": self.name,
            "ts_ms": (self.t0 - tr._t0) * 1e3,
            "dur_ms": (t1 - self.t0) * 1e3,
            "tid": threading.get_ident() & 0xFFFF,
            "depth": len(stack),
        }
        if exc_type is not None:
            ev["error"] = exc_type.__name__
        ev.update(self.attrs)
        tr.record(ev)
        if self._prof is not None:
            self._prof.__exit__(exc_type, exc, tb)
        return False


class _NullSpan:
    """Shared do-nothing context manager — the disabled-mode fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL = _NullSpan()
_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def tracing_enabled() -> bool:
    return _tracer.enabled


def enable_tracing(clear: bool = True, torch_annotations: bool = True) -> Tracer:
    if clear:
        _tracer.clear()
    _tracer.torch_annotations = torch_annotations
    _tracer.enabled = True
    return _tracer


def disable_tracing() -> Tracer:
    _tracer.enabled = False
    return _tracer


def span(name: str, **attrs):
    """``with span("boost.level", level=2):`` — records a span while
    tracing is enabled, otherwise returns the shared no-op manager."""
    if not _tracer.enabled:
        return _NULL
    return _Span(_tracer, name, attrs)


def fence(value: Any) -> Any:
    """Wait for queued CUDA work, but ONLY while tracing, so spans
    measure finished device work without the disabled path ever paying a
    synchronization."""
    if _tracer.enabled and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return value
