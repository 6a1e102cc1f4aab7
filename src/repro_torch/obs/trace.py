"""Nestable wall-clock spans, default off.

``span(...)`` returns a shared no-op context manager unless tracing was
enabled, so instrumented hot paths (message emission, level steps, the
serving batcher) pay one truthiness check when disabled.  Enabled, each
span records its wall time (``perf_counter``), thread, nesting depth and
attributes into the process-wide :class:`Tracer`.

CUDA work is asynchronous: a span closes when the host has enqueued its
kernels, not when they finished.  :func:`fence` synchronizes the device,
but only while tracing is enabled, so the disabled path never
serializes the stream.
"""
from __future__ import annotations

import threading
import time
from typing import Any, List

import torch

__all__ = ["Tracer", "span", "fence", "enable_tracing", "disable_tracing",
           "get_tracer"]


class Tracer:
    """Process-wide span recorder; ``enable_tracing()`` switches it on."""

    def __init__(self):
        self.enabled = False
        self.events: List[dict] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._t0 = time.perf_counter()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def record(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
        self._t0 = time.perf_counter()


class _Span:
    """Recording context manager (only built while tracing is enabled)."""

    __slots__ = ("tracer", "name", "attrs", "t0")

    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self.tracer._stack().append(self)
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


def enable_tracing(clear: bool = True) -> Tracer:
    if clear:
        _tracer.clear()
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
