"""Flight recorder: always-on ring-buffer tracing with trigger dumps.

Full tracing is an enable → run → dump workflow: the
:class:`~repro_torch.obs.trace.Tracer` buffers every span unboundedly, which a
long-running serve/ingest loop cannot afford.  The flight recorder runs
the SAME tracer in ring mode — the newest ``capacity`` spans are kept,
the oldest silently overwritten, O(1) memory forever — so the spans
surrounding an incident are always available without ever paying full
capture.

Dumps are *trigger based*: the hosting loop feeds per-request latencies
(:meth:`FlightRecorder.observe_latency`) and exceptions
(:meth:`FlightRecorder.observe_error`); when a latency crosses the
threshold or an error fires, the recorder snapshots the ring to a
Perfetto-loadable Chrome-trace file (``FLIGHT_<name>_<seq>.json``) with
an instant event marking what tripped it.  A cooldown and a dump budget
keep a sustained incident from writing the same story to disk hundreds
of times; suppressed triggers are still counted
(``flight.suppressed``), so the metrics tell you the incident kept
going after the first dump.  The cooldown reads ``clock`` (default
``time.perf_counter``), which tests replace with a stepped one.

Typical wiring (the serving CLIs do exactly this)::

    flight = FlightRecorder(capacity=4096, latency_trigger_ms=50.0)
    flight.start()                       # ring-mode tracing, always on
    service = RelationalScoringService(..., flight=flight)
    # ... tail-latency spike → FLIGHT_serving_000.json appears, holding
    # the last 4096 spans around the offending batch
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, List, Optional

from .metrics import get_registry
from .trace import Tracer, get_tracer

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded always-on tracing plus threshold/error-triggered dumps."""

    def __init__(
        self,
        capacity: int = 4096,
        out_dir: str = ".",
        name: str = "flight",
        latency_trigger_ms: Optional[float] = None,
        error_trigger: bool = True,
        cooldown_s: float = 30.0,
        max_dumps: int = 16,
        tracer: Optional[Tracer] = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.capacity = int(capacity)
        self.out_dir = out_dir
        self.name = name
        self.latency_trigger_ms = latency_trigger_ms
        self.error_trigger = error_trigger
        self.cooldown_s = cooldown_s
        self.max_dumps = max_dumps
        self.tracer = tracer if tracer is not None else get_tracer()
        self.clock = clock
        self.dumps: List[dict] = []          # {path, reason, n_events, ts}
        self.suppressed = 0                  # triggers inside cooldown/budget
        self._lock = threading.Lock()
        self._last_dump_t: Optional[float] = None
        self._active = False

    # -------------------------------------------------------------- control --
    def start(self) -> "FlightRecorder":
        """Switch the tracer into ring mode and enable recording.  Events
        already buffered are kept (newest-first if they overflow)."""
        self.tracer.set_ring(self.capacity)
        self.tracer.enabled = True
        self._active = True
        return self

    def stop(self) -> "FlightRecorder":
        """Stop recording and return the tracer to the unbounded sink
        (the ring's current contents are preserved for a final dump)."""
        self._active = False
        self.tracer.enabled = False
        self.tracer.set_unbounded()
        return self

    @property
    def active(self) -> bool:
        return self._active

    # ------------------------------------------------------------- triggers --
    def observe_latency(self, ms: float, **attrs) -> Optional[str]:
        """Feed one request/batch latency; dumps when it crosses the
        threshold.  Returns the dump path when one was written."""
        if self.latency_trigger_ms is None or ms < self.latency_trigger_ms:
            return None
        return self.trigger(
            f"latency {ms:.1f}ms >= trigger {self.latency_trigger_ms:g}ms",
            latency_ms=round(float(ms), 3), **attrs)

    def observe_error(self, exc: BaseException, **attrs) -> Optional[str]:
        """Feed one exception; dumps unless error triggering is off."""
        if not self.error_trigger:
            return None
        return self.trigger(f"error {type(exc).__name__}: {exc}",
                            error=type(exc).__name__, **attrs)

    def trigger(self, reason: str, **attrs) -> Optional[str]:
        """Snapshot the ring to a Perfetto-loadable file (rate-limited).

        Thread-safe; returns None when suppressed by the cooldown or the
        dump budget (counted in ``flight.suppressed``)."""
        reg = get_registry()
        now = self.clock()
        with self._lock:
            blocked = (
                len(self.dumps) >= self.max_dumps
                or (self._last_dump_t is not None
                    and now - self._last_dump_t < self.cooldown_s)
            )
            if blocked:
                self.suppressed += 1
                reg.counter("flight.suppressed").inc()
                return None
            self._last_dump_t = now
            seq = len(self.dumps)
            rec = {"path": None, "reason": reason, "n_events": 0,
                   "ts": time.time()}
            self.dumps.append(rec)          # reserve the sequence slot
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"FLIGHT_{self.name}_{seq:03d}.json")
        doc = self.tracer.to_chrome_trace()
        # instant event marking the trigger, so the dump is self-describing
        # on the Perfetto timeline ("i" = instant, "s": "g" = global scope)
        doc["traceEvents"].append({
            "name": "flight.trigger", "ph": "i", "s": "g", "cat": "obs",
            "ts": round((time.perf_counter() - self.tracer._t0) * 1e6, 3),
            "pid": 1, "tid": 0,
            "args": {"reason": reason, **attrs},
        })
        with open(path, "w") as f:
            json.dump(doc, f)
        rec["path"] = path
        rec["n_events"] = len(doc["traceEvents"])
        reg.counter("flight.dumps").inc()
        return path

    # -------------------------------------------------------------- queries --
    def snapshot(self) -> List[dict]:
        """The ring's current events, oldest first (for ``/tracez``)."""
        with self.tracer._lock:
            return list(self.tracer.events)

    def status(self) -> dict:
        """JSON-able summary for ``/statusz`` and exit reports."""
        return {
            "active": self._active,
            "capacity": self.capacity,
            "buffered": len(self.tracer.events),
            "latency_trigger_ms": self.latency_trigger_ms,
            "error_trigger": self.error_trigger,
            "dumps": [dict(d) for d in self.dumps],
            "suppressed": self.suppressed,
        }
