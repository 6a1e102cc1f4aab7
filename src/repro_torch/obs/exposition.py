"""Metrics exposition: Prometheus/JSON rendering, HTTP endpoints, sampler.

Everything here is dependency-free (stdlib asyncio + json), so the
serving loop exposes live telemetry without pulling a web framework
into the tree:

- :func:`render_prometheus` / :func:`render_json` — turn any
  :meth:`MetricsRegistry.snapshot` dict into Prometheus text format
  (counters/gauges verbatim, histograms as summaries with
  p50/p90/p99 quantile labels) or pretty JSON;
- :class:`TelemetryServer` — a minimal asyncio HTTP listener serving

  =============  =====================================================
  ``/metricsz``  Prometheus text (``?format=json`` for the raw snapshot)
  ``/healthz``   SLO burn-rate state — 200 healthy/degraded, 503 unhealthy
  ``/statusz``   uptime, host-provided status dict, SLO + flight summary
  ``/tracez``    newest ``?n=`` spans from the tracer/flight ring (JSON)
  =============  =====================================================

  It attaches to an already-running asyncio loop (``await start()``,
  the scoring service's world) or hosts its own loop in a daemon
  thread (``start_in_thread()``, the synchronous delta/retrain
  CLIs' world).  Port 0 binds an ephemeral port; the bound port is
  published on ``self.port``.
- :class:`PeriodicSampler` — appends timestamped snapshot *deltas* to a
  JSONL time series, so a whole run's trajectory (qps, p99, cache hit
  rate, ``ivm.deltas``, drift) can be plotted rather than only its
  endpoint.
"""
from __future__ import annotations

import asyncio
import json
import re
import threading
import time
from typing import Callable, Dict, List, Optional
from urllib.parse import parse_qs, urlsplit

from .metrics import MetricsRegistry, diff_snapshots, get_registry, merge_snapshots
from .trace import Tracer, get_tracer

__all__ = ["render_prometheus", "render_json", "TelemetryServer",
           "PeriodicSampler"]

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, namespace: str) -> str:
    base = _NAME_OK.sub("_", name)
    return f"{namespace}_{base}" if namespace else base


def _prom_value(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f) if isinstance(v, float) else str(v)


def render_prometheus(snapshot: Dict[str, dict], namespace: str = "repro") -> str:
    """Prometheus text exposition (v0.0.4) of a registry snapshot.

    Counters and gauges render as their native types; histograms render
    as SUMMARIES (quantile-labelled series + ``_sum``/``_count``) —
    the log-bucket grid already gives exact mergeable quantiles, so
    re-encoding it as cumulative ``le`` buckets would only lose that.
    """
    lines: List[str] = []
    for name in sorted(snapshot):
        m = snapshot[name]
        pn = _prom_name(name, namespace)
        if m["type"] == "counter":
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn} {_prom_value(m['value'])}")
        elif m["type"] == "gauge":
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {_prom_value(m['value'])}")
        else:
            lines.append(f"# TYPE {pn} summary")
            for q in ("0.5", "0.9", "0.99"):
                key = "p" + str(int(float(q) * 100))
                lines.append(f'{pn}{{quantile="{q}"}} '
                             f"{_prom_value(m.get(key))}")
            lines.append(f"{pn}_sum {_prom_value(m.get('sum', 0.0))}")
            lines.append(f"{pn}_count {_prom_value(m.get('count', 0))}")
    return "\n".join(lines) + "\n"


def render_json(snapshot: Dict[str, dict]) -> str:
    return json.dumps(snapshot, indent=1, sort_keys=True, default=str)


class TelemetryServer:
    """Dependency-free asyncio HTTP listener for the obs endpoints."""

    def __init__(
        self,
        registries: Optional[List[MetricsRegistry]] = None,
        slo=None,                       # SLOMonitor (obs/slo.py), optional
        flight=None,                    # FlightRecorder (obs/flight.py)
        tracer: Optional[Tracer] = None,
        status_fn: Optional[Callable[[], dict]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        namespace: str = "repro",
    ):
        self.registries = registries
        self.slo = slo
        self.flight = flight
        self.tracer = tracer if tracer is not None else get_tracer()
        self.status_fn = status_fn
        self.host = host
        self.port = port
        self.namespace = namespace
        self._server: Optional[asyncio.AbstractServer] = None
        self._t_start = time.time()
        self._thread: Optional[threading.Thread] = None
        self._thread_loop: Optional[asyncio.AbstractEventLoop] = None

    # ------------------------------------------------------------- snapshot --
    def snapshot(self) -> Dict[str, dict]:
        """⊎ of the process registry and every attached registry."""
        regs = self.registries if self.registries is not None else [get_registry()]
        snap: Dict[str, dict] = {}
        for r in regs:
            snap = merge_snapshots(snap, r.snapshot()) if snap else r.snapshot()
        return snap

    # ------------------------------------------------------------- lifecycle --
    async def start(self) -> "TelemetryServer":
        self._server = await asyncio.start_server(
            self._handle, host=self.host, port=self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._t_start = time.time()
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def url(self, path: str = "/metricsz") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def start_in_thread(self, timeout: float = 5.0) -> int:
        """Host the listener on its own daemon-thread event loop — for
        the synchronous CLIs (stream_deltas / retrain_stream)."""
        started = threading.Event()

        def run():
            loop = asyncio.new_event_loop()
            self._thread_loop = loop
            asyncio.set_event_loop(loop)
            loop.run_until_complete(self.start())
            started.set()
            loop.run_forever()
            loop.run_until_complete(self.stop())
            loop.close()

        self._thread = threading.Thread(
            target=run, name="telemetry-server", daemon=True)
        self._thread.start()
        if not started.wait(timeout):
            raise RuntimeError("telemetry server failed to start")
        return self.port

    def stop_thread(self, timeout: float = 5.0) -> None:
        if self._thread_loop is not None:
            self._thread_loop.call_soon_threadsafe(self._thread_loop.stop)
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # --------------------------------------------------------------- routes --
    def _route(self, target: str):
        """(status, content-type, body bytes) for one GET target."""
        parts = urlsplit(target)
        path = parts.path.rstrip("/") or "/"
        q = parse_qs(parts.query)
        if path == "/metricsz":
            if q.get("format", [""])[0] == "json":
                return 200, "application/json", render_json(self.snapshot())
            return (200, "text/plain; version=0.0.4; charset=utf-8",
                    render_prometheus(self.snapshot(), self.namespace))
        if path == "/healthz":
            if self.slo is None:
                return 200, "application/json", json.dumps(
                    {"state": "healthy", "slo": None})
            rep = self.slo.evaluate()
            code = 503 if rep["state"] == "unhealthy" else 200
            return code, "application/json", json.dumps(rep, default=str)
        if path == "/statusz":
            doc = {
                "uptime_s": round(time.time() - self._t_start, 3),
                "time": time.time(),
            }
            if self.status_fn is not None:
                try:
                    doc.update(self.status_fn())
                except Exception as e:   # status must never take down /statusz
                    doc["status_error"] = repr(e)
            if self.slo is not None:
                doc["slo"] = self.slo.evaluate()
            if self.flight is not None:
                doc["flight"] = self.flight.status()
            return 200, "application/json", json.dumps(doc, default=str)
        if path == "/tracez":
            try:
                n = max(1, int(q.get("n", ["64"])[0]))
            except ValueError:
                n = 64
            with self.tracer._lock:
                evs = list(self.tracer.events)[-n:]
            return 200, "application/json", json.dumps({
                "enabled": self.tracer.enabled,
                "ring_capacity": self.tracer.ring_capacity,
                "buffered": len(evs),
                "spans": evs,
            })
        return 404, "text/plain; charset=utf-8", f"no route {path!r}\n"

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                req = await asyncio.wait_for(reader.readline(), timeout=5.0)
            except asyncio.TimeoutError:
                return
            parts = req.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, target = parts[0], parts[1]
            while True:                           # drain request headers
                line = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            if method not in ("GET", "HEAD"):
                status, ctype, body = 405, "text/plain", "GET only\n"
            else:
                status, ctype, body = self._route(target)
            payload = body.encode() if isinstance(body, str) else body
            reason = {200: "OK", 404: "Not Found", 405: "Method Not Allowed",
                      503: "Service Unavailable"}.get(status, "OK")
            head = (f"HTTP/1.1 {status} {reason}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(payload)}\r\n"
                    f"Connection: close\r\n\r\n")
            writer.write(head.encode() + (b"" if method == "HEAD" else payload))
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass


class PeriodicSampler:
    """Appends timestamped registry-snapshot deltas to a JSONL series.

    Each line is ``{"t": epoch, "dt_s": window, "series": diff}`` where
    ``diff`` is :func:`diff_snapshots` of consecutive snapshots —
    counters become per-window work (qps = value/dt_s), gauges keep
    their latest value, histograms carry the window's count/sum and
    re-estimated quantiles.  ``extra_fn`` merges host context (SLO
    state, data_version, staleness) into every line.  Runs on a daemon
    thread so both async services and synchronous CLIs can host it;
    ``stop()`` writes one final sample so short runs still record.
    """

    def __init__(
        self,
        path: str,
        interval_s: float = 1.0,
        registries: Optional[List[MetricsRegistry]] = None,
        extra_fn: Optional[Callable[[], dict]] = None,
    ):
        self.path = path
        self.interval_s = interval_s
        self.registries = registries
        self.extra_fn = extra_fn
        self.samples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev: Optional[Dict[str, dict]] = None
        self._prev_t = 0.0
        self._fh = None

    def _snapshot(self) -> Dict[str, dict]:
        regs = self.registries if self.registries is not None else [get_registry()]
        snap: Dict[str, dict] = {}
        for r in regs:
            snap = merge_snapshots(snap, r.snapshot()) if snap else r.snapshot()
        return snap

    def sample(self) -> dict:
        """Take (and append) one sample now; returns the written line."""
        now = time.time()
        cur = self._snapshot()
        prev = self._prev if self._prev is not None else {}
        line = {
            "t": round(now, 3),
            "dt_s": round(now - self._prev_t, 3) if self._prev is not None else 0.0,
            "series": diff_snapshots(prev, cur),
        }
        if self.extra_fn is not None:
            try:
                line.update(self.extra_fn())
            except Exception as e:
                line["extra_error"] = repr(e)
        self._prev, self._prev_t = cur, now
        self._fh.write(json.dumps(line, default=str) + "\n")
        self._fh.flush()
        self.samples += 1
        return line

    def start(self) -> "PeriodicSampler":
        self._fh = open(self.path, "a")
        self._prev, self._prev_t = self._snapshot(), time.time()

        def run():
            while not self._stop.wait(self.interval_s):
                self.sample()

        self._thread = threading.Thread(
            target=run, name="telemetry-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(max(5.0, 2 * self.interval_s))
        self._thread = None
        self.sample()                    # final window, so short runs record
        self._fh.close()
        self._fh = None
