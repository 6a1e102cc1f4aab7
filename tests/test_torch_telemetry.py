"""The port's live telemetry against the JAX package's: Prometheus and
JSON rendering give the same text for the same series, ``parse_slo_spec``
the same objectives and refusals, ``SLOMonitor`` the same burn rates and
states under the same stepped clock; the flight recorder's ring, dumps,
cooldown and budget under an injected clock; the telemetry server's
endpoints on an ephemeral loopback port; the sampler's deltas.  Then the
scoring service's hooks: burn-rate shedding, the burning queue-depth
shed, the degraded and deadline cutoffs of the coalescing window, the
staleness gauge over a ``MaintainedScorer`` and ``extra_staleness``, and
a flight dump on a failed dispatch.

Every SLO state here is driven by a stepped clock or a stub monitor,
never by sleeps or measured latency.  Tolerances: exact (text, counts,
states); burn rates are the same float expressions on both sides."""
from __future__ import annotations

import asyncio
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.obs import (MetricsRegistry as RRegistry, SLOMonitor as RMonitor,
                       SLOObjective as RObjective, parse_slo_spec as rparse,
                       render_json as rrender_json, render_prometheus as rrender_prom)
from repro.obs.metrics import diff_snapshots as rdiff

from repro_torch import convert
from repro_torch.core import BoostConfig, Booster
from repro_torch.incremental import MaintainedScorer
from repro_torch.obs import (
    FlightRecorder, MetricsRegistry, PeriodicSampler, SLOMonitor, SLOObjective,
    TelemetryServer, Tracer, disable_tracing, parse_slo_spec, render_json,
    render_prometheus,
)
from repro_torch.relational.generators import delta_stream
from repro_torch.serving import (ModelRegistry, RelationalScoringService,
                                 ServiceOverloadedError, compile_ensemble)
from repro_torch.serving.service import _Request


class FakeClock:
    """A monotonic clock that moves only when told to."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _mon(cls, objectives, clk, registry, fast=60.0, slow=600.0, **kw):
    kw.setdefault("state_ttl_s", 0.0)
    return cls(objectives, fast_window_s=fast, slow_window_s=slow, clock=clk,
               registry=registry, **kw)


def _fill(reg):
    """The same series in either package's registry."""
    reg.counter("svc.requests").inc(7)
    reg.counter("a-b/c").inc(2)
    reg.gauge("ivm.staleness_s").set(0.25)
    reg.gauge("slo.state").set(1)
    h = reg.histogram("svc.latency_ms")
    for x in (0.0, 0.3, 1.0, 2.5, 2.5, 40.0, 1e4):
        h.observe(x)
    reg.histogram("empty_ms")


# -------------------------------------------------------------- exposition --
@pytest.mark.parametrize("namespace", ["repro", "", "svc"])
def test_render_prometheus_and_json_match_reference(namespace):
    ours, ref = MetricsRegistry(), RRegistry()
    _fill(ours)
    _fill(ref)
    snap, rsnap = ours.snapshot(), ref.snapshot()
    assert snap == rsnap
    assert render_prometheus(snap, namespace) == rrender_prom(rsnap, namespace)
    assert render_json(snap) == rrender_json(rsnap)
    text = render_prometheus(snap, namespace)
    pn = f"{namespace}_" if namespace else ""
    assert f"# TYPE {pn}svc_requests counter\n{pn}svc_requests 7\n" in text
    assert f'{pn}svc_latency_ms{{quantile="0.5"}}' in text and f"{pn}a_b_c 2" in text


# ------------------------------------------------------------------- parse --
@pytest.mark.parametrize("spec", [
    "latency=50ms@0.99,errors=0.01,staleness=5s",
    "latency=0.2s", "latency=500us@0.9", "latency=75", "errors=0.05", "error_rate=0.2",
    "staleness=250ms", "staleness=3", " latency=10ms , staleness=2s ",
])
def test_parse_slo_spec_matches_reference(spec):
    ours, ref = parse_slo_spec(spec), rparse(spec)
    assert [(o.name, o.kind, o.target, o.objective, o.degrade_only, o.budget) for o in ours] \
        == [(o.name, o.kind, o.target, o.objective, o.degrade_only, o.budget) for o in ref]


@pytest.mark.parametrize("bad", ["", "latency", "latency=fast", "errors=1ms", "foo=1",
                                 "latency=-5ms", "latency=5ms@1.5", "staleness=0s"])
def test_parse_slo_spec_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        rparse(bad)
    with pytest.raises(ValueError):
        parse_slo_spec(bad)


def test_slo_objective_and_monitor_validation():
    for kw in (dict(kind="nope", target=1.0), dict(kind="latency", target=0.0),
               dict(kind="latency", target=1.0, objective=1.0)):
        with pytest.raises(ValueError):
            SLOObjective("x", **kw)
    o = SLOObjective("x", "latency", 50.0)
    with pytest.raises(ValueError, match="fast window"):
        SLOMonitor([o], fast_window_s=60.0, slow_window_s=60.0)
    with pytest.raises(ValueError, match="duplicate"):
        SLOMonitor([o, o])


# ------------------------------------------------------------ burn rates --
def _script(mon, clk):
    """One stepped-clock event sequence; the reports after each step."""
    out = [mon.evaluate()]
    for _ in range(100):
        mon.record_latency(10.0)
        mon.record_request(error=False)
    out.append(mon.evaluate())
    for _ in range(30):
        mon.record_latency(500.0)
    mon.set_staleness(7.0)
    out.append(mon.evaluate())
    clk.advance(45.0)
    for _ in range(200):
        mon.record_latency(500.0)
        mon.record_request(error=True)
    mon.set_staleness(40.0)
    out.append(mon.evaluate())
    clk.advance(90.0)                    # the fast window forgets
    for _ in range(20):
        mon.record_latency(1.0)
    mon.set_staleness(1.0)
    out.append(mon.evaluate())
    clk.advance(700.0)                   # and the slow one
    out.append(mon.evaluate())
    return out


@pytest.mark.parametrize("degrade_only", [False, True])
def test_slo_monitor_matches_reference_under_a_stepped_clock(degrade_only):
    spec = "latency=50ms@0.9,errors=0.05,staleness=5s"
    ours = [SLOObjective(o.name, o.kind, o.target, o.objective,
                         degrade_only and o.kind == "staleness") for o in parse_slo_spec(spec)]
    refs = [RObjective(o.name, o.kind, o.target, o.objective,
                       degrade_only and o.kind == "staleness") for o in rparse(spec)]
    clk, rclk = FakeClock(), FakeClock()
    reg, rreg = MetricsRegistry(), RRegistry()
    got = _script(_mon(SLOMonitor, ours, clk, reg), clk)
    want = _script(_mon(RMonitor, refs, rclk, rreg), rclk)
    assert got == want
    assert reg.snapshot() == rreg.snapshot()
    states = [r["state"] for r in got]
    assert states[0] == "healthy" and "unhealthy" in states and states[-1] == "healthy"
    stale = [r["objectives"]["staleness"]["state"] for r in got]
    assert ("unhealthy" in stale) is not degrade_only and "degraded" in stale


def test_slo_state_ttl_caches_evaluation():
    clk = FakeClock()
    mon = _mon(SLOMonitor, [SLOObjective("latency", "latency", 50.0, objective=0.9)], clk,
               MetricsRegistry(), state_ttl_s=10.0)
    assert mon.state() == "healthy"
    for _ in range(50):
        mon.record_latency(500.0)
    assert mon.state() == "healthy"      # the cached verdict inside the TTL
    clk.advance(11.0)
    assert mon.state() == "unhealthy"
    assert mon.compliance("latency") == 0.0


# ---------------------------------------------------------- flight recorder --
def _feed(tr, n, start=0):
    for i in range(start, start + n):
        tr.record({"name": f"s{i}", "ts_ms": float(i), "dur_ms": 1.0, "tid": 0, "depth": 0})


def test_flight_ring_wraps_and_keeps_newest(tmp_path):
    tr = Tracer(torch_annotations=False)
    fl = FlightRecorder(capacity=16, out_dir=str(tmp_path), tracer=tr).start()
    assert tr.enabled and tr.ring_capacity == 16
    _feed(tr, 40)
    assert [e["name"] for e in fl.snapshot()] == [f"s{i}" for i in range(24, 40)]
    fl.stop()
    assert tr.ring_capacity is None and not tr.enabled and len(tr.events) == 16


def test_flight_dump_is_perfetto_loadable(tmp_path):
    tr = Tracer(torch_annotations=False)
    fl = FlightRecorder(capacity=8, out_dir=str(tmp_path), name="t", tracer=tr).start()
    _feed(tr, 12)
    path = fl.trigger("manual test", batch=3)
    assert path.endswith("FLIGHT_t_000.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert len(events) == 9              # the 8 newest spans and the trigger instant
    assert [e["ph"] for e in events] == ["X"] * 8 + ["i"]
    assert [e["name"] for e in events[:8]] == [f"s{i}" for i in range(4, 12)]
    trig = events[-1]
    assert trig["name"] == "flight.trigger" and trig["s"] == "g"
    assert trig["args"] == {"reason": "manual test", "batch": 3}
    assert fl.status()["dumps"][0]["n_events"] == 9


def test_flight_cooldown_and_budget_under_an_injected_clock(tmp_path):
    clk = FakeClock()
    tr = Tracer(torch_annotations=False)
    fl = FlightRecorder(capacity=8, out_dir=str(tmp_path), name="cd", tracer=tr,
                        latency_trigger_ms=100.0, cooldown_s=30.0, max_dumps=3,
                        clock=clk).start()
    assert fl.observe_latency(99.0) is None                 # under the trigger
    assert fl.observe_latency(150.0) is not None
    clk.advance(29.0)
    assert fl.observe_error(RuntimeError("boom")) is None   # inside the cooldown
    clk.advance(1.0)
    assert "RuntimeError: boom" in open(fl.observe_error(RuntimeError("boom"))).read()
    clk.advance(30.0)
    assert fl.trigger("third") is not None
    clk.advance(300.0)
    assert fl.trigger("over budget") is None
    assert fl.suppressed == 2 and len(fl.dumps) == 3
    quiet = FlightRecorder(out_dir=str(tmp_path), tracer=tr, error_trigger=False)
    assert quiet.observe_error(RuntimeError("x")) is None and quiet.observe_latency(1e9) is None


# ------------------------------------------------------------ HTTP endpoints --
def _get(url):
    with urllib.request.urlopen(url, timeout=10.0) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read().decode()


def test_telemetry_server_endpoints(tmp_path):
    reg = MetricsRegistry()
    reg.counter("tel.hits").inc(3)
    clk = FakeClock()
    slo = _mon(SLOMonitor, [SLOObjective("latency", "latency", 50.0, objective=0.9)], clk, reg)
    tr = Tracer(torch_annotations=False)
    tr.set_ring(8)
    _feed(tr, 5)
    flight = FlightRecorder(capacity=8, out_dir=str(tmp_path), tracer=tr)
    ts = TelemetryServer(registries=[reg], slo=slo, flight=flight, tracer=tr,
                         status_fn=lambda: {"model_version": 7})
    port = ts.start_in_thread()
    assert port > 0 and ts.url("/healthz").endswith(f":{port}/healthz")
    try:
        code, ctype, body = _get(ts.url("/metricsz"))
        assert code == 200 and ctype.startswith("text/plain") and "repro_tel_hits 3" in body
        code, ctype, body = _get(ts.url("/metricsz?format=json"))
        assert ctype == "application/json" and json.loads(body)["tel.hits"]["value"] == 3
        code, _, body = _get(ts.url("/healthz"))
        assert code == 200 and json.loads(body)["state"] == "healthy"
        for _ in range(50):
            slo.record_latency(500.0)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(ts.url("/healthz"))
        assert ei.value.code == 503 and json.loads(ei.value.read())["state"] == "unhealthy"
        code, _, body = _get(ts.url("/statusz"))
        doc = json.loads(body)
        assert doc["model_version"] == 7 and doc["slo"]["state"] == "unhealthy"
        assert doc["flight"]["capacity"] == 8 and doc["uptime_s"] >= 0.0
        code, _, body = _get(ts.url("/tracez?n=2"))
        doc = json.loads(body)
        assert doc["ring_capacity"] == 8 and [s["name"] for s in doc["spans"]] == ["s3", "s4"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(ts.url("/nope"))
        assert ei.value.code == 404
    finally:
        ts.stop_thread()


def test_telemetry_server_on_a_running_loop_merges_registries():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.counter("x").inc(2)
    b.counter("x").inc(5)
    b.gauge("g").set(1.5)

    async def run():
        ts = await TelemetryServer(registries=[a, b], status_fn=lambda: 1 / 0).start()
        loop = asyncio.get_running_loop()
        try:
            got = [await loop.run_in_executor(None, _get, ts.url(p))
                   for p in ("/metricsz", "/healthz", "/statusz")]
        finally:
            await ts.stop()
        return got

    (_, _, prom), (_, _, health), (_, _, status) = asyncio.run(run())
    assert "repro_x 7\n" in prom and "repro_g 1.5\n" in prom
    assert json.loads(health) == {"state": "healthy", "slo": None}
    assert "ZeroDivisionError" in json.loads(status)["status_error"]


def test_periodic_sampler_appends_deltas(tmp_path):
    reg = MetricsRegistry()
    path = tmp_path / "series.jsonl"
    s = PeriodicSampler(str(path), interval_s=3600.0, registries=[reg],
                        extra_fn=lambda: {"ctx": 42}).start()
    before = reg.snapshot()
    reg.counter("work.items").inc(5)
    reg.histogram("lat").observe(2.0)
    line = s.sample()
    assert line["series"]["work.items"]["value"] == 5
    assert line["series"] == rdiff(before, reg.snapshot())
    reg.counter("work.items").inc(2)
    s.stop()                              # writes the final window
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == s.samples == 2 and lines[-1]["ctx"] == 42
    assert lines[-1]["series"]["work.items"]["value"] == 2
    assert lines[-1]["series"]["lat"]["count"] == 0


# ----------------------------------------------------------- service hooks --
@pytest.fixture(scope="module")
def star_model(star):
    """The port's schema of the ``star`` fixture, a 2-tree model of it
    and its compiled ensemble, on the CPU."""
    sch = convert.schema(star[0], device="cpu")
    trees, _ = Booster(sch, BoostConfig(n_trees=2, depth=2, mode="sketch",
                                        ssr_mode="off")).fit()
    return sch, trees, compile_ensemble(sch, trees)


@pytest.fixture(autouse=True)
def _tracing_off():
    disable_tracing()
    yield
    disable_tracing()


class StubSLO:
    """An SLO monitor whose state the test sets."""

    def __init__(self, state="healthy"):
        self._state = state
        self.objectives = {}
        self.latencies, self.outcomes, self.staleness = [], [], []

    def state(self):
        return self._state

    def record_latency(self, ms):
        self.latencies.append(ms)

    def record_request(self, error=False):
        self.outcomes.append(error)

    def set_staleness(self, s):
        self.staleness.append(s)


def _service(ens, group, **kw):
    reg = ModelRegistry()
    reg.publish(ens)
    return RelationalScoringService(reg, group, **kw)


def _serve(svc, rows):
    async def run():
        await svc.start()
        try:
            return await svc.score_many(rows)
        finally:
            await svc.stop()
    return asyncio.run(run())


def test_unhealthy_slo_sheds_admissions(star_model):
    sch, _, ens = star_model
    clk = FakeClock()
    slo = _mon(SLOMonitor, [SLOObjective("latency", "latency", 10.0, objective=0.9)], clk,
               MetricsRegistry())
    for _ in range(50):
        slo.record_latency(500.0)
    assert slo.state() == "unhealthy"
    svc = _service(ens, sch.label_table, slo=slo)
    with pytest.raises(ServiceOverloadedError, match="unhealthy"):
        _serve(svc, [0])
    assert svc.stats.shed == 1 and svc.stats.requests == 0
    kept = _service(ens, sch.label_table, slo=slo, shed_when_unhealthy=False)
    assert len(_serve(kept, [0, 1])) == 2 and kept.stats.shed == 0
    clk.advance(700.0)                    # the burn ages out of both windows
    again = _service(ens, sch.label_table, slo=slo)
    assert len(_serve(again, [0])) == 1 and again.stats.shed == 0


@pytest.mark.parametrize("state,shed", [("healthy", 12 - 8), ("degraded", 12 - 2)])
def test_queue_depth_sheds_past_the_cap_and_past_max_queue_while_burning(star_model,
                                                                          state, shed):
    """12 requests enqueue before the batcher runs (asyncio runs the
    gathered tasks first), so the queue depth each one sees is exact:
    the 4× hard cap sheds past 8 deep, a burning SLO past 2."""
    sch, _, ens = star_model
    svc = _service(ens, sch.label_table, slo=StubSLO(state), max_queue=2, cache_size=0,
                   shed_when_unhealthy=False)

    async def run():
        await svc.start()
        out = await asyncio.gather(*(svc.score(r) for r in range(12)),
                                   return_exceptions=True)
        await svc.stop()
        return out

    out = asyncio.run(run())
    assert sum(isinstance(o, ServiceOverloadedError) for o in out) == shed
    assert svc.stats.shed == shed and svc.stats.requests == 12 - shed
    assert all(isinstance(o, float) for o in out[:12 - shed])


def _collect_now(svc, reqs):
    """Queue ``reqs`` and run one coalescing window on a fresh loop."""
    async def run():
        for r in reqs:
            svc._q.put_nowait(r)
        return await asyncio.wait_for(svc._collect(), timeout=60.0)
    return asyncio.run(run())


def _reqs(n, t_enq):
    return [_Request(i, 1, None, t_enq) for i in range(n)]


def test_degraded_slo_collapses_the_coalescing_window(star_model):
    """With a window of 10,000 s a healthy batcher would wait; a degraded
    one closes the batch as soon as the queue is drained."""
    sch, _, ens = star_model
    svc = _service(ens, sch.label_table, max_batch=100, max_wait_ms=1e7,
                   slo=StubSLO("degraded"))
    batch = _collect_now(svc, _reqs(3, time.perf_counter()))
    assert [r.row_id for r in batch] == [0, 1, 2]


def test_deadline_cutoff_closes_the_window_for_an_old_request(star_model):
    """The oldest request was queued past half its latency budget, so the
    window closes at once whatever max_wait is."""
    sch, _, ens = star_model
    svc = _service(ens, sch.label_table, max_batch=100, max_wait_ms=1e7,
                   latency_budget_ms=20.0, deadline_frac=0.5)
    assert svc.latency_budget == 0.02
    batch = _collect_now(svc, _reqs(2, time.perf_counter() - 3600.0))
    assert len(batch) == 2
    slo = SLOMonitor([SLOObjective("a", "latency", 80.0), SLOObjective("b", "latency", 30.0),
                      SLOObjective("s", "staleness", 5.0)], registry=MetricsRegistry())
    assert _service(ens, sch.label_table, slo=slo).latency_budget == 0.03


def test_staleness_gauge_tracks_a_maintained_scorer(star_model):
    sch, trees, _ = star_model
    ms = MaintainedScorer(compile_ensemble(sch, trees))
    group = sch.label_table
    ms.grouped_cached(group)
    assert ms.staleness_s() == 0.0 and ms.staleness_s(group) == 0.0
    batch = next(iter(delta_stream(sch, ms.live_rows, seed=3, n_batches=1, ops_per_batch=2)))
    ms.apply(batch)
    stale = ms.staleness_s(group)
    assert stale > 0.0 and ms.staleness_s() >= stale
    slo = StubSLO()
    svc = _service(ms, group, slo=slo)
    assert isinstance(_serve(svc, [0])[0], float)
    assert ms.staleness_s() == 0.0                     # the dispatch refreshed the view
    assert svc.stats_snapshot()["staleness_s"] >= stale  # the lag it resolved
    assert slo.staleness == [svc.stats.staleness_s.value]


def test_extra_staleness_feeds_the_gauge_and_a_degrade_only_objective(star_model):
    sch, _, ens = star_model
    clk = FakeClock()
    slo = _mon(SLOMonitor, [SLOObjective("staleness", "staleness", 5.0, degrade_only=True)],
               clk, MetricsRegistry())
    lag = [100.0]
    svc = _service(ens, sch.label_table, slo=slo, extra_staleness=lambda: lag[0])
    assert len(_serve(svc, [0, 1])) == 2
    assert svc.stats.staleness_s.value == 100.0
    assert slo.evaluate()["state"] == "degraded"       # burn 20, capped at degraded
    assert svc.stats.shed == 0
    lag[0] = 0.0
    svc = _service(ens, sch.label_table, slo=slo, extra_staleness=lambda: lag[0])
    _serve(svc, [2])
    assert svc.stats.staleness_s.value == 0.0 and slo.state() == "healthy"


def test_failed_dispatch_counts_errors_and_dumps_the_flight_ring(star_model, tmp_path):
    sch, _, ens = star_model
    tr = Tracer(torch_annotations=False)
    flight = FlightRecorder(capacity=8, out_dir=str(tmp_path), name="err", tracer=tr,
                            cooldown_s=0.0).start()
    slo = StubSLO()
    svc = _service(ens, sch.label_table, flight=flight, slo=slo, retry_transient=False)

    def broken(v, reqs):
        raise RuntimeError("scorer exploded")

    svc._dispatch_version = broken
    with pytest.raises(RuntimeError, match="scorer exploded"):
        _serve(svc, [0, 1, 2])
    assert svc.stats.errors == 3 and svc.stats.batches >= 1
    assert slo.outcomes == [True, True, True]
    dumps = [d for d in flight.status()["dumps"] if d["path"]]
    assert dumps and "RuntimeError: scorer exploded" in dumps[0]["reason"]
    with open(dumps[0]["path"]) as f:
        events = json.load(f)["traceEvents"]
    assert events[-1]["args"]["batch_size"] == len(slo.outcomes)


def test_latencies_and_outcomes_reach_the_monitor_and_the_recorder(star_model, tmp_path):
    sch, _, ens = star_model
    slo = StubSLO()
    tr = Tracer(torch_annotations=False)
    flight = FlightRecorder(capacity=8, out_dir=str(tmp_path), tracer=tr,
                            latency_trigger_ms=0.0, cooldown_s=1e9).start()
    svc = _service(ens, sch.label_table, slo=slo, flight=flight)
    got = _serve(svc, [0, 1, 0])
    assert len(got) == 3 and got[0] == got[2]
    assert len(slo.latencies) == 3 and slo.outcomes == [False] * 3
    assert len(flight.dumps) == 1 and flight.suppressed == 2   # one dump, then cooldown
    assert svc.stats.latency_ms.count == 3
    np.testing.assert_array_equal(np.asarray(slo.latencies) >= 0.0, True)
