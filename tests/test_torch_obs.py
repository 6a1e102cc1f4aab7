"""The port's own observability copies against the JAX package's:
histogram quantiles, counters and registries agree, and so do snapshot
diffs and merges, histogram merges and the summary table (exactly); spans
are free when tracing is off and recorded when on; ``fence`` passes its
value through; the tracer's ring mode, rollup, and its JSONL and
Chrome-trace exports round-trip."""
import json
import threading

import numpy as np
import pytest

from repro.obs import metrics as rmetrics
from repro.obs.trace import Tracer as RTracer

from repro_torch.obs import (Counter, Histogram, MetricsRegistry, Tracer, diff_snapshots,
                             disable_tracing, enable_tracing, fence, format_summary_table,
                             get_registry, get_tracer, merge_snapshots, reset_registry, span,
                             tracing_enabled)
from repro_torch.runtime.fault import Backoff


def test_histogram_quantiles_match_reference():
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.lognormal(0.0, 1.5, 2000), [0.0, -1.0]])
    h, r = Histogram("x"), rmetrics.Histogram("x")
    for x in xs:
        h.observe(x)
        r.observe(x)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == r.quantile(q)
    s, rs = h.summary(), r.summary()
    for k in ("count", "min", "max", "p50", "p90", "p99"):
        assert s[k] == rs[k], k
    assert s["sum"] == pytest.approx(rs["sum"])


def test_counter_and_registry():
    c = Counter("n")
    c.inc()
    c.inc(4)
    assert c.value == 5 and c.snapshot() == {"type": "counter", "value": 5}
    reg = MetricsRegistry()
    assert reg.counter("a") is reg.counter("a")
    reg.histogram("h").observe(3.0)
    with pytest.raises(TypeError):
        reg.histogram("a")
    snap = reg.snapshot()
    assert snap["a"]["value"] == 0 and snap["h"]["count"] == 1


def test_spans_and_fence():
    disable_tracing()
    with span("off") as s:
        assert s is not None
    assert not [e for e in get_tracer().events if e["name"] == "off"]
    tr = enable_tracing()
    try:
        with span("outer", k=1):
            with span("inner"):
                pass
        evs = {e["name"]: e for e in tr.events}
        assert evs["inner"]["depth"] == 1 and evs["outer"]["depth"] == 0
        assert evs["outer"]["k"] == 1 and evs["outer"]["dur_ms"] >= evs["inner"]["dur_ms"]
        assert fence(7) == 7
    finally:
        disable_tracing()


def test_backoff_budget():
    b = Backoff(base_s=0.01, cap_s=0.02, budget_s=0.05, jitter=0.0, seed=0)
    delays = [b.next_delay(), b.next_delay()]
    assert delays == [0.01, 0.02]
    with pytest.raises(RuntimeError, match="budget"):
        for _ in range(5):
            b.next_delay()
    b.reset()
    assert b.next_delay() == 0.01


def _grow(reg, seed):
    """Counters, a gauge and histograms (one empty) with seeded values."""
    rng = np.random.default_rng(seed)
    reg.counter("reqs").inc(int(rng.integers(1, 100)))
    reg.gauge("lag_s").set(float(rng.random()))
    h = reg.histogram("lat_ms")
    for x in rng.lognormal(0.0, 2.0, 300):
        h.observe(x)
    h.observe(0.0)
    reg.histogram("idle_ms")


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshot_diff_merge_and_table_match_reference(seed):
    ours, ref = MetricsRegistry(), rmetrics.MetricsRegistry()
    _grow(ours, seed)
    _grow(ref, seed)
    a, ra = ours.snapshot(), ref.snapshot()
    assert a == ra
    _grow(ours, seed + 10)
    _grow(ref, seed + 10)
    ours.counter("late").inc(3)
    ref.counter("late").inc(3)
    b, rb = ours.snapshot(), ref.snapshot()
    assert diff_snapshots(a, b) == rmetrics.diff_snapshots(ra, rb)
    assert merge_snapshots(a, b) == rmetrics.merge_snapshots(ra, rb)
    assert diff_snapshots(a, b)["reqs"]["value"] == b["reqs"]["value"] - a["reqs"]["value"]
    assert merge_snapshots(a, b)["lat_ms"]["count"] == a["lat_ms"]["count"] + b["lat_ms"]["count"]
    assert format_summary_table(b, "t") == rmetrics.format_summary_table(rb, "t")
    h, rh = Histogram(), rmetrics.Histogram()
    for x in (0.5, 3.0, 7.0):
        h.observe(x)
        rh.observe(x)
    h.merge(ours.histogram("lat_ms"))
    rh.merge(ref.histogram("lat_ms"))
    assert h.snapshot() == rh.snapshot()


def test_registry_names_clear_and_reset():
    reg = MetricsRegistry()
    reg.gauge("b")
    reg.counter("a")
    assert reg.names() == ["a", "b"]
    reg.clear()
    assert reg.names() == [] and reg.snapshot() == {}
    get_registry().counter("obs.test.reset").inc()
    reset_registry()
    assert "obs.test.reset" not in get_registry().names()


def _record(tr, names):
    for i, n in enumerate(names):
        tr.record({"name": n, "ts_ms": 2.0 * i, "dur_ms": 1.5 + i, "tid": 7,
                   "depth": i % 2, "k": i})


def test_ring_mode_rollup_and_exports_match_reference(tmp_path):
    names = ["a", "b", "a", "c", "a", "b"]
    ours, ref = Tracer(torch_annotations=False), RTracer(jax_annotations=False)
    for tr in (ours, ref):
        tr.set_ring(4)
        _record(tr, names)
    assert ours.ring_capacity == ref.ring_capacity == 4
    assert list(ours.events) == list(ref.events) and len(ours.events) == 4
    assert ours.rollup() == ref.rollup() == {          # the newest 4: a c a b
        "a": {"count": 2, "total_ms": 9.0, "max_ms": 5.5},
        "b": {"count": 1, "total_ms": 6.5, "max_ms": 6.5},
        "c": {"count": 1, "total_ms": 4.5, "max_ms": 4.5}}
    assert ours.to_chrome_trace() == ref.to_chrome_trace()
    ours.set_unbounded()
    assert ours.ring_capacity is None and isinstance(ours.events, list)
    _record(ours, ["d"])
    assert len(ours.events) == 5
    with pytest.raises(ValueError):
        ours.set_ring(0)
    n = ours.dump_jsonl(str(tmp_path / "t.jsonl"))
    back = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert n == 5 and back == list(ours.events)
    n = ours.dump_chrome_trace(str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    assert n == 5 and doc == ours.to_chrome_trace() and doc["displayTimeUnit"] == "ms"
    ev = doc["traceEvents"][-1]
    assert (ev["name"], ev["ph"], ev["ts"], ev["dur"], ev["tid"]) == ("d", "X", 0.0, 1500.0, 7)
    assert ev["args"] == {"depth": 0, "k": 0}


def test_spans_round_trip_through_chrome_trace_with_profiler_names(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tr = enable_tracing()
    try:
        assert tracing_enabled() and tr.torch_annotations
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("outer.span", n=3):
                with span("inner.span"):
                    pass
        path = tmp_path / "spans.json"
        assert tr.dump_chrome_trace(str(path)) == 2
        doc = json.loads(path.read_text())
        evs = {e["name"]: e for e in doc["traceEvents"]}
        assert evs["outer.span"]["args"]["n"] == 3 and evs["inner.span"]["args"]["depth"] == 1
        assert evs["outer.span"]["dur"] >= evs["inner.span"]["dur"] >= 0.0
        names = {e.key for e in prof.key_averages()}
        assert {"outer.span", "inner.span"} <= names
    finally:
        disable_tracing()
    assert not tracing_enabled()


def test_clear_resets_every_threads_stack():
    tr = enable_tracing(torch_annotations=False)
    try:
        span("leaked").__enter__()
        ready, resume = threading.Event(), threading.Event()

        def worker():
            span("w_leaked").__enter__()
            ready.set()
            resume.wait(30.0)
            with span("w_after"):
                pass

        t = threading.Thread(target=worker)
        t.start()
        ready.wait(30.0)
        get_tracer().clear()
        resume.set()
        t.join(30.0)
        with span("after"):
            pass
        depths = {e["name"]: e["depth"] for e in tr.events}
        assert depths == {"w_after": 0, "after": 0}
    finally:
        disable_tracing()
