"""The port's own observability copies against the JAX package's:
histogram quantiles, counters and registries agree; spans are free when
tracing is off and recorded when on; ``fence`` passes its value through."""
import numpy as np
import pytest

from repro.obs import metrics as rmetrics

from repro_torch.obs import (Counter, Histogram, MetricsRegistry, disable_tracing,
                             enable_tracing, fence, get_tracer, span)
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
