"""Declarative SLOs evaluated with multi-window burn rates.

An :class:`SLOObjective` states what "good" means for one dimension of
the serve/ingest loop:

- ``latency``    — a fraction ``objective`` of requests must finish
  within ``target`` milliseconds (e.g. p99 ≤ 50ms ⇒ target=50,
  objective=0.99);
- ``error_rate`` — the failure fraction must stay below ``target``;
- ``staleness``  — the wall-clock lag of the served ``data_version``
  behind applied deltas must stay below ``target`` seconds.

The :class:`SLOMonitor` turns the event stream (per-request latencies,
error/ok outcomes, a staleness gauge) into *burn rates*: how fast the
error budget is being consumed relative to the allowed rate (burn 1.0 =
exactly on budget).  Following the SRE multi-window rule, each
objective is judged over a FAST and a SLOW window — the fast window
reacts to an incident in seconds, the slow window keeps a transient
blip from flapping the state — and both must burn hot before the
objective degrades.  Event windows are bucketed rings, so memory is
O(buckets) regardless of traffic.

The aggregate state (worst objective) is one of ``healthy`` /
``degraded`` / ``unhealthy``: ``/healthz`` reports it (503 on
unhealthy) and the service batcher consumes it as an overload signal —
degraded shortens the coalescing window, unhealthy sheds new
admissions (``serving/service.py``'s admission control).

``parse_slo_spec`` accepts the CLI grammar::

    latency=50ms@0.99,errors=0.01,staleness=5s
"""
from __future__ import annotations

import dataclasses
import math
import re
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from .metrics import MetricsRegistry, get_registry

__all__ = ["SLOObjective", "SLOMonitor", "parse_slo_spec",
           "HEALTHY", "DEGRADED", "UNHEALTHY"]

HEALTHY, DEGRADED, UNHEALTHY = "healthy", "degraded", "unhealthy"
_STATE_RANK = {HEALTHY: 0, DEGRADED: 1, UNHEALTHY: 2}
KINDS = ("latency", "error_rate", "staleness")


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One service-level objective (see module docstring for kinds)."""

    name: str
    kind: str                    # "latency" | "error_rate" | "staleness"
    target: float                # ms (latency) / fraction / seconds
    objective: float = 0.99     # good-fraction required (latency kind only)
    # graceful-degradation cap: this objective can pull the aggregate
    # state to DEGRADED but never UNHEALTHY.  Used by follower replicas:
    # a dead writer makes served data arbitrarily stale, and the right
    # behavior is "serve stale, report degraded" — not shedding the only
    # traffic the replica exists to absorb.
    degrade_only: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r} (want {KINDS})")
        if self.target <= 0:
            raise ValueError(f"SLO target must be positive, got {self.target}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective fraction must be in (0, 1), got {self.objective}")

    @property
    def budget(self) -> float:
        """Allowed bad-event fraction (the error budget rate)."""
        if self.kind == "latency":
            return 1.0 - self.objective
        if self.kind == "error_rate":
            return self.target
        return 1.0                       # staleness burns target-relative


class _Window:
    """Rolling (good, bad) counts over a horizon, in coarse buckets."""

    def __init__(self, horizon_s: float, n_buckets: int = 20):
        self.horizon_s = horizon_s
        self.width = horizon_s / n_buckets
        self.n_buckets = n_buckets
        self._d: deque = deque()         # (bucket_idx, [good, bad])

    def add(self, good: int, bad: int, now: float) -> None:
        idx = int(now / self.width)
        if self._d and self._d[-1][0] == idx:
            cell = self._d[-1][1]
            cell[0] += good
            cell[1] += bad
        else:
            self._d.append((idx, [good, bad]))
        self._evict(idx)

    def _evict(self, idx: int) -> None:
        floor = idx - self.n_buckets
        while self._d and self._d[0][0] <= floor:
            self._d.popleft()

    def totals(self, now: float):
        self._evict(int(now / self.width))
        good = sum(c[0] for _, c in self._d)
        bad = sum(c[1] for _, c in self._d)
        return good, bad


class SLOMonitor:
    """Multi-window burn-rate evaluation over a set of objectives.

    ``degraded_burn`` / ``unhealthy_burn`` are the burn-rate thresholds
    BOTH windows must exceed; ``clock`` is injectable so tests can march
    time deterministically.  Lifetime good/total tallies are kept per
    objective for SLO-compliance reporting (``compliance()``), and every
    ``evaluate()`` mirrors the burn rates into the registry as
    ``slo.<name>.burn_fast`` / ``.burn_slow`` gauges plus a numeric
    ``slo.state`` (0 healthy / 1 degraded / 2 unhealthy)."""

    def __init__(
        self,
        objectives: Sequence[SLOObjective],
        fast_window_s: float = 60.0,
        slow_window_s: float = 600.0,
        degraded_burn: float = 1.0,
        unhealthy_burn: float = 6.0,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[MetricsRegistry] = None,
        state_ttl_s: float = 0.05,
    ):
        if fast_window_s >= slow_window_s:
            raise ValueError("fast window must be shorter than the slow one")
        self.objectives = {o.name: o for o in objectives}
        if len(self.objectives) != len(objectives):
            raise ValueError("duplicate objective names")
        self.degraded_burn = degraded_burn
        self.unhealthy_burn = unhealthy_burn
        self.clock = clock
        self.registry = registry if registry is not None else get_registry()
        self._win: Dict[str, Dict[str, _Window]] = {
            o.name: {"fast": _Window(fast_window_s),
                     "slow": _Window(slow_window_s)}
            for o in objectives
        }
        self._life: Dict[str, List[int]] = {o.name: [0, 0]  # [good, bad]
                                            for o in objectives}
        self._staleness_s = 0.0
        self._state_ttl = state_ttl_s
        self._state_cache = (None, -math.inf)   # (state, eval time)

    # ------------------------------------------------------------ recording --
    def _add(self, name: str, good: bool) -> None:
        now = self.clock()
        g, b = (1, 0) if good else (0, 1)
        for w in self._win[name].values():
            w.add(g, b, now)
        life = self._life[name]
        life[0] += g
        life[1] += b

    def record_latency(self, ms: float) -> None:
        """One finished request's end-to-end latency (latency objectives
        judge it against their threshold)."""
        for o in self.objectives.values():
            if o.kind == "latency":
                self._add(o.name, ms <= o.target)

    def record_request(self, error: bool = False) -> None:
        """One request outcome for the error-rate objectives."""
        for o in self.objectives.values():
            if o.kind == "error_rate":
                self._add(o.name, not error)

    def set_staleness(self, seconds: float) -> None:
        """Current served-data staleness (wall-clock lag behind applied
        deltas); gauge semantics — the latest value is what burns."""
        self._staleness_s = max(0.0, float(seconds))

    # ----------------------------------------------------------- evaluation --
    def _burn(self, o: SLOObjective, win: _Window, now: float) -> float:
        if o.kind == "staleness":
            return self._staleness_s / o.target
        good, bad = win.totals(now)
        total = good + bad
        if total == 0:
            return 0.0                   # no traffic consumes no budget
        return (bad / total) / max(o.budget, 1e-9)

    def evaluate(self) -> dict:
        """Full report: per-objective burn rates + aggregate state."""
        now = self.clock()
        reg = self.registry
        out: Dict[str, dict] = {}
        worst = HEALTHY
        for name, o in self.objectives.items():
            fast = self._burn(o, self._win[name]["fast"], now)
            slow = self._burn(o, self._win[name]["slow"], now)
            floor = min(fast, slow)      # both windows must burn hot
            state = (UNHEALTHY if floor >= self.unhealthy_burn else
                     DEGRADED if floor >= self.degraded_burn else HEALTHY)
            if o.degrade_only and state == UNHEALTHY:
                state = DEGRADED         # serve stale, never shed

            if _STATE_RANK[state] > _STATE_RANK[worst]:
                worst = state
            good, bad = self._life[name]
            out[name] = {
                "kind": o.kind, "target": o.target, "objective": o.objective,
                "burn_fast": round(fast, 4), "burn_slow": round(slow, 4),
                "state": state,
                "good": good, "bad": bad,
                "compliance": good / (good + bad) if good + bad else None,
            }
            reg.gauge(f"slo.{name}.burn_fast").set(fast)
            reg.gauge(f"slo.{name}.burn_slow").set(slow)
        reg.gauge("slo.state").set(_STATE_RANK[worst])
        self._state_cache = (worst, now)
        return {"state": worst, "staleness_s": round(self._staleness_s, 6),
                "objectives": out}

    def state(self) -> str:
        """Aggregate state, memoized for ``state_ttl_s`` so per-request
        admission checks don't re-walk the windows."""
        cached, t = self._state_cache
        if cached is not None and self.clock() - t < self._state_ttl:
            return cached
        return self.evaluate()["state"]

    def compliance(self, name: str) -> Optional[float]:
        """Lifetime good fraction for one objective (None = no events)."""
        good, bad = self._life[name]
        return good / (good + bad) if good + bad else None


# ----------------------------------------------------------------- parsing --
_UNIT = {"ms": 1.0, "s": 1000.0, "us": 1e-3, "": None}
_TERM = re.compile(
    r"^(?P<kind>latency|errors|error_rate|staleness)"
    r"=(?P<value>[0-9.]+)(?P<unit>ms|us|s)?(?:@(?P<frac>0?\.[0-9]+))?$")


def parse_slo_spec(spec: str) -> List[SLOObjective]:
    """CLI grammar → objectives: comma-separated ``kind=value[@frac]``.

    ``latency=50ms@0.99`` — 99% of requests within 50ms (unit defaults
    to ms); ``errors=0.01`` — error rate below 1%; ``staleness=5s`` —
    served data at most 5s behind applied deltas (unit defaults to s).
    """
    out: List[SLOObjective] = []
    for term in filter(None, (t.strip() for t in spec.split(","))):
        m = _TERM.match(term)
        if m is None:
            raise ValueError(
                f"bad SLO term {term!r} — want kind=value[@frac] with kind "
                f"in latency/errors/staleness, e.g. 'latency=50ms@0.99'")
        kind, value, unit = m["kind"], float(m["value"]), m["unit"] or ""
        frac = float(m["frac"]) if m["frac"] else 0.99
        if kind == "latency":
            ms = value * (_UNIT[unit] or 1.0)
            out.append(SLOObjective("latency", "latency", ms, objective=frac))
        elif kind in ("errors", "error_rate"):
            if unit:
                raise ValueError(f"error rate takes a bare fraction: {term!r}")
            out.append(SLOObjective("errors", "error_rate", value))
        else:
            s = value * ((_UNIT[unit] or 1000.0) / 1000.0)
            out.append(SLOObjective("staleness", "staleness", s))
    if not out:
        raise ValueError(f"empty SLO spec {spec!r}")
    return out
