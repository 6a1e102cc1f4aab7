"""Async micro-batching front end for the compiled relational scorer.

Request path: ``await service.score(row_id)`` enqueues a future; the
batcher task drains the queue, coalescing up to ``max_batch`` requests
or until ``max_wait_ms`` elapses since the batch opened, runs ONE
``score_rows`` gather per model version, and resolves the futures.  An
LRU cache keyed by (version, install epoch, data_version, row_id)
short-circuits repeat traffic before it reaches the queue.

Model lifecycle: a :class:`ModelRegistry` holds versioned
:class:`CompiledEnsemble`s; ``publish`` installs a freshly boosted model
as latest and ``swap`` replaces the model at an existing slot (bumping
the slot's install epoch, so no cached score of the old occupant is
served).  In-flight requests keep the version they were enqueued with;
new requests pick up the change (zero-downtime hot swap).

Snapshot isolation: a model that publishes MVCC snapshots (a
``MaintainedScorer``) is served from one pinned at batch cutoff
(:meth:`RelationalScoringService._frozen_view`), so a batch scores
against one ``data_version`` while ``apply()`` runs concurrently.

Backpressure, outermost first: burn-rate load shedding (an attached
SLO monitor in state ``unhealthy`` ⇒ :class:`ServiceOverloadedError`),
queue-depth admission control (shed past ``max_queue`` while the SLO
burns, or past the 4× hard cap), and a deadline-aware batch cutoff (the
coalescing window closes early when the oldest queued request would
otherwise spend more than ``deadline_frac`` of its latency budget
waiting; a degraded SLO collapses the window).  A version dispatch that
throws is retried once after a jittered, budget-capped backoff before
its requests fail (and an attached flight recorder dumps).

Live telemetry: an attached :class:`~repro_torch.obs.slo.SLOMonitor`
receives every request's latency and outcome plus the served model's
data staleness (``staleness_s(group_by)`` of a maintained model, max'ed
with ``extra_staleness()``, e.g. a replica's replication lag), mirrored
into the ``service.staleness_s`` gauge; an attached
:class:`~repro_torch.obs.flight.FlightRecorder` is fed the same
latencies and every failed dispatch.
"""
from __future__ import annotations

import asyncio
import itertools
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs import MetricsRegistry, get_registry, span
from ..runtime.fault import Backoff
from .compile import CompiledEnsemble
from .scorer import score_mean_rows


class ServiceOverloadedError(RuntimeError):
    """Raised when admission control sheds a request (SLO unhealthy or
    the queue too deep)."""


class LRUCache:
    """Bounded key → score cache with hit/miss stats, mirrored into
    ``registry``'s ``service.lru.*`` series (the owning service passes its
    own registry, so co-hosted services keep their series apart)."""

    def __init__(self, capacity: int, registry: Optional[MetricsRegistry] = None):
        self.capacity = capacity
        self._d: "OrderedDict" = OrderedDict()
        self.hits = 0
        self.misses = 0
        reg = registry if registry is not None else get_registry()
        self._g_hits = reg.counter("service.lru.hits")
        self._g_misses = reg.counter("service.lru.misses")

    def get(self, key):
        if self.capacity <= 0 or key not in self._d:
            self.misses += 1
            self._g_misses.inc()
            return None
        self._d.move_to_end(key)
        self.hits += 1
        self._g_hits.inc()
        return self._d[key]

    def put(self, key, value):
        if self.capacity <= 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __len__(self):
        return len(self._d)


class ModelRegistry:
    """Versioned store of compiled ensembles (monotonic version ids).

    ``max_versions`` bounds resident models: publishing beyond it evicts
    the oldest versions.  Requests pinned to an evicted version fail with
    KeyError."""

    def __init__(self, max_versions: int = 8):
        self.max_versions = max_versions
        self._models: Dict[int, CompiledEnsemble] = {}
        self._latest: Optional[int] = None
        self._ids = itertools.count(1)
        self._stacked_cache = None
        # per-slot install epoch, monotonic across the registry: bumps
        # whenever a slot's MODEL changes, so caches keyed on it cannot
        # serve model A's scores for model B after a hot swap
        self._gen = 0
        self._epochs: Dict[int, int] = {}

    def publish(self, ensemble: CompiledEnsemble) -> int:
        """Install a new model version and make it the serving default."""
        v = next(self._ids)
        self._models[v] = ensemble
        self._gen += 1
        self._epochs[v] = self._gen
        self._latest = v
        while len(self._models) > self.max_versions:
            old = min(self._models)
            self._models.pop(old)
            self._epochs.pop(old, None)
        return v

    def swap(self, version: int, ensemble: CompiledEnsemble) -> int:
        """Hot-swap the model AT an existing version slot; the slot's
        epoch bumps, invalidating every cache keyed through :meth:`epoch`."""
        if version not in self._models:
            raise KeyError(f"version {version} not resident")
        self._models[version] = ensemble
        self._gen += 1
        self._epochs[version] = self._gen
        return version

    def epoch(self, version: int) -> int:
        """Install epoch of the model currently at ``version``."""
        return self._epochs[version]

    def latest_version(self) -> int:
        if self._latest is None:
            raise LookupError("registry is empty — publish a model first")
        return self._latest

    def get(self, version: Optional[int] = None) -> Tuple[int, CompiledEnsemble]:
        v = self.latest_version() if version is None else version
        return v, self._models[v]

    def versions(self) -> List[int]:
        return sorted(self._models)

    def stacked(self, versions: Optional[List[int]] = None):
        """All (or the given) resident variants fused into one factor set
        for single-pass A/B scoring (``serving/multi.py``).  Cached until
        the participating versions, their install epochs or their
        data_versions change — the epoch term keeps two distinct models
        that both report data_version 0 apart across a swap."""
        from .multi import stack_ensembles

        vs = tuple(self.versions() if versions is None else versions)
        key = (vs, tuple(self._epochs[v] for v in vs),
               tuple(getattr(self._models[v], "data_version", 0) for v in vs))
        if self._stacked_cache is None or self._stacked_cache[0] != key:
            self._stacked_cache = (key, stack_ensembles([self._models[v] for v in vs]))
        return self._stacked_cache[1]


class ServiceStats:
    """Service accounting as named metric series (thread-safe): request,
    batch and cache counts plus queue-wait, end-to-end latency, batch
    execute time and batch-size histograms.  Each service owns its
    registry so co-hosted services never mix their series."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._requests = r.counter("service.requests")
        self._batches = r.counter("service.batches")
        self._batched_rows = r.counter("service.batched_rows")
        self._cache_hits = r.counter("service.cache_hits")
        self._rejected = r.counter("service.rejected")   # bad row ids
        self._errors = r.counter("service.errors")       # dispatch failures
        self._retries = r.counter("service.retries")     # transient redispatch
        self._shed = r.counter("service.shed")           # admission control
        self.staleness_s = r.gauge("service.staleness_s")
        self.queue_wait_ms = r.histogram("service.queue_wait_ms")
        self.latency_ms = r.histogram("service.latency_ms")
        self.batch_exec_ms = r.histogram("service.batch_exec_ms")
        self.batch_size = r.histogram("service.batch_size")

    requests = property(lambda self: self._requests.value)
    batches = property(lambda self: self._batches.value)
    batched_rows = property(lambda self: self._batched_rows.value)
    cache_hits = property(lambda self: self._cache_hits.value)
    rejected = property(lambda self: self._rejected.value)
    errors = property(lambda self: self._errors.value)
    retries = property(lambda self: self._retries.value)
    shed = property(lambda self: self._shed.value)

    @property
    def mean_batch(self) -> float:
        return self.batched_rows / max(self.batches, 1)

    def snapshot(self) -> dict:
        """Counts plus p50/p90/p99 summaries of the timing histograms."""
        def q(h):
            s = h.summary()
            return {k: s[k] for k in ("count", "mean", "p50", "p90", "p99", "max")}
        return {
            "requests": self.requests,
            "batches": self.batches,
            "cache_hits": self.cache_hits,
            "cache_hit_rate": self.cache_hits / max(self.requests, 1),
            "rejected": self.rejected,
            "errors": self.errors,
            "retries": self.retries,
            "shed": self.shed,
            "staleness_s": self.staleness_s.value,
            "mean_batch": self.mean_batch,
            "queue_wait_ms": q(self.queue_wait_ms),
            "latency_ms": q(self.latency_ms),
            "batch_exec_ms": q(self.batch_exec_ms),
            "batch_size": q(self.batch_size),
        }


class _Request:
    __slots__ = ("row_id", "version", "future", "t_enq")

    def __init__(self, row_id: int, version: int, future: "asyncio.Future", t_enq: float):
        self.row_id = row_id
        self.version = version
        self.future = future
        self.t_enq = t_enq


class RelationalScoringService:
    """Queue → coalesce → batched scorer → dispatch futures.

    ``slo`` (an ``SLOMonitor``) and ``flight`` (a ``FlightRecorder``) are
    optional; ``extra_staleness`` is a () → seconds callable folded (max)
    into the staleness the SLO monitor burns against."""

    def __init__(self, registry: ModelRegistry, group_by: str, max_batch: int = 64,
                 max_wait_ms: float = 2.0, cache_size: int = 4096,
                 slo=None, flight=None, shed_when_unhealthy: bool = True,
                 latency_budget_ms: Optional[float] = None, deadline_frac: float = 0.5,
                 max_queue: Optional[int] = None, retry_transient: bool = True,
                 extra_staleness=None):
        self.registry = registry
        self.group_by = group_by
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.stats = ServiceStats()
        self.cache = LRUCache(cache_size, registry=self.stats.registry)
        self.slo = slo
        self.flight = flight
        self.shed_when_unhealthy = shed_when_unhealthy
        # per-request latency budget (seconds) for the deadline-aware batch
        # cutoff: explicit, else the tightest latency objective of the SLO
        # monitor, else none; only deadline_frac of it may be spent waiting
        # in the coalescing window, the rest is left for execution
        if latency_budget_ms is not None:
            self.latency_budget = latency_budget_ms / 1e3
        else:
            budgets = [o.target / 1e3 for o in getattr(slo, "objectives", {}).values()
                       if o.kind == "latency"]
            self.latency_budget = min(budgets) if budgets else None
        self.deadline_frac = deadline_frac
        # queue-depth admission control: past max_queue while the SLO burns
        # (state != healthy), or past the 4× hard cap regardless, new
        # requests are shed instead of compounding everyone's wait
        self.max_queue = max_queue
        # one re-attempt of a failing version dispatch after a jittered
        # backoff; the budget bounds total sleep across repeated failures
        self.retry_transient = retry_transient
        self._retry_backoff = Backoff(base_s=0.005, cap_s=0.05, budget_s=1.0)
        # replica wiring: a WAL follower's replication lag, so a lagging or
        # dead writer burns the staleness objective even while the local
        # scorer is caught up with everything the log delivered
        self.extra_staleness = extra_staleness
        self._q: "asyncio.Queue" = asyncio.Queue()
        self._task: Optional["asyncio.Task"] = None

    def stats_snapshot(self) -> dict:
        return self.stats.snapshot()

    # -------------------------------------------------------------- control --
    async def start(self):
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self):
        if self._task is not None:
            await self._q.put(None)
            await self._task
            self._task = None
        # fail any request that raced in behind the stop sentinel
        while not self._q.empty():
            item = self._q.get_nowait()
            if item is not None and not item.future.done():
                item.future.set_exception(RuntimeError("service stopped"))

    # -------------------------------------------------------------- serving --
    def _observe_latency(self, ms: float, error: bool = False) -> None:
        self.stats.latency_ms.observe(ms)
        if self.slo is not None:
            self.slo.record_latency(ms)
            self.slo.record_request(error=error)
        if self.flight is not None:
            self.flight.observe_latency(ms)

    async def score(self, row_id: int, version: Optional[int] = None) -> float:
        """Mean prediction Σŷ/count for one row of ``group_by``."""
        if self._task is None or self._task.done():
            raise RuntimeError("service not running — call start() first")
        t0 = time.perf_counter()
        v, ens = self.registry.get(version)
        # validate per request: a bad id inside a coalesced batch must not
        # fail its co-batched neighbours
        n = ens.n_rows(self.group_by)
        if not 0 <= row_id < n:
            self.stats._rejected.inc()
            raise IndexError(
                f"row id {row_id} out of range for table {self.group_by!r} (n_rows={n})")
        # burn-rate shedding: unhealthy means both windows are past the SLO
        if (self.slo is not None and self.shed_when_unhealthy
                and self.slo.state() == "unhealthy"):
            self.stats._shed.inc()
            raise ServiceOverloadedError(
                "load shed: SLO state unhealthy (burn rates over budget; see /healthz)")
        # queue-depth backpressure: a deep queue while the SLO burns means
        # arrivals outpace dispatch; the 4× hard cap bounds memory and wait
        # even without an SLO verdict
        if self.max_queue is not None:
            depth = self._q.qsize()
            burning = self.slo is not None and self.slo.state() != "healthy"
            if depth >= 4 * self.max_queue or (burning and depth >= self.max_queue):
                self.stats._shed.inc()
                raise ServiceOverloadedError(
                    f"load shed: queue depth {depth} over "
                    f"{'hard cap' if depth >= 4 * self.max_queue else 'limit'} "
                    f"(max_queue={self.max_queue})")
        self.stats._requests.inc()
        cached = self.cache.get(
            (v, self.registry.epoch(v), getattr(ens, "data_version", 0), row_id))
        if cached is not None:
            self.stats._cache_hits.inc()
            self._observe_latency((time.perf_counter() - t0) * 1e3)
            return cached
        fut = asyncio.get_running_loop().create_future()
        await self._q.put(_Request(int(row_id), v, fut, t0))
        try:
            result = await fut
        except Exception:
            self._observe_latency((time.perf_counter() - t0) * 1e3, error=True)
            raise
        self._observe_latency((time.perf_counter() - t0) * 1e3)
        return result

    async def score_many(self, row_ids, version: Optional[int] = None) -> List[float]:
        """Score a batch; all requests run to completion (survivors resolve
        and land in the cache) and only then is the first failure raised."""
        results = await asyncio.gather(*(self.score(r, version) for r in row_ids),
                                       return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return list(results)

    # -------------------------------------------------------------- batcher --
    async def _collect(self) -> Optional[List[_Request]]:
        """One coalescing window: the first request opens the batch, then
        fill until max_batch, the max_wait deadline, or the instant the
        OLDEST request would otherwise spend more than ``deadline_frac`` of
        its latency budget waiting.  A degraded SLO collapses the window
        (drain greedily).  Every clock is ``time.perf_counter``."""
        first = await self._q.get()
        if first is None:
            return None
        batch = [first]
        wait = self.max_wait
        if self.slo is not None and self.slo.state() != "healthy":
            wait = 0.0
        deadline = time.perf_counter() + wait
        if self.latency_budget is not None:
            deadline = min(deadline, first.t_enq + self.latency_budget * self.deadline_frac)
        while len(batch) < self.max_batch:
            try:                             # greedy drain: no await overhead
                item = self._q.get_nowait()
            except asyncio.QueueEmpty:
                timeout = max(0.0, deadline - time.perf_counter())
                if timeout == 0.0:
                    break
                try:
                    item = await asyncio.wait_for(self._q.get(), timeout)
                except asyncio.TimeoutError:
                    break
            if item is None:
                await self._q.put(None)     # re-post the stop sentinel
                break
            batch.append(item)
        return batch

    def _dispatch(self, batch: List[_Request]):
        st = self.stats
        t_pick = time.perf_counter()
        for r in batch:
            st.queue_wait_ms.observe((t_pick - r.t_enq) * 1e3)
        by_version: Dict[int, List[_Request]] = {}
        for r in batch:
            by_version.setdefault(r.version, []).append(r)
        with span("service.batch", size=len(batch), versions=len(by_version)):
            for v, reqs in by_version.items():
                # per-version isolation: one version's failure resolves only
                # ITS requests exceptionally
                try:
                    self._dispatch_version(v, reqs)
                    self._retry_backoff.reset()
                    continue
                except Exception as e:       # noqa: BLE001 — retried, then reported
                    err = e
                if self.retry_transient:
                    try:
                        delay = self._retry_backoff.next_delay()
                    except RuntimeError:     # retry budget exhausted
                        delay = None
                    if delay is not None:
                        time.sleep(delay)
                        st._retries.inc()
                        try:
                            self._dispatch_version(v, reqs)
                            self._retry_backoff.reset()
                            continue
                        except Exception as e:   # noqa: BLE001
                            err = e
                st._errors.inc(len(reqs))
                if self.flight is not None:
                    self.flight.observe_error(err, batch_size=len(reqs))
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(err)
        st._batches.inc()
        st._batched_rows.inc(len(batch))
        st.batch_size.observe(len(batch))

    def _frozen_view(self, ens):
        """Pin the serving view AT batch cutoff.  A maintained model
        publishes an MVCC snapshot — frozen factors/messages/join trees
        at one data_version — so a concurrent ``apply()`` can neither
        tear the gather nor slide the version between read and cache
        write.  Static ensembles are immutable already: served as-is."""
        snap = getattr(ens, "snapshot", None)
        if callable(snap):
            view = snap(roots=(self.group_by,))
            return view, view.data_version
        return ens, getattr(ens, "data_version", 0)

    def _observe_staleness(self, ens) -> None:
        """Served-data staleness of our root, sampled from the live model
        (a snapshot is frozen and has no lag of its own), max'ed with
        ``extra_staleness()``; into the gauge and the SLO monitor."""
        stale = getattr(ens, "staleness_s", None)
        s = None
        if callable(stale):
            try:
                s = stale(self.group_by)
            except TypeError:            # a provider without per-root lag
                s = stale()
        if self.extra_staleness is not None:
            s = max(s or 0.0, float(self.extra_staleness()))
        if s is not None:
            self.stats.staleness_s.set(s)
            if self.slo is not None:
                self.slo.set_staleness(s)

    def _dispatch_version(self, v: int, reqs: List[_Request]):
        _, ens = self.registry.get(v)
        ep = self.registry.epoch(v)
        self._observe_staleness(ens)
        # the version pin happens HERE, at batch cutoff: a delta applied
        # mid-dispatch mutates the live model, but this batch gathers
        # from the frozen view and caches under its pinned data_version
        view, dv = self._frozen_view(ens)
        ids = np.asarray([r.row_id for r in reqs], np.int64)
        t_exec = time.perf_counter()
        mean = score_mean_rows(view, self.group_by, ids).cpu().numpy()
        self.stats.batch_exec_ms.observe((time.perf_counter() - t_exec) * 1e3)
        for r, m in zip(reqs, mean):
            val = float(m)
            self.cache.put((v, ep, dv, r.row_id), val)
            if not r.future.done():
                r.future.set_result(val)

    async def _run(self):
        while True:
            batch = await self._collect()
            if batch is None:
                return
            try:
                self._dispatch(batch)
            except Exception as e:      # noqa: BLE001 — propagate to callers, keep serving
                self.stats._errors.inc(len(batch))
                if self.flight is not None:
                    self.flight.observe_error(e, batch_size=len(batch))
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
