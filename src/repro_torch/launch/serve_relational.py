"""Relational serving driver: train → compile → micro-batch serve.

Trains a booster on a synthetic relational workload, compiles the
ensemble into the one-pass scorer, publishes it to a versioned registry,
and drives the async micro-batching service with synthetic interactive
traffic (zipf-skewed row ids — the regime where the LRU cache earns its
keep).  Ends with a hot swap: a refreshed model is published mid-traffic
and new requests pick it up with zero downtime.

    PYTHONPATH=src python -m repro_torch.launch.serve_relational --requests 2000
    PYTHONPATH=src python -m repro_torch.launch.serve_relational --device cpu

Follower mode (``--follow DIR``): the served model is a read-only replica
recovered from a writer's log and checkpoints in DIR (``stream_deltas
--wal-dir DIR``) and kept current by a ``WalFollower`` tailing the log;
its replication lag (or the writer's idle time past
``--heartbeat-grace-s``) is the staleness the SLO burns against, and a
staleness objective is degrade-only there: a dead writer degrades the
replica, it never sheds the traffic the replica exists to absorb.

Telemetry: ``--trace PATH`` writes a Chrome trace (and PATH.jsonl),
``--metrics-port`` serves ``/metricsz /healthz /statusz /tracez``,
``--slo`` attaches burn-rate objectives that feed ``/healthz`` and the
service's admission control, ``--flight N`` keeps the newest N spans and
dumps them (``FLIGHT_serve_*.json`` in the working directory) past
``--flight-latency-ms`` or on a failed dispatch, and ``--sample PATH``
appends metric deltas to a JSONL series.

Data parallel: ``torchrun --nproc-per-node N -m
repro_torch.launch.serve_relational --mesh N`` fits and compiles with the
factors sharded over N ranks (gloo with ``--device cpu``, NCCL with one
card a rank on CUDA).  Collectives run only where every rank runs the
same program: the fit, the compile, and one bulk pass of the served
table for the model and for the hot swap's model, all before traffic.
Rank 0 alone then serves, and its requests read those replicated
results.  ``--follow`` needs one process: a follower applies the log on
its own clock, so the ranks' collectives would fall out of step.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core import BoostConfig, Booster, QueryCounter
from repro_torch.distributed import spmd
from repro_torch.launch._devices import add_device_args, is_lead, resolve_mesh, shutdown
from repro_torch.obs import (
    FlightRecorder, PeriodicSampler, SLOMonitor, TelemetryServer, disable_tracing, enable_tracing,
    format_summary_table, get_registry, get_tracer, merge_snapshots, parse_slo_spec,
)
from repro_torch.relational import generators
from repro_torch.serving import (
    ModelRegistry, RelationalScoringService, ServiceOverloadedError, compile_ensemble,
)


def build_schema(args):
    if args.schema == "star":
        return generators.star_schema(seed=args.seed, n_fact=args.n_fact, n_dim=args.n_dim,
                                      device=args.device)
    if args.schema == "chain":
        return generators.chain_schema(seed=args.seed, n_rows=args.n_fact, device=args.device)
    if args.schema == "snowflake":
        return generators.snowflake_schema(seed=args.seed, n_fact=args.n_fact,
                                           n_dim=args.n_dim, device=args.device)
    raise ValueError(args.schema)


def train(schema, args, seed=0):
    cfg = BoostConfig(n_trees=args.trees, depth=args.depth, mode="sketch",
                      ssr_mode="off", seed=seed)
    trees, _ = Booster(schema, cfg).fit()
    return trees


def open_follower(ens, wal_dir: str, poll_ms: float, counter=None):
    """A replica of ``ens``'s model recovered from ``wal_dir`` (and its
    ``ckpt/`` checkpoints), tailed live by a started ``WalFollower``.
    Returns (replica, follower, recovery report)."""
    from repro_torch.incremental.recover import recover_scorer
    from repro_torch.incremental.wal import WalFollower

    ckpt_dir = os.path.join(wal_dir, "ckpt")
    replica, rep = recover_scorer(ens, wal_dir, ckpt_dir if os.path.isdir(ckpt_dir) else None,
                                  counter=counter)
    follower = WalFollower(wal_dir, replica.apply, start_lsn=rep.recovered_lsn,
                           poll_interval_s=poll_ms / 1e3).start()
    return replica, follower, rep


def follower_staleness(follower, grace_s: float) -> Callable[[], float]:
    """Served data lags by the undrained log tail; once drained, a writer
    silent past its heartbeat cadence is presumed dead and its idle age
    becomes the staleness."""
    def extra_staleness() -> float:
        return max(follower.replication_lag_s(),
                   max(0.0, follower.writer_idle_s() - grace_s))
    return extra_staleness


def make_slo(spec: str, follower: bool = False) -> SLOMonitor:
    """Objectives of ``spec`` over 5 s / 30 s windows; a follower's
    staleness objective is degrade-only."""
    objectives = parse_slo_spec(spec)
    if follower:
        objectives = [dataclasses.replace(o, degrade_only=True) if o.kind == "staleness"
                      else o for o in objectives]
    return SLOMonitor(objectives, fast_window_s=5.0, slow_window_s=30.0)


@dataclasses.dataclass
class Wiring:
    """The service and the telemetry attached to it by the CLI's flags."""

    service: RelationalScoringService
    slo: Optional[SLOMonitor] = None
    flight: Optional[FlightRecorder] = None
    telemetry: Optional[TelemetryServer] = None
    sampler: Optional[PeriodicSampler] = None


def wire(args, registry: ModelRegistry, group: str, extra_staleness=None,
         follower: bool = False) -> Wiring:
    """Build the service with ``args``' telemetry: tracing, SLO monitor,
    flight recorder, telemetry server (started by :func:`drive`) and
    sampler (started here)."""
    if args.trace:
        enable_tracing()
    slo = make_slo(args.slo, follower) if args.slo else None
    flight = None
    if args.flight:
        flight = FlightRecorder(capacity=args.flight, name="serve",
                                latency_trigger_ms=args.flight_latency_ms,
                                cooldown_s=5.0).start()
    service = RelationalScoringService(
        registry, group, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        cache_size=args.cache_size, slo=slo, flight=flight,
        extra_staleness=extra_staleness)
    regs = [get_registry(), service.stats.registry]
    telemetry = None
    if args.metrics_port is not None:
        telemetry = TelemetryServer(
            registries=regs, slo=slo, flight=flight, port=args.metrics_port,
            status_fn=lambda: {"model_version": registry.latest_version(),
                               "stats": service.stats_snapshot()})
    sampler = None
    if args.sample:
        sampler = PeriodicSampler(
            args.sample, interval_s=args.sample_interval, registries=regs,
            extra_fn=lambda: {"slo_state": slo.state() if slo else None}).start()
    return Wiring(service, slo, flight, telemetry, sampler)


async def drive(service, n_rows, n_requests, concurrency, zipf_a, registry,
                schema, args, counter, telemetry=None, hot_swap=True, probe=None,
                swap_model=None):
    """Warm up outside the SLO clock, serve ``n_requests`` zipf-skewed
    requests in chunks of ``concurrency`` (an overloaded chunk is shed
    and counted), then hot-swap a refreshed model (``swap_model``, else
    one trained and compiled here).  ``probe(stage)``, a
    blocking callable (a scrape of the telemetry server), runs on a worker
    thread while the loop keeps serving HTTP: ``"mid"`` half-way through
    the traffic (the requests wait for it; its time is left out of the
    QPS), ``"end"`` after the last request, before the telemetry server
    stops.  Returns a dict of the numbers printed, the row ids and the
    answers."""
    rng = np.random.default_rng(1)
    ids = np.minimum(rng.zipf(zipf_a, n_requests) - 1, n_rows - 1)
    loop = asyncio.get_running_loop()
    await service.start()
    if telemetry is not None:
        await telemetry.start()
        print(f"telemetry: {telemetry.url('/metricsz')}  {telemetry.url('/healthz')}  "
              f"{telemetry.url('/statusz')}  {telemetry.url('/tracez')}")
    # the first batch pays the bulk pass, which would read as an instant
    # budget burn: warm up with the SLO monitor detached
    saved_slo, service.slo = service.slo, None
    await service.score_many(ids[:64].tolist())
    service.slo = saved_slo
    chunks = np.array_split(ids, max(1, n_requests // concurrency))
    answers, shed_chunks, probes, paused = [], 0, {}, 0.0
    t0 = time.perf_counter()
    for i, chunk in enumerate(chunks):
        if probe is not None and i == len(chunks) // 2:
            tp = time.perf_counter()
            probes["mid"] = await loop.run_in_executor(None, probe, "mid")
            paused += time.perf_counter() - tp
        try:
            answers += await service.score_many(chunk.tolist())
        except ServiceOverloadedError:     # open loop: shed work is dropped
            shed_chunks += 1
    dt = time.perf_counter() - t0 - paused
    qps = n_requests / dt
    if shed_chunks:
        print(f"admission control shed {shed_chunks} chunk(s) "
              f"({service.stats.shed} requests)")
    snap = service.stats_snapshot()
    lat, qw = snap["latency_ms"], snap["queue_wait_ms"]
    print(f"served {snap['requests']} requests in {dt:.2f}s → {qps:,.0f} QPS")
    print(f"latency: p50 {lat['p50']:.2f} ms, p99 {lat['p99']:.2f} ms "
          f"(queue wait p50 {qw['p50']:.2f} / p99 {qw['p99']:.2f} ms)")
    print(f"batches: {snap['batches']} (mean size {snap['mean_batch']:.1f}), "
          f"cache hit rate {100 * snap['cache_hit_rate']:.1f}%")
    out = {"qps": qps, "seconds": dt, "p50_ms": lat["p50"], "p99_ms": lat["p99"],
           "batches": snap["batches"], "cache_hit_rate": snap["cache_hit_rate"],
           "shed_chunks": shed_chunks, "ids": ids, "answers": answers}
    if hot_swap:
        v2 = registry.publish(swap_model if swap_model is not None else compile_ensemble(
            schema, train(schema, args, seed=7), counter=counter))
        more = rng.integers(0, n_rows, 64)
        try:
            got = await service.score_many(more.tolist())
            print(f"hot-swapped to version {v2}; {len(got)} post-swap "
                  f"requests OK (sample score {got[0]:+.3f})")
            out.update(swap_version=v2, swap_ids=more, swap_scores=got)
        except ServiceOverloadedError:
            print(f"hot-swapped to version {v2}; post-swap requests shed (SLO state unhealthy)")
    if service.slo is not None:
        rep = out["slo"] = service.slo.evaluate()
        objs = "  ".join(f"{n}: burn {o['burn_fast']:.2f}/{o['burn_slow']:.2f} [{o['state']}]"
                         for n, o in rep["objectives"].items())
        print(f"SLO state: {rep['state']}  ({objs})")
    if probe is not None:
        probes["end"] = await loop.run_in_executor(None, probe, "end")
        out["probes"] = probes
    if telemetry is not None:
        await telemetry.stop()
    await service.stop()
    return out


def finish(args, w: Wiring) -> dict:
    """Stop the sampler and the flight recorder, write the trace; returns
    what it wrote."""
    out = {}
    if w.sampler is not None:
        w.sampler.stop()
        out["samples"] = w.sampler.samples
        print(f"wrote {w.sampler.samples} telemetry samples to {args.sample}")
    if w.flight is not None:
        w.flight.stop()
        st = out["flight"] = w.flight.status()
        print(f"flight recorder: {st['buffered']} spans buffered, "
              f"{len(st['dumps'])} dump(s), {st['suppressed']} suppressed")
    if args.trace:
        n = out["trace_spans"] = get_tracer().dump_chrome_trace(args.trace)
        get_tracer().dump_jsonl(args.trace + ".jsonl")
        disable_tracing()
        print(f"wrote {n} spans to {args.trace} (chrome://tracing / Perfetto)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--schema", default="star", choices=["star", "chain", "snowflake"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-fact", type=int, default=2000)
    ap.add_argument("--n-dim", type=int, default=64)
    ap.add_argument("--trees", type=int, default=5)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--concurrency", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=1.0)
    ap.add_argument("--cache-size", type=int, default=4096)
    ap.add_argument("--zipf", type=float, default=1.3)
    ap.add_argument("--follow", metavar="WAL_DIR", default=None,
                    help="follower mode: recover a read-only replica from this WAL dir "
                         "(+ its ckpt/ checkpoints) and tail the writer's log live; "
                         "replication lag feeds the SLO staleness objective "
                         "(degrade-only: a dead writer degrades the replica, never "
                         "kills it)")
    ap.add_argument("--follow-poll-ms", type=float, default=10.0,
                    help="follower tail-poll interval")
    ap.add_argument("--heartbeat-grace-s", type=float, default=5.0,
                    help="writer idle time beyond which the follower reports the idle "
                         "age as staleness (writer presumed dead past its heartbeat "
                         "cadence)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record spans and write a Chrome trace (open in Perfetto) "
                         "plus PATH.jsonl")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve /metricsz /healthz /statusz /tracez on this port "
                         "(0 = ephemeral, printed on start)")
    ap.add_argument("--slo", metavar="SPEC", default=None,
                    help="SLO objectives, e.g. 'latency=50ms@0.99,errors=0.01,"
                         "staleness=5s'; the burn-rate state feeds /healthz and "
                         "admission control")
    ap.add_argument("--flight", type=int, default=None, metavar="N",
                    help="always-on flight recorder keeping the last N spans (O(1) "
                         "memory ring; dumps FLIGHT_serve_*.json)")
    ap.add_argument("--flight-latency-ms", type=float, default=None,
                    help="dump the flight ring when a request exceeds this latency "
                         "(requires --flight)")
    ap.add_argument("--sample", metavar="PATH", default=None,
                    help="append periodic metric-snapshot deltas to this JSONL series")
    ap.add_argument("--sample-interval", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device for tables, queries and kernels "
                         "(cuda raises on a host without a GPU)")
    add_device_args(ap)
    args = ap.parse_args(argv)
    mesh = resolve_mesh(args)
    if args.follow and spmd.data_axis_size(mesh) > 1:
        raise ValueError("--follow needs one process (--mesh 0 or 1): a follower applies "
                         "the log on its own clock, so the ranks' collectives would fall "
                         "out of step")
    lead = is_lead(mesh)
    with contextlib.nullcontext() if lead else contextlib.redirect_stdout(None):
        return _run(args, mesh, lead)


def _run(args, mesh, lead: bool):
    schema = build_schema(args)
    group = schema.label_table
    counter = QueryCounter()
    swap = None
    with spmd.use_data_mesh(mesh):
        trees = train(schema, args)
        ens = compile_ensemble(schema, trees, counter=counter)
        if spmd.data_axis_size(mesh) > 1:
            # every rank runs these bulk passes; the served requests then
            # read their replicated results and run no collective
            ens.grouped_cached(group)
            swap = compile_ensemble(schema, train(schema, args, seed=7), counter=counter)
            swap.grouped_cached(group)
    print(f"compiled ensemble: {ens.n_trees} trees, {ens.total_leaves} stacked "
          f"leaves over {schema.n_tables} tables (group_by={group}) on {schema.device}"
          + (f", data-parallel over {mesh.size} ranks ({mesh.backend})"
             if swap is not None else ""))
    if not lead:
        return {"evals": counter.count}

    follower = extra = None
    serve_model = ens
    if args.follow:
        serve_model, follower, rep = open_follower(ens, args.follow, args.follow_poll_ms,
                                                   counter)
        print(f"follower: recovered to data_v{rep.recovered_lsn} (checkpoint lsn "
              f"{rep.checkpoint_lsn} + {rep.replayed} replayed, "
              f"{rep.tail_bytes_discarded}B torn tail discarded)")
        extra = follower_staleness(follower, args.heartbeat_grace_s)

    registry = ModelRegistry()
    registry.publish(serve_model)
    w = wire(args, registry, group, extra_staleness=extra, follower=follower is not None)
    n_rows = schema.table(group).n_rows
    out = asyncio.run(drive(w.service, n_rows, args.requests, args.concurrency, args.zipf,
                            registry, schema, args, counter, telemetry=w.telemetry,
                            hot_swap=follower is None, swap_model=swap))
    if follower is not None:
        follower.stop(drain=True)
        out["applied_lsn"] = follower.applied_lsn
        print(f"follower: applied through lsn {follower.applied_lsn}, replication lag "
              f"{follower.replication_lag_s():.3f}s, writer idle "
              f"{follower.writer_idle_s():.1f}s")
    out.update(finish(args, w))
    print(f"SumProd evaluations for all traffic: {counter.count} "
          f"(seed loop would need {args.trees * 2 ** args.depth + 1} per bulk pass)")
    out["evals"] = counter.count
    print(format_summary_table(
        merge_snapshots(get_registry().snapshot(), w.service.stats.registry.snapshot()),
        title="serve_relational metrics"))
    return out


if __name__ == "__main__":
    main()
    shutdown()
