"""Delta-stream CLI: train → compile → maintain under live table churn.

Trains a booster on a synthetic relational workload, compiles the
ensemble, wraps it in a :class:`MaintainedScorer`, publishes it to the
serving registry, and then streams random insert/delete/update batches
at the tables.  After every batch the maintained grouped scores are
refreshed along the changed tables' root paths only; periodically they
are audited against a full recompute oracle (fresh ``compile_ensemble``
on the effective live tables).  Reports per-batch maintenance latency,
the segment-⊕ edge ratio vs full recompute, and the audit verdict.

    PYTHONPATH=src python -m repro_torch.launch.stream_deltas --batches 20
    PYTHONPATH=src python -m repro_torch.launch.stream_deltas --device cpu \\
        --batches 4 --wal-dir /tmp/wal

With ``--wal-dir`` every applied batch is appended to a durable log
(``--wal-sync-every`` appends a fsync), ``--checkpoint-every`` N batches
checkpoints the dynamic store, and a directory that already holds a log
is recovered (newest checkpoint + log tail) and resumed; ``serve_relational
--follow DIR`` serves a replica that tails it.

Telemetry: ``--metrics-port`` serves ``/metricsz /healthz /statusz
/tracez`` from a thread while the stream runs, ``--slo`` judges each
batch's maintenance latency and the served data's staleness,
``--flight N`` dumps the newest N spans past ``--flight-latency-ms``
(``FLIGHT_deltas_*.json``), ``--sample PATH`` appends metric deltas to a
JSONL series.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.core import BoostConfig, Booster, QueryCounter
from repro_torch.incremental import MaintainedScorer
from repro_torch.obs import (
    FlightRecorder, PeriodicSampler, SLOMonitor, TelemetryServer, format_summary_table,
    get_registry, parse_slo_spec,
)
from repro_torch.relational import generators
from repro_torch.serving import ModelRegistry, compile_ensemble


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


def audit(ms: MaintainedScorer, group: str) -> float:
    """Max |maintained − fresh-recompute| over every slot (want 0.0)."""
    tot_o, cnt_o = ms.recompute_oracle(group)
    tot_m, cnt_m = ms.grouped_cached(group)
    err_t = float((tot_m - tot_o).abs().max())
    err_c = float((cnt_m - cnt_o).abs().max())
    return max(err_t, err_c)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--schema", default="star", choices=["star", "chain", "snowflake"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-fact", type=int, default=1000)
    ap.add_argument("--n-dim", type=int, default=48)
    ap.add_argument("--trees", type=int, default=4)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--ops", type=int, default=8)
    ap.add_argument("--audit-every", type=int, default=4)
    ap.add_argument("--wal-dir", metavar="DIR", default=None,
                    help="durable delta log: append every applied batch to "
                         "DIR/wal.log (crash-consistent; a follower process can tail "
                         "it with serve_relational --follow DIR).  An existing log is "
                         "recovered and resumed.")
    ap.add_argument("--checkpoint-every", type=int, default=None, metavar="N",
                    help="checkpoint the dynamic store to DIR/ckpt every N "
                         "batches (recovery = newest checkpoint + WAL tail)")
    ap.add_argument("--wal-sync-every", type=int, default=8,
                    help="fsync the log every N appends (group commit)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve /metricsz /healthz /statusz /tracez on this port "
                         "(0 = ephemeral) for the duration of the stream")
    ap.add_argument("--slo", metavar="SPEC", default=None,
                    help="e.g. 'latency=100ms@0.99,staleness=2s': per-batch "
                         "maintenance latency and served-data staleness")
    ap.add_argument("--flight", type=int, default=None, metavar="N",
                    help="flight-recorder ring of the last N spans with "
                         "latency-triggered FLIGHT_deltas_*.json dumps")
    ap.add_argument("--flight-latency-ms", type=float, default=None)
    ap.add_argument("--sample", metavar="PATH", default=None,
                    help="append periodic metric-snapshot deltas to this JSONL")
    ap.add_argument("--sample-interval", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device for tables, queries and kernels "
                         "(cuda raises on a host without a GPU)")
    args = ap.parse_args(argv)

    schema = build_schema(args)
    group = schema.label_table
    cfg = BoostConfig(n_trees=args.trees, depth=args.depth, mode="sketch", ssr_mode="off")
    trees, _ = Booster(schema, cfg).fit()
    counter = QueryCounter()
    ms = MaintainedScorer(compile_ensemble(schema, trees), counter=counter)
    wal = ckpt_dir = None
    if args.wal_dir:
        from repro_torch.incremental.recover import recover_scorer, save_checkpoint
        from repro_torch.incremental.wal import WalWriter, wal_path

        ckpt_dir = os.path.join(args.wal_dir, "ckpt")
        if os.path.exists(wal_path(args.wal_dir)) or os.path.isdir(ckpt_dir):
            ms, rep = recover_scorer(
                compile_ensemble(schema, trees), args.wal_dir,
                ckpt_dir if os.path.isdir(ckpt_dir) else None, counter=counter)
            print(f"recovered: checkpoint lsn {rep.checkpoint_lsn} + "
                  f"{rep.replayed} replayed → data_v{rep.recovered_lsn} "
                  f"({rep.tail_bytes_discarded}B torn tail discarded)")
        wal = WalWriter(args.wal_dir, sync_every=args.wal_sync_every,
                        repair=True).attach(ms.state)
    registry = ModelRegistry()
    v = registry.publish(ms)
    ms.grouped_cached(group)                      # prime the message cache
    full_edges = len(schema.join_tree(group).edges)
    print(f"published v{v}: {ms.total_leaves} stacked leaves, "
          f"{schema.n_tables} tables on {schema.device}; full pass = {full_edges} "
          f"segment-⊕ edges")

    slo = (SLOMonitor(parse_slo_spec(args.slo), fast_window_s=5.0, slow_window_s=30.0)
           if args.slo else None)
    flight = None
    if args.flight:
        flight = FlightRecorder(capacity=args.flight, name="deltas",
                                latency_trigger_ms=args.flight_latency_ms,
                                cooldown_s=5.0).start()
    telemetry = None
    if args.metrics_port is not None:
        telemetry = TelemetryServer(
            slo=slo, flight=flight, port=args.metrics_port,
            status_fn=lambda: {"data_version": ms.data_version,
                               "staleness_s": ms.staleness_s()})
        telemetry.start_in_thread()
        print(f"telemetry: {telemetry.url('/metricsz')}  {telemetry.url('/healthz')}")
    sampler = None
    if args.sample:
        sampler = PeriodicSampler(
            args.sample, interval_s=args.sample_interval,
            extra_fn=lambda: {"data_version": ms.data_version,
                              "staleness_s": ms.staleness_s(),
                              "slo_state": slo.state() if slo else None}).start()

    stream = generators.delta_stream(
        schema, ms.live_rows, seed=args.seed + 1,
        n_batches=args.batches, ops_per_batch=args.ops,
    )
    lat, inc_edges = [], 0
    for bi, batch in enumerate(stream):
        e0 = counter.edges
        t0 = time.perf_counter()
        dv = ms.apply(batch)
        if slo is not None:
            slo.set_staleness(ms.staleness_s())   # applied, not yet served
        ms.grouped_cached(group)                  # path-restricted refresh
        lat.append((time.perf_counter() - t0) * 1e3)
        if slo is not None:
            slo.record_latency(lat[-1])
            slo.record_request(error=False)
            slo.set_staleness(ms.staleness_s())   # refreshed: 0 again
        if flight is not None:
            flight.observe_latency(lat[-1], batch=bi)
        inc_edges += counter.edges - e0
        ops = sum(d.n_ops for d in batch)
        note = ""
        if (bi + 1) % args.audit_every == 0:
            err = audit(ms, group)
            note = f"  audit max|Δ|={err:.1e}" + ("  OK" if err == 0.0 else "  DRIFT!")
        if (ckpt_dir is not None and args.checkpoint_every
                and (bi + 1) % args.checkpoint_every == 0):
            path = save_checkpoint(ms.state, ckpt_dir)
            note += f"  ckpt→{os.path.basename(path)}"
        print(f"batch {bi:>3} ({ops} ops, {len(batch)} tables) → data_v{dv} "
              f"edges={counter.edges - e0} {lat[-1]:6.1f} ms{note}")
    n = len(lat)
    print(f"\n{n} batches: mean maintenance {np.mean(lat):.1f} ms; "
          f"segment-⊕ edges {inc_edges} incremental vs {full_edges * n} "
          f"full-recompute ({full_edges * n / max(inc_edges, 1):.1f}× fewer)")
    err = audit(ms, group)
    print(f"final audit vs fresh recompute: max|Δ|={err:.1e} "
          + ("(exact)" if err == 0.0 else "(DRIFT)"))
    if wal is not None:
        wal.heartbeat()                  # followers see a live, idle writer
        durable = wal.sync()
        wal.close()
        print(f"WAL: durable through lsn {durable} "
              f"({os.path.getsize(wal.path)} bytes at {wal.path})")
    if slo is not None:
        rep = slo.evaluate()
        print(f"SLO state: {rep['state']}  "
              + "  ".join(f"{n}: burn {o['burn_fast']:.2f} [{o['state']}]"
                          for n, o in rep["objectives"].items()))
    if sampler is not None:
        sampler.stop()
        print(f"wrote {sampler.samples} telemetry samples to {args.sample}")
    if telemetry is not None:
        telemetry.stop_thread()
    if flight is not None:
        flight.stop()
        st = flight.status()
        print(f"flight recorder: {st['buffered']} spans buffered, {len(st['dumps'])} dump(s)")
    print(format_summary_table(get_registry().snapshot(), title="stream_deltas metrics"))
    return err


if __name__ == "__main__":
    main()
