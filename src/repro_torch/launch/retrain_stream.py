"""Retrain-stream CLI: train → stream drift → delta-driven refits.

Trains an :class:`IncrementalBooster` (boosting queries answered from
maintained messages), then streams concept-drift batches (feature
rewrites + label shifts) at the tables.  After every batch the booster
measures residual drift with a cheap sketched-SSR query (served from
the message cache) and, above the threshold, warm-starts new trees on
the frozen ensemble's residuals.  Periodically the model is audited
against a full-refit oracle — a from-scratch ``Booster.fit`` on the
effective live tables — reporting MSE parity and the segment-⊕ edge
emissions both routes spent (the queries-avoided ratio).

    PYTHONPATH=src python -m repro_torch.launch.retrain_stream --batches 8
    PYTHONPATH=src python -m repro_torch.launch.retrain_stream --device cpu \\
        --batches 4 --n-fact 150 [--split-mode hist]

Telemetry: ``--trace [PATH]`` writes a Chrome trace of the sweeps,
message emissions and plan refreshes (and PATH.jsonl),
``--metrics-port`` serves ``/metricsz /healthz /statusz /tracez`` from a
thread, ``--slo`` judges each batch's refit latency and the model's
staleness, ``--flight N`` dumps the newest N spans past
``--flight-latency-ms`` (``FLIGHT_retrain_*.json``), ``--sample PATH``
appends metric deltas to a JSONL series.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import BoostConfig, Booster, materialize_join, predict_rows
from repro_torch.incremental import IncrementalBooster
from repro_torch.obs import (
    FlightRecorder, PeriodicSampler, SLOMonitor, TelemetryServer, disable_tracing,
    enable_tracing,
    format_summary_table, get_registry, get_tracer, parse_slo_spec,
)
from repro_torch.relational import generators


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


def audit(ib: IncrementalBooster, cfg: BoostConfig):
    """(mse_incremental, mse_full_refit, full_refit_edges) on the live
    join, with the full refit sized to the incremental ensemble."""
    eff = ib.effective_schema()
    full = Booster(eff, BoostConfig(
        n_trees=len(ib.trees), depth=cfg.depth, mode=cfg.mode,
        sketch_k=cfg.sketch_k, ssr_mode="off", seed=cfg.seed,
        split_mode=cfg.split_mode, hist_bins=cfg.hist_bins,
    ))
    trees_f, _ = full.fit()
    J = materialize_join(eff)
    X = torch.stack([J[c].to(torch.float32) for (_, c) in eff.features], dim=1)
    y = J[eff.label_column].double()
    mse_i = float(torch.mean((y - predict_rows(ib.trees, X).double()) ** 2))
    mse_f = float(torch.mean((y - predict_rows(trees_f, X).double()) ** 2))
    return mse_i, mse_f, full.counter.edges


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--schema", default="star", choices=["star", "chain", "snowflake"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-fact", type=int, default=400)
    ap.add_argument("--n-dim", type=int, default=24)
    ap.add_argument("--trees", type=int, default=3)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--rows-per-batch", type=int, default=8)
    ap.add_argument("--new-trees", type=int, default=1)
    ap.add_argument("--drift-threshold", type=float, default=0.05)
    ap.add_argument("--max-trees", type=int, default=None)
    ap.add_argument("--audit-every", type=int, default=4)
    ap.add_argument("--split-mode", default="exact", choices=["exact", "hist"],
                    help="hist = quantile-histogram sweep with incrementally "
                         "maintained bins (core/hist.py)")
    ap.add_argument("--hist-bins", type=int, default=256)
    ap.add_argument("--trace", metavar="PATH", nargs="?", const="trace_retrain.json",
                    default=None,
                    help="record spans (sweep, message emission, plan refresh) and "
                         "write a Chrome trace loadable in Perfetto, plus PATH.jsonl")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve /metricsz /healthz /statusz /tracez on this port "
                         "(0 = ephemeral) while the stream runs")
    ap.add_argument("--slo", metavar="SPEC", default=None,
                    help="e.g. 'latency=500ms@0.95,staleness=10s': per-batch refit "
                         "latency and delta-staleness burn rates")
    ap.add_argument("--flight", type=int, default=None, metavar="N",
                    help="flight-recorder ring of the last N spans with "
                         "latency-triggered FLIGHT_retrain_*.json dumps")
    ap.add_argument("--flight-latency-ms", type=float, default=None)
    ap.add_argument("--sample", metavar="PATH", default=None,
                    help="append periodic metric-snapshot deltas to this JSONL")
    ap.add_argument("--sample-interval", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device for tables, queries and kernels "
                         "(cuda raises on a host without a GPU)")
    args = ap.parse_args(argv)
    if args.trace:
        enable_tracing()

    schema = build_schema(args)
    cfg = BoostConfig(n_trees=args.trees, depth=args.depth, mode="sketch",
                      ssr_mode="off", seed=args.seed,
                      split_mode=args.split_mode, hist_bins=args.hist_bins)
    ib = IncrementalBooster(schema, cfg)
    t0 = time.perf_counter()
    ib.fit()
    print(f"initial fit on {schema.device}: {len(ib.trees)} trees in "
          f"{time.perf_counter() - t0:.1f}s — {ib.counter.count} queries, "
          f"{ib.counter.edges} segment-⊕ edges "
          f"(cache hit rate {ib.engine.cache.hit_rate:.2f})")

    slo = (SLOMonitor(parse_slo_spec(args.slo), fast_window_s=5.0, slow_window_s=30.0)
           if args.slo else None)
    flight = None
    if args.flight:
        flight = FlightRecorder(capacity=args.flight, name="retrain",
                                latency_trigger_ms=args.flight_latency_ms,
                                cooldown_s=5.0).start()
    telemetry = None
    if args.metrics_port is not None:
        telemetry = TelemetryServer(
            slo=slo, flight=flight, port=args.metrics_port,
            status_fn=lambda: {"n_trees": len(ib.trees), "staleness_s": ib.staleness_s()})
        telemetry.start_in_thread()
        print(f"telemetry: {telemetry.url('/metricsz')}  {telemetry.url('/healthz')}")
    sampler = None
    if args.sample:
        sampler = PeriodicSampler(
            args.sample, interval_s=args.sample_interval,
            extra_fn=lambda: {"n_trees": len(ib.trees), "staleness_s": ib.staleness_s(),
                              "slo_state": slo.state() if slo else None}).start()

    stream = generators.drift_stream(
        schema, ib.live_rows, seed=args.seed + 1,
        n_batches=args.batches, rows_per_batch=args.rows_per_batch,
    )
    inc_edges_total = 0
    for bi, batch in enumerate(stream):
        t0 = time.perf_counter()
        rep = ib.refit(deltas=batch, n_new_trees=args.new_trees,
                       drift_threshold=args.drift_threshold,
                       max_trees=args.max_trees)
        dt = (time.perf_counter() - t0) * 1e3
        if slo is not None:
            slo.record_latency(dt)
            slo.record_request(error=False)
            slo.set_staleness(ib.staleness_s())
        if flight is not None:
            flight.observe_latency(dt, batch=bi, refitted=rep.refitted)
        inc_edges_total += rep.edges
        action = (f"+{rep.n_new} trees → {rep.n_trees}" if rep.refitted
                  else "kept model")
        note = ""
        if (bi + 1) % args.audit_every == 0:
            mse_i, mse_f, full_edges = audit(ib, cfg)
            note = (f"  audit: mse {mse_i:.3f} vs full-refit {mse_f:.3f} "
                    f"({full_edges} edges for the oracle)")
        print(f"batch {bi:>3}: drift={rep.drift:7.3f} {action:>18} "
              f"edges={rep.edges:>4} {dt:7.1f} ms{note}")

    mse_i, mse_f, full_edges = audit(ib, cfg)
    print(f"\n{args.batches} drift batches: {inc_edges_total} incremental "
          f"segment-⊕ edges total; one full refit of the final model costs "
          f"{full_edges} ({full_edges * args.batches} for refit-every-batch, "
          f"{full_edges * args.batches / max(inc_edges_total, 1):.1f}× more)")
    print(f"final model: mse {mse_i:.3f} vs full-refit oracle {mse_f:.3f}; "
          f"message-cache hit rate {ib.engine.cache.hit_rate:.2f}")
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
    print(format_summary_table(get_registry().snapshot(), title="retrain_stream metrics"))
    if args.trace:
        n = get_tracer().dump_chrome_trace(args.trace)
        get_tracer().dump_jsonl(args.trace + ".jsonl")
        disable_tracing()
        print(f"wrote {n} spans to {args.trace} (chrome://tracing / Perfetto)")
    return mse_i, mse_f


if __name__ == "__main__":
    main()
