"""Relational serving driver: train → compile → micro-batch serve.

Trains a booster on a synthetic relational workload, compiles the
ensemble into the one-pass scorer, publishes it to a versioned registry,
and drives the async micro-batching service with synthetic interactive
traffic (zipf-skewed row ids — the regime where the LRU cache earns its
keep).  Ends with a hot swap: a refreshed model is published mid-traffic
and new requests pick it up with zero downtime.

    PYTHONPATH=src python -m repro_torch.launch.serve_relational --requests 2000
    PYTHONPATH=src python -m repro_torch.launch.serve_relational --device cpu
"""
from __future__ import annotations

import argparse
import asyncio
import time

import numpy as np

from repro_torch.core import BoostConfig, Booster, QueryCounter
from repro_torch.relational import generators
from repro_torch.serving import ModelRegistry, RelationalScoringService, compile_ensemble


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


async def drive(service, n_rows, n_requests, concurrency, zipf_a, registry,
                schema, args, counter, hot_swap=True):
    """Warm up, serve ``n_requests`` zipf-skewed requests in chunks of
    ``concurrency``, then hot-swap a refreshed model.  Returns a dict of
    the numbers it printed."""
    rng = np.random.default_rng(1)
    ids = np.minimum(rng.zipf(zipf_a, n_requests) - 1, n_rows - 1)
    await service.start()
    await service.score_many(ids[:64].tolist())       # first batch pays the bulk pass
    t0 = time.perf_counter()
    for chunk in np.array_split(ids, max(1, n_requests // concurrency)):
        await service.score_many(chunk.tolist())
    dt = time.perf_counter() - t0
    qps = n_requests / dt
    snap = service.stats_snapshot()
    lat, qw = snap["latency_ms"], snap["queue_wait_ms"]
    print(f"served {snap['requests']} requests in {dt:.2f}s → {qps:,.0f} QPS")
    print(f"latency: p50 {lat['p50']:.2f} ms, p99 {lat['p99']:.2f} ms "
          f"(queue wait p50 {qw['p50']:.2f} / p99 {qw['p99']:.2f} ms)")
    print(f"batches: {snap['batches']} (mean size {snap['mean_batch']:.1f}), "
          f"cache hit rate {100 * snap['cache_hit_rate']:.1f}%")
    out = {"qps": qps, "seconds": dt, "p50_ms": lat["p50"], "p99_ms": lat["p99"],
           "batches": snap["batches"], "cache_hit_rate": snap["cache_hit_rate"]}
    if hot_swap:
        v2 = registry.publish(compile_ensemble(schema, train(schema, args, seed=7),
                                               counter=counter))
        more = rng.integers(0, n_rows, 64)
        got = await service.score_many(more.tolist())
        print(f"hot-swapped to version {v2}; {len(got)} post-swap "
              f"requests OK (sample score {got[0]:+.3f})")
        out.update(swap_version=v2, swap_ids=more, swap_scores=got)
    await service.stop()
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
    ap.add_argument("--device", default="cuda",
                    help="torch device for tables, queries and kernels "
                         "(cuda raises on a host without a GPU)")
    args = ap.parse_args(argv)

    schema = build_schema(args)
    trees = train(schema, args)
    counter = QueryCounter()
    ens = compile_ensemble(schema, trees, counter=counter)
    group = schema.label_table
    print(f"compiled ensemble: {ens.n_trees} trees, {ens.total_leaves} stacked "
          f"leaves over {schema.n_tables} tables (group_by={group}) on {schema.device}")

    registry = ModelRegistry()
    registry.publish(ens)
    service = RelationalScoringService(registry, group, max_batch=args.max_batch,
                                       max_wait_ms=args.max_wait_ms,
                                       cache_size=args.cache_size)
    n_rows = schema.table(group).n_rows
    out = asyncio.run(drive(service, n_rows, args.requests, args.concurrency, args.zipf,
                            registry, schema, args, counter))
    print(f"SumProd evaluations for all traffic: {counter.count} "
          f"(seed loop would need {args.trees * 2 ** args.depth + 1} per bulk pass)")
    out["evals"] = counter.count
    return out


if __name__ == "__main__":
    main()
