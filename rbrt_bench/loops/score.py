"""Grouped scoring passes of published ensembles (a closed loop of one
client).

Set-up makes ``mix["models"]`` ensembles from the seed (``trees`` trees
of depth ``depth`` each) and compiles each once, as a model version is
published.  Request i scores model i mod models grouped by table
``groups[i mod len(groups)]``: one ``score_grouped(ens, g)``, ended by a
synchronize.  No two requests in a row share a model and a table, so no
cache serves one.  ``score_ms_p95`` is the 95th percentile of all the
window's requests.

Correctness: every request's (Σŷ, count) per row of its table against
the reference's grouped scores of its model (``reference/score.py``).
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from rbrt_bench.lib import program, stats
from rbrt_bench.reference import join as rjoin, score as rscore


def _models(ctx, ds):
    return [program.random_trees(ds, ctx.seed, ctx.mix["trees"], ctx.mix["depth"], stream=m)
            for m in range(ctx.mix["models"])]


def _compile(sch, trees, device, factor_dtype=None):
    import torch
    from repro_torch.serving import compile_ensemble

    return compile_ensemble(sch, program.to_port_trees(trees, device),
                            factor_dtype=factor_dtype or torch.float32)


def setup(ctx) -> SimpleNamespace:
    ds = ctx.generator.generate(ctx.config, ctx.seed, **ctx.mix.get("generate", {}))
    sch, schema_s = program.schema(ds, ctx.device)
    trees = _models(ctx, ds)
    ens = [_compile(sch, t, ctx.device) for t in trees]
    st = SimpleNamespace(ds=ds, sch=sch, trees=trees, ens=ens, schema_s=schema_s,
                         groups=list(ctx.mix["groups"]), outputs=[])
    if getattr(ctx, "warmup", True):
        for i in range(len(ens) * len(st.groups)):    # warm-up: every model and table once
            _request(st, i)
        st.outputs = []
    return st


def _combo(st, i):
    return i % len(st.ens), st.groups[i % len(st.groups)]


def _request(st, i):
    import torch
    from repro_torch.serving import score_grouped

    m, g = _combo(st, i)
    tot, cnt = score_grouped(st.ens[m], g)
    if st.sch.device.type == "cuda":
        torch.cuda.synchronize()
    st.outputs.append((m, g, tot, cnt))


def window(st, seconds: float, requests: int = 0) -> dict:
    lat = []
    t_end = time.perf_counter() + seconds
    i = 0
    while (i < requests) if requests else (time.perf_counter() < t_end):
        t0 = time.perf_counter()
        _request(st, i)
        lat.append((time.perf_counter() - t0) * 1e3)
        i += 1
    return {"e2e": {"score_ms_p95": stats.percentile(lat, 95)},
            "counters": {"passes": i}, "attempted": i, "failed": 0}


def collect(st) -> dict:
    outs = [(m, g, tot.cpu().numpy(), cnt.cpu().numpy()) for m, g, tot, cnt in st.outputs]
    st.outputs.clear()
    st.ens = st.sch = None
    return {"outputs": outs, "ds": st.ds, "trees": st.trees}


def check(ctx, got: dict) -> dict:
    ds = got["ds"]
    join = rjoin.materialize(ds)
    X = rscore.design(ds, join, ctx.device)
    refs = {}
    worst = {"count_gap": 0.0, "total_gap": 0.0}
    for m, g, tot, cnt in got["outputs"]:
        if (m, g) not in refs:
            refs[(m, g)] = rscore.grouped(ds, join, X, got["trees"][m], g)
        for name, v in rscore.gaps(refs[(m, g)], tot, cnt).items():
            worst[name] = max(worst[name], v)
    return worst


def control(ctx) -> dict:
    """The port's own bfloat16 factors (its ``factor_dtype`` path), one
    pass of every model and table, judged as the timed path is."""
    import torch

    ds = ctx.generator.generate(ctx.config, ctx.seed, **ctx.mix.get("generate", {}))
    sch, _ = program.schema(ds, ctx.device)
    trees = _models(ctx, ds)
    st = SimpleNamespace(ds=ds, sch=sch, trees=trees, groups=list(ctx.mix["groups"]),
                         ens=[_compile(sch, t, ctx.device, torch.bfloat16) for t in trees],
                         outputs=[])
    for i in range(len(st.ens) * len(st.groups)):
        _request(st, i)
    return check(ctx, collect(st))
