"""Whole relational fits, back to back (a closed loop of one client).

Each request is ``Booster(schema, BoostConfig(**mix["boost"]),
hashes=...).fit()``, ended by a synchronize: the trainer, SumProd and its
segment-⊕ messages, and in the coefficient domain polymul.  The window
runs fits while its time lasts; the last one started finishes.
``fit_s`` is the window's whole time over its fits.

Correctness: every distinct fit of the window (they are alike when the
port is deterministic) is held against the reference following its
splits (``reference/trees.py``): split gain shortfall, leaf gap, SSR gap.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from rbrt_bench.lib import program, stats
from rbrt_bench.reference import join as rjoin, trees as rtrees


def _ref_cfg(mix: dict) -> dict:
    b = mix["boost"]
    return {"n_trees": b["n_trees"], "depth": b["depth"], "lr": b.get("lr", 1.0),
            "min_gain": b.get("min_gain", 1e-7)}


def setup(ctx) -> SimpleNamespace:
    from repro_torch.core import BoostConfig

    ds = ctx.generator.generate(ctx.config, ctx.seed, **ctx.mix.get("generate", {}))
    sch, schema_s = program.schema(ds, ctx.device)
    consts = program.hash_constants(ds, ctx.seed)
    bcfg = BoostConfig(**ctx.mix["boost"])
    st = SimpleNamespace(ds=ds, sch=sch, consts=consts, bcfg=bcfg, schema_s=schema_s,
                         hashes=program.table_hashes(consts, bcfg.sketch_k), outputs=[])
    if getattr(ctx, "warmup", True):
        _fit(st)                               # warm-up: builds and loads every kernel
        st.outputs = []
    return st


def _fit(st):
    import torch
    from repro_torch.core import Booster

    b = Booster(st.sch, st.bcfg, hashes=st.hashes)
    trees, trace = b.fit()
    if st.sch.device.type == "cuda":
        torch.cuda.synchronize()
    st.outputs.append((trees, trace.node_ssr))
    return b.counter.edges


def window(st, seconds: float, requests: int = 0) -> dict:
    """Fits while ``seconds`` last (or exactly ``requests`` fits)."""
    starts, ends, edges, failed = [], [], 0, 0
    t_end = time.perf_counter() + seconds
    while (len(starts) < requests) if requests else (time.perf_counter() < t_end):
        starts.append(time.perf_counter())
        edges += _fit(st)
        ends.append(time.perf_counter())
    return {"e2e": {"fit_s": stats.per_request_s(starts, ends)},
            "counters": {"fits": len(starts), "edges": edges},
            "attempted": len(starts), "failed": failed}


def _numpy(outputs, depth: int):
    out = []
    for trees, node_ssr in outputs:
        ssr = [{t: v.detach().cpu().numpy().astype(np.float64) for t, v in lvl.items()}
               for lvl in node_ssr]
        out.append({"trees": program.from_port_trees(trees),
                    "ssr": [ssr[i:i + depth] for i in range(0, len(ssr), depth)]})
    return out


def _same(a, b) -> bool:
    same = all(np.array_equal(x, y) for ta, tb in zip(a["trees"], b["trees"])
               for x, y in zip(ta, tb))
    return same and all(np.array_equal(a_l[t], b_l[t]) for ta, tb in zip(a["ssr"], b["ssr"])
                        for a_l, b_l in zip(ta, tb) for t in a_l)


def collect(st) -> dict:
    """The window's fits in numpy, alike ones once; frees the port's state."""
    fits = _numpy(st.outputs, st.bcfg.depth)
    distinct = []
    for f in fits:
        if not any(_same(f, d) for d in distinct):
            distinct.append(f)
    out = {"fits": distinct, "ds": st.ds, "consts": st.consts, "k": st.bcfg.sketch_k}
    st.outputs.clear()
    st.sch = None
    return out


def check(ctx, got: dict) -> dict:
    import torch

    join = rjoin.materialize(got["ds"])
    d = rtrees.Design(got["ds"], join, got["consts"], got["k"], ctx.device, torch.float64)
    worst = {"split_gap": 0.0, "leaf_gap": 0.0, "ssr_gap": 0.0}
    for f in got["fits"]:
        for name, v in rtrees.check(d, _ref_cfg(ctx.mix), f).items():
            worst[name] = max(worst[name], v)
    return worst


def control(ctx) -> dict:
    """The reference in bfloat16 put in the program's place, judged as the
    program is."""
    import torch

    ds = ctx.generator.generate(ctx.config, ctx.seed, **ctx.mix.get("generate", {}))
    consts = program.hash_constants(ds, ctx.seed)
    k = ctx.mix["boost"]["sketch_k"]
    join = rjoin.materialize(ds)
    low = rtrees.Design(ds, join, consts, k, ctx.device, torch.bfloat16)
    out = rtrees.fit(low, _ref_cfg(ctx.mix))
    del low
    return check(ctx, {"fits": [out], "ds": ds, "consts": consts, "k": k})
