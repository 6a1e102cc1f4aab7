"""Maintained grouped scores under a stream of refresh batches (a closed
loop of one client).

Set-up makes one ensemble from the seed (``trees`` trees of depth
``depth``), publishes it as a ``MaintainedScorer`` with a write-ahead
log (an fsync after ``wal_sync_every`` batches or ``wal_sync_interval_s``
seconds, whichever comes first: the policy, stated by the mix), and
scores each root in ``roots`` once.  The generator's refresh stream
(``RefreshStream``: for TPC-H, RF1 and RF2 alternated) gives batch b;
a request applies it and publishes the refreshed grouped scores of every
root, ended by a synchronize.  The next batch waits for that.
``refresh_ms_p95`` is the 95th percentile over all the window's batches.

A delete is addressed by slots, as the port takes it.  The loaded rows
keep their slots (row i in slot i), and inserted rows go to the lowest
free slots (``TableDelta``'s rule), which the loop follows on its side
(:class:`Slots`) to find the slots of the orders a later RF2 deletes.

Correctness: after the window, the published scores of every root
against the reference's grouped scores on the database after the same
batches (``apply_refresh``), and a recovery from the run's own log:
it must reach the last batch applied, with the same scores.
"""
from __future__ import annotations

import heapq
import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from rbrt_bench.lib import program, stats
from rbrt_bench.reference import join as rjoin, score as rscore


class Slots:
    """The slots of one table's rows by key: a loaded row's is its row;
    inserted rows take the lowest free slots, in row order."""

    def __init__(self, keys: np.ndarray):
        self.n = len(keys)
        self.loaded = keys                    # loaded keys in row order, ascending
        self.freed: list = []                 # a heap of freed slots, all below ``top``
        self.top = self.n
        self.of_key: dict = {}                # inserted key → its slots

    def take(self, k: int) -> np.ndarray:
        got = [heapq.heappop(self.freed) for _ in range(min(k, len(self.freed)))]
        rest = k - len(got)
        got += range(self.top, self.top + rest)
        self.top += rest
        return np.asarray(got, np.int64)

    def insert(self, keys: np.ndarray) -> None:
        slots = self.take(len(keys))
        order = np.argsort(keys, kind="stable")
        bounds = np.flatnonzero(np.diff(keys[order])) + 1
        for run in np.split(order, bounds):
            self.of_key[int(keys[run[0]])] = slots[run]

    def delete(self, keys: np.ndarray, loaded_slots) -> np.ndarray:
        out = []
        for key in keys.tolist():
            s = self.of_key.pop(key, None)
            out.append(loaded_slots(key) if s is None else s)
        slots = np.concatenate(out) if out else np.zeros(0, np.int64)
        for x in slots.tolist():
            heapq.heappush(self.freed, x)
        return slots


def _deltas(st, b: int):
    from repro_torch.incremental import TableDelta

    kind, payload = st.stream.batch(b)
    if kind == "insert":
        for slots, cols in zip((st.parent_slots, st.child_slots), payload):
            slots.insert(np.asarray(cols[st.key]))
        return [TableDelta(t, inserts=cols) for t, cols in zip(st.insert_tables, payload)]
    lines = st.child_slots.delete(payload, lambda key: np.arange(*st.line_range(key)))
    rows = st.parent_slots.delete(
        payload, lambda key: np.searchsorted(st.parent_slots.loaded, [key]))
    return [TableDelta(st.child, deletes=lines), TableDelta(st.parent, deletes=rows)]


def _open(ctx, ds, factor_dtype=None):
    import torch
    from repro_torch.incremental import MaintainedScorer, WalWriter
    from repro_torch.serving import compile_ensemble

    sch, schema_s = program.schema(ds, ctx.device)
    trees = program.random_trees(ds, ctx.seed, ctx.mix["trees"], ctx.mix["depth"])
    ens = compile_ensemble(sch, program.to_port_trees(trees, ctx.device),
                           factor_dtype=factor_dtype or torch.float32)
    ms = MaintainedScorer(ens)
    wal_dir = tempfile.mkdtemp(prefix="rbrt_bench_wal_")
    wal = WalWriter(wal_dir, sync_every=ctx.mix["wal_sync_every"],
                    sync_interval_s=ctx.mix["wal_sync_interval_s"]).attach(ms.state)
    parent, child, key = ctx.mix["delete_from"]
    pk = np.asarray(ds.table(parent).columns[key])
    ck = np.asarray(ds.table(child).columns[key])
    if np.any(np.diff(pk) <= 0) or np.any(np.diff(ck) < 0):
        raise ValueError("the loaded rows must be in key order")
    starts = np.searchsorted(ck, pk, side="left")
    ends = np.append(starts[1:], len(ck))
    row = lambda key: int(np.searchsorted(pk, key))
    st = SimpleNamespace(
        ds=ds, sch=sch, trees=trees, ms=ms, wal=wal, wal_dir=wal_dir, schema_s=schema_s,
        stream=ctx.generator.RefreshStream(ctx.config, ctx.seed), roots=list(ctx.mix["roots"]),
        insert_tables=list(ctx.mix["insert_into"]), parent=parent, child=child, key=key,
        parent_slots=Slots(pk), child_slots=Slots(ck),
        line_range=lambda k: (starts[row(k)], ends[row(k)]),
        applied=[], published=None, factor_dtype=factor_dtype)
    for root in st.roots:
        ms.grouped_cached(root)
    return st


def _batch(st, b: int):
    import torch

    st.ms.apply(_deltas(st, b))
    st.published = [st.ms.grouped_cached(root) for root in st.roots]
    if st.sch.device.type == "cuda":
        torch.cuda.synchronize()
    st.applied.append(b)


def setup(ctx) -> SimpleNamespace:
    ds = ctx.generator.generate(ctx.config, ctx.seed)
    st = _open(ctx, ds)
    for b in range(ctx.mix["warmup_batches"]):
        _batch(st, b)
    return st


def window(st, seconds: float, requests: int = 0) -> dict:
    from repro_torch.obs import get_registry

    hist = get_registry().histogram("wal.append_ms")
    before = dict(hist.buckets)
    builds0 = st.ms.state.csr_builds
    lat = []
    b = len(st.applied)
    t_end = time.perf_counter() + seconds
    while (len(lat) < requests) if requests else (time.perf_counter() < t_end):
        t0 = time.perf_counter()
        _batch(st, b)
        lat.append((time.perf_counter() - t0) * 1e3)
        b += 1
    appends = {i: c - before.get(i, 0) for i, c in hist.buckets.items() if c > before.get(i, 0)}
    return {"e2e": {"refresh_ms_p95": stats.percentile(lat, 95)},
            "counters": {"batches": len(lat), "csr_builds": st.ms.state.csr_builds - builds0,
                         "wal_append_buckets": appends, "wal_bucket_res": hist.RES},
            "attempted": len(lat), "failed": 0}


def collect(st, recover: bool = True) -> dict:
    from repro_torch.incremental.recover import recover_scorer
    from repro_torch.serving import compile_ensemble

    import torch

    published = [(tot.cpu().numpy(), cnt.cpu().numpy()) for tot, cnt in st.published]
    last_lsn = st.wal.last_lsn
    st.wal.close()
    st.ms = st.published = None
    got = {"ds": st.ds, "trees": st.trees, "applied": list(st.applied), "roots": st.roots,
           "published": published, "last_lsn": last_lsn}
    if recover:
        ens = compile_ensemble(st.sch, program.to_port_trees(st.trees, st.sch.device),
                               factor_dtype=st.factor_dtype or torch.float32)
        ms, rep = recover_scorer(ens, st.wal_dir)
        got["recovered_lsn"] = rep.recovered_lsn
        got["recovered"] = [tuple(x.cpu().numpy() for x in ms.score_grouped(root))
                            for root in st.roots]
        del ms, ens
    shutil.rmtree(st.wal_dir, ignore_errors=True)
    st.sch = None
    return got


def check(ctx, got: dict) -> dict:
    final = ctx.generator.apply_refresh(
        got["ds"], [ctx.generator.RefreshStream(ctx.config, ctx.seed).batch(b)
                    for b in got["applied"]])
    join = rjoin.materialize(final)
    X = rscore.design(final, join, ctx.device)
    worst = {"count_gap": 0.0, "total_gap": 0.0,
             "lsn_gap": float(abs(got["last_lsn"] - got.get("recovered_lsn", got["last_lsn"])))}
    outs = [got["published"]] + ([got["recovered"]] if "recovered" in got else [])
    for root_i, root in enumerate(got["roots"]):
        ref = rscore.grouped(final, join, X, got["trees"], root)
        for scores in outs:
            for name, v in rscore.gaps(ref, *scores[root_i]).items():
                worst[name] = max(worst[name], v)
    return worst


def control(ctx) -> dict:
    """The reference in bfloat16 put in the program's place: its grouped
    scores after set-up's batches and a few more, judged as the published
    ones are.  (The port's own bfloat16 factors are no control here:
    they count exactly below 256 rows a group, which holds every group
    of this stream.)"""
    import torch

    ds = ctx.generator.generate(ctx.config, ctx.seed)
    stream = ctx.generator.RefreshStream(ctx.config, ctx.seed)
    applied = list(range(ctx.mix["warmup_batches"] + 4))
    final = ctx.generator.apply_refresh(ds, [stream.batch(b) for b in applied])
    join = rjoin.materialize(final)
    X = rscore.design(final, join, ctx.device, torch.bfloat16)
    trees = program.random_trees(ds, ctx.seed, ctx.mix["trees"], ctx.mix["depth"])
    low = [tuple(x.float().cpu().numpy() for x in rscore.grouped(final, join, X, trees, r)[:2])
           for r in ctx.mix["roots"]]
    got = {"ds": ds, "trees": trees, "applied": applied, "roots": list(ctx.mix["roots"]),
           "published": low, "last_lsn": len(applied)}
    return check(ctx, got)

