"""The port data-parallel over row-sharded tables, against itself in one
process and against the JAX package.

Sharding must be a pure placement change: scores, trees, delta
refreshes, snapshot reads and warm-start refits bit-equal to one
process, and ``QueryCounter`` untouched.  Compiled factors carry
integer counts, and the training properties put labels on the 1/16 grid
(through deltas too), so every cross-rank sum is exact in float32:
bit-equality is the spec, not a tolerance (``tests/test_sharded.py``'s
properties).  World sizes 2 and 3 run as gloo process groups on the CPU,
one spawn per world size for the whole module, each rank joined with a
timeout.  With 3 ranks the 512-row fact table does not divide and stays
replicated while the dimension tables shard: an edge with a replicated
child must run without a collective, and one with a local child with
exactly one.

Against the reference: the explicit ``ShardedSumProd`` at 3 ranks on
``tests/test_substrate.py``'s schemas, where every table needs padding,
within that test's rtol/atol 1e-4 (``Channels(3)``, ``Tropical``) and
exactly (``BooleanSR``, on a schema without empty segments); the 2-rank
sharded scores of a reference-trained ensemble within
``tests/test_torch_serving.py``'s tolerances (counts exact, totals rtol
1e-5 / atol 1e-4).  ``PolyCoeff`` shards too; its float sums
reassociate, so its SSR is held to the boosting tests' tolerance (rtol
1e-4 / atol 1e-3), not bit for bit, while its trees stay bit-equal.
The exact-mode fits are 2 trees of depth 3 (the reference's test fits
3): with 3 ranks, 2 trees keep the module under a minute on one worker.

This module imports no JAX at module level: the spawned ranks import it.
"""
import datetime
import multiprocessing
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import (Arithmetic, BoostConfig, Booster, BooleanSR, Channels,
                              QueryCounter, Schema, SumProd, Table, Tropical)
from repro_torch.distributed import spmd
from repro_torch.distributed.collectives import ShardedSumProd
from repro_torch.incremental import IncrementalBooster, MaintainedScorer, TableDelta
from repro_torch.launch import stream_deltas
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.relational import generators
from repro_torch.serving import compile_ensemble, score_grouped

WORLDS = (2, 3)
JOIN_TIMEOUT_S = 240.0
KINDS = ("star", "chain", "snowflake")
SKETCH = BoostConfig(n_trees=3, depth=3, mode="sketch", ssr_mode="off", seed=0)
EXACT = BoostConfig(n_trees=2, depth=3, mode="exact", ssr_mode="per_table", seed=0)
SUBSTRATE = ("star", "chain")
COEFF = BoostConfig(n_trees=2, depth=2, mode="sketch", sketch_domain="coeff", sketch_k=64,
                    ssr_mode="per_table", seed=0)


# ------------------------------------------------------------- workloads --

def _schema(kind):
    if kind == "star":          # 512 rows: sharded over 2 ranks, replicated over 3
        return generators.star_schema(seed=3, n_fact=512, n_dim=24, device="cpu")
    if kind == "chain":
        return generators.chain_schema(seed=9, n_rows=256, device="cpu")
    return generators.snowflake_schema(seed=7, n_fact=256, n_dim=16, device="cpu")


def _snap(x):
    return np.round(np.asarray(x) * 16.0) / 16.0


def _quantize_labels(sch):
    """Labels on the 1/16 grid: every label sum is exact in float32."""
    lt, lc = sch.label_table, sch.label_column
    tabs = [Table(t.name, {c: (_snap(v) if (t.name, c) == (lt, lc) else v)
                           for c, v in t.columns.items()}, t.feature_columns)
            for t in sch.tables]
    return Schema(tabs, label=(lt, lc), device="cpu")


def _quantize_delta(sch, batch):
    """The same grid for labels arriving through the delta stream."""
    lt, lc = sch.label_table, sch.label_column
    out = []
    for d in batch:
        ins, upd = d.inserts, d.updates
        if d.table == lt and ins and lc in ins:
            ins = {**ins, lc: _snap(ins[lc])}
        if d.table == lt and upd and lc in upd[1]:
            upd = (upd[0], {**upd[1], lc: _snap(upd[1][lc])})
        out.append(TableDelta(d.table, inserts=ins, deletes=d.deletes, updates=upd))
    return out


def _trees(ts):
    return [(t.feat, t.thr, t.leaf) for t in ts]


def _properties(trees, mesh):
    """Every bit-equality property's results with ``mesh`` (None: one
    process), from the one-process ``trees`` of each kind."""
    out = {}
    for kind in KINDS:
        sch, qsch = _schema(kind), _quantize_labels(_schema(kind))
        c = QueryCounter()
        with spmd.use_data_mesh(mesh):
            ens = compile_ensemble(sch, trees[kind], counter=c)
        scores = {t.name: score_grouped(ens, t.name) for t in sch.tables}
        placed = {t.name: spmd.is_row_sharded(ens.factors[t.name], mesh, rows=t.n_rows)
                  for t in sch.tables}
        out["scores", kind] = (scores, c.count, c.edges)
        out["placed", kind] = placed
        with spmd.use_data_mesh(mesh):
            b = Booster(qsch, EXACT)
        fit, _ = b.fit()
        out["trees", kind] = (_trees(fit), b.counter.count, b.counter.edges)
    for kind in ("star", "snowflake"):
        qsch = _quantize_labels(_schema(kind))
        group = qsch.label_table
        c = QueryCounter()
        with spmd.use_data_mesh(mesh):
            ms = MaintainedScorer(compile_ensemble(qsch, trees["q" + kind]), counter=c)
        outs = [ms.grouped_cached(group)]
        for batch in generators.delta_stream(qsch, ms.live_rows, seed=4, n_batches=6,
                                             ops_per_batch=8):
            ms.apply(batch)
            outs.append(ms.grouped_cached(group))
        out["refresh", kind] = (outs, c.count, c.edges)
        with spmd.use_data_mesh(mesh):
            ms = MaintainedScorer(compile_ensemble(qsch, trees["q" + kind]))
        reads = []
        for batch in [None] + list(range(4)):
            if batch is not None:
                ms.apply(next(stream))
            else:
                stream = generators.delta_stream(qsch, ms.live_rows, seed=4, n_batches=4,
                                                 ops_per_batch=8)
            snap = ms.snapshot(roots=(group,), pin_oracle=True)
            reads.append((snap.score_grouped(group), snap.recompute_oracle(group)))
        out["snapshot", kind] = reads
    qsch = _quantize_labels(_schema("star"))
    with spmd.use_data_mesh(mesh):
        ib = IncrementalBooster(qsch, SKETCH)
    ib.fit()
    for batch in generators.delta_stream(qsch, ib.live_rows, seed=11, n_batches=3,
                                         ops_per_batch=6):
        ib.refit(deltas=_quantize_delta(qsch, batch), n_new_trees=1, drift_threshold=-1.0)
    out["warm", "star"] = (_trees(ib.trees), ib.counter.count, ib.counter.edges)
    with spmd.use_data_mesh(mesh):
        b = Booster(qsch, COEFF)
    fit, trace = b.fit()
    out["coeff", "star"] = (_trees(fit), b.counter.count, b.counter.edges, trace.node_ssr)
    return out


def _substrate_factors(sch):
    """Channels(3) over the label statistics, Tropical on seeded normals,
    BooleanSR on seeded bits (as tests/test_substrate.py:151-188)."""
    sp = SumProd(sch)
    c3 = Channels(3)
    f = {t: v.clone() for t, v in sp.ones_factors(c3).items()}
    lbl = sch.labels
    f[sch.label_table] = torch.stack([torch.ones_like(lbl), lbl, lbl ** 2], -1)
    tr = {t.name: torch.from_numpy(np.random.default_rng(1).standard_normal(t.n_rows)
                                   .astype(np.float32)) for t in sch.tables}
    bo = {t.name: torch.from_numpy(np.random.default_rng(2).random(t.n_rows) < 0.8)
          for t in sch.tables}
    return {"channels": (c3, f), "tropical": (Tropical(), tr), "boolean": (BooleanSR(), bo)}


def _substrate(spec, mesh):
    out = {}
    for name, (tables, label) in spec.items():
        sch = Schema([Table(n, cols, fc) for n, cols, fc in tables], label=label,
                     device="cpu")
        ssp = ShardedSumProd(sch, mesh)
        for sname, (sem, f) in _substrate_factors(sch).items():
            out[name, sname] = {t.name: ssp(sem, f, group_by=t.name) for t in sch.tables}
    return out


def _rank_main(rank, world, rdv, out_dir, spec):
    """One rank: join the gloo group, run what ``spec`` asks, save the
    results (every rank: they must agree)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        mesh = make_data_mesh(world, device="cpu")
        out = {"properties": _properties(spec["trees"], mesh)}
        if "substrate" in spec:
            out["substrate"] = _substrate(spec["substrate"], mesh)
        if "reference" in spec:
            tables, label, trees = spec["reference"]
            sch = Schema([Table(n, cols, fc) for n, cols, fc in tables], label=label,
                         device="cpu")
            with spmd.use_data_mesh(mesh):
                ens = compile_ensemble(sch, trees)
            out["reference"] = {t.name: score_grouped(ens, t.name) for t in sch.tables}
        if "cli" in spec:
            out["cli"] = stream_deltas.main(spec["cli"])
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def _start(world, tmp, spec):
    ctx = multiprocessing.get_context("spawn")
    d = tmp / f"world{world}"
    d.mkdir()
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(d / "rdv"), str(d), spec))
             for r in range(world)]
    for p in procs:
        p.start()
    return d, procs


def _join(d, procs, deadline):
    import time

    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f"{len(hung)} rank(s) did not finish within {JOIN_TIMEOUT_S}s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    outs = []
    for r in range(len(procs)):
        with open(d / f"rank{r}.pkl", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


def _tables(rs):
    return ([(t.name, {c: np.asarray(v) for c, v in t.columns.items()},
              tuple(t.feature_columns)) for t in rs.tables],
            (rs.label_table, rs.label_column))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, star):
    """Worlds 3 and 2 spawned side by side (2 once the reference has
    fitted its ensemble), the one-process results computed here while
    they run.  {"one": results, 2: [per rank], 3: [per rank], and the
    reference inputs}."""
    import time

    from repro.core import BoostConfig as RConfig, Booster as RBooster
    from repro.relational.generators import chain_schema as rchain, star_schema as rstar

    from repro_torch import convert

    with spmd.use_data_mesh(None):
        trees = {kind: Booster(_schema(kind), SKETCH).fit()[0] for kind in KINDS}
        for kind in ("star", "snowflake"):
            trees["q" + kind] = Booster(_quantize_labels(_schema(kind)), SKETCH).fit()[0]
    rs = star[0]
    sub = {"star": rstar(seed=2, n_fact=203, n_dim=17),
           "chain": rchain(seed=3, n_rows=67, n_tables=3, fanout=3)}
    cli = ["--device", "cpu", "--mesh", "2", "--batches", "2", "--n-fact", "400",
           "--trees", "2", "--depth", "2", "--audit-every", "1"]
    tmp = tmp_path_factory.mktemp("sharded")
    out = {"ref_star": rs, "substrate": sub}
    started = {}
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        started[3] = _start(3, tmp, {"trees": trees,
                                     "substrate": {n: _tables(x) for n, x in sub.items()}})
        out["ref_trees"], _ = RBooster(rs, RConfig(n_trees=2, depth=2, mode="sketch",
                                                   ssr_mode="off")).fit()
        started[2] = _start(2, tmp, {"trees": trees, "cli": cli, "reference": (
            *_tables(rs), convert.trees(out["ref_trees"], device="cpu"))})
        out["one"] = _properties(trees, None)
    finally:
        for w, (d, procs) in started.items():
            out[w] = _join(d, procs, deadline)
    return out


def _equal(a, b):
    """Bit-equality of nested results (tensors, numbers, containers)."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _each_rank(runs, world, key):
    one = runs["one"][key]
    for rank, res in enumerate(runs[world]):
        assert _equal(res["properties"][key], one), f"rank {rank} of {world}: {key}"


# -------------------------------------------------------------- identity --

def test_no_mesh_helpers_are_identity():
    x = torch.arange(24.0).reshape(8, 3)
    assert spmd.current_data_mesh() is None
    assert spmd.data_axis_size() == 1
    assert spmd.mesh_fingerprint() is None
    assert spmd.shard_rows(x) is x
    assert spmd.psum_message(x) is x
    assert spmd.replicate(x) is x
    assert spmd.constrain_rows(x) is x
    assert not spmd.is_row_sharded(x, rows=8)


def test_mesh_of_one_resolves_to_no_mesh():
    mesh = make_data_mesh(1, device="cpu")
    with spmd.use_data_mesh(mesh):
        assert spmd.data_axis_size() == 1
        x = torch.ones((8, 2))
        assert spmd.shard_rows(x) is x
        assert spmd.psum_message(x, "min") is x
    assert spmd.current_data_mesh() is None


def test_single_process_scoring_unchanged_under_mesh_context():
    sch = _schema("star")
    trees, _ = Booster(sch, BoostConfig(n_trees=2, depth=2, mode="sketch",
                                        ssr_mode="off")).fit()
    t1, n1 = score_grouped(compile_ensemble(sch, trees), sch.label_table)
    with spmd.use_data_mesh(make_data_mesh(1, device="cpu")):
        ens = compile_ensemble(sch, trees)
    t2, n2 = score_grouped(ens, sch.label_table)
    assert torch.equal(t1, t2) and torch.equal(n1, n2)


def test_mesh_size_must_be_the_world_size(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        make_data_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="NCCL"):     # more ranks than visible cards
        make_data_mesh(device="cuda")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="needs a world of 2"):
        stream_deltas.main(["--device", "cpu", "--mesh", "2"])


def test_follow_refuses_a_mesh(monkeypatch):
    """A follower applies the log on its own clock: with ranks, their
    collectives would fall out of step."""
    from repro_torch.launch import serve_relational

    monkeypatch.setattr(serve_relational, "resolve_mesh",
                        lambda args: spmd.DataMesh(size=2, backend="gloo"))
    with pytest.raises(ValueError, match="--follow needs one process"):
        serve_relational.main(["--device", "cpu", "--follow", "unused"])


# ------------------------------------------------------ sharded vs one --

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_grouped_scores_bit_equal(runs, world, kind):
    """Scores by every table and QueryCounter count/edges."""
    _each_rank(runs, world, ("scores", kind))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_training_trees_bit_equal(runs, world, kind):
    """Exact-mode trees with per-table SSR on quantized labels (feat,
    thr, leaf), queries and edges."""
    _each_rank(runs, world, ("trees", kind))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["star", "snowflake"])
def test_sharded_delta_refresh_bit_equal(runs, world, kind):
    """6 delta_stream batches of 8 ops through a MaintainedScorer."""
    _each_rank(runs, world, ("refresh", kind))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["star", "snowflake"])
def test_sharded_snapshot_reads_bit_equal(runs, world, kind):
    """Pinned snapshots over 4 batches: each read equal to its pinned
    one-process oracle, and both equal to one process's."""
    _each_rank(runs, world, ("snapshot", kind))
    for read, oracle in runs[world][0]["properties"]["snapshot", kind]:
        assert _equal(read, oracle)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_warm_start_refit_bit_equal(runs, world):
    """Three quantized delta batches, each refit by one tree."""
    _each_rank(runs, world, ("warm", "star"))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_coefficient_sketch_within_ssr_tolerance(runs, world):
    """PolyCoeff is float32 and shards: the trees (exact statistics) are
    bit-equal, its SSR sums reassociate and are held to the boosting
    tests' rtol 1e-4 / atol 1e-3."""
    *one, ssr1 = runs["one"]["coeff", "star"]
    for res in runs[world]:
        *got, ssr = res["properties"]["coeff", "star"]
        assert _equal(got, one)
        assert len(ssr) == len(ssr1)
        for a, b in zip(ssr, ssr1):
            for tn in b:
                np.testing.assert_allclose(a[tn].numpy(), b[tn].numpy(), rtol=1e-4, atol=1e-3)


def test_three_ranks_keep_a_table_replicated(runs):
    """512 fact rows over 3 ranks stay whole; 24 dimension rows shard."""
    for world, placed_fact, placed_dim in ((2, True, True), (3, False, True)):
        placed = runs[world][0]["properties"]["placed", "star"]
        assert placed["fact"] is placed_fact and placed["dim0"] is placed_dim


def test_cli_streams_data_parallel(runs):
    """stream_deltas --mesh 2 on the 2-rank group: every audit exact."""
    assert [r["cli"] for r in runs[2]] == [0.0, 0.0]


# --------------------------------------------------- against the reference --

@pytest.mark.parametrize("semiring", ["channels", "tropical", "boolean"])
@pytest.mark.parametrize("name", SUBSTRATE)
def test_sharded_sumprod_matches_reference(runs, name, semiring):
    """The port's padded ShardedSumProd at 3 ranks against the
    reference's one-device SumProd, grouped by every table."""
    import jax.numpy as jnp

    from repro.core import (BooleanSR as RBool, Channels as RChannels, SumProd as RSumProd,
                            Tropical as RTropical)

    rs = runs["substrate"][name]
    sp = RSumProd(rs)
    ps = Schema([Table(n, c, fc) for n, c, fc in _tables(rs)[0]],
                label=(rs.label_table, rs.label_column), device="cpu")
    psem, pf = _substrate_factors(ps)[semiring]
    sem = {"channels": RChannels(3), "tropical": RTropical(), "boolean": RBool()}[semiring]
    f = {t: jnp.asarray(v.numpy()) for t, v in pf.items()}
    for res in runs[3]:
        got = res["substrate"][name, semiring]
        for t in rs.tables:
            want = np.asarray(sp(sem, f, group_by=t.name))
            if semiring != "boolean":
                np.testing.assert_allclose(got[t.name].numpy(), want, rtol=1e-4, atol=1e-4)
                continue
            # the reference's empty segments read True (ROADMAP §3): exact
            # against the port's one process, and against the reference
            # wherever no key of a child is empty (the star)
            g = got[t.name].numpy()
            np.testing.assert_array_equal(g, SumProd(ps)(psem, pf, group_by=t.name).numpy())
            assert not (g & ~want).any()
            if name == "star":
                np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("table", ["fact", "dim0", "dim1"])
def test_sharded_scores_of_reference_ensemble_match_reference(runs, table):
    """A reference-trained star ensemble, carried over and compiled over
    2 ranks, against the reference's score_grouped."""
    from repro.serving import compile_ensemble as rcompile, score_grouped as rscore

    rt, rc = rscore(rcompile(runs["ref_star"], runs["ref_trees"]), table)
    for res in runs[2]:
        tot, cnt = res["reference"][table]
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(rc))
        np.testing.assert_allclose(tot.numpy(), np.asarray(rt), rtol=1e-5, atol=1e-4)
