"""Incremental maintenance of the port against the JAX package.

The same delta batches (the reference's ``delta_stream``, same seed) go
into the reference's and the port's ``MaintainedScorer``, built over the
same tables (``convert.schema``) and the same reference-trained trees
(``convert.trees``).  After every batch, for every grouping root:
counts equal exactly; totals within 1e-6·Σ|ŷ| per row (Σ|ŷ| the row's
counts contracted with |leaf values|: the two contract in different
orders); ``QueryCounter`` queries and edges equal; and within the port,
``recompute_oracle`` bit-equal to ``grouped_cached``.  Also: the
reference's single cases (path locality, a new join key, capacity
growth, a rejected key-column update), snapshots, the service across a
delta and a hot swap, the maintained join trees' CSRs, and the key-id
assignment and delta generators against the reference's."""
import asyncio

import numpy as np
import pytest
import torch

from repro.core import BoostConfig as RConfig, Booster as RBooster, QueryCounter as RCounter
from repro.incremental import (DynamicEdge as RDynamicEdge, DynamicTable as RDynamicTable,
                               MaintainedScorer as RScorer, TableDelta as RDelta)
from repro.relational.generators import delta_stream as rdelta_stream
from repro.relational.generators import drift_stream as rdrift_stream
from repro.serving import compile_ensemble as rcompile

from repro_torch import convert
from repro_torch.core import QueryCounter
from repro_torch.incremental import DynamicEdge, DynamicTable, MaintainedScorer, TableDelta
from repro_torch.incremental.deltas import assign_ids
from repro_torch.kernels.segment_sum import Segments
from repro_torch.relational.generators import delta_stream, drift_stream
from repro_torch.serving import (ModelRegistry, RelationalScoringService, compile_ensemble,
                                 contract)

FIXTURES = ["star", "chain", "snowflake"]


@pytest.fixture(scope="module")
def fitted(request):
    """Per fixture: (ref schema, port schema, ref trees, port trees); the
    reference trains 2 trees of depth 2 as ``stream_deltas`` does."""
    cache = {}

    def get(name):
        if name not in cache:
            rs = request.getfixturevalue(name)[0]
            rt, _ = RBooster(rs, RConfig(n_trees=2, depth=2, mode="sketch",
                                         ssr_mode="off")).fit()
            cache[name] = (rs, convert.schema(rs, device="cpu"), rt,
                           convert.trees(rt, device="cpu"))
        return cache[name]
    return get


def _pair(fitted, name, **kw):
    rs, ps, rt, pt = fitted(name)
    rms = RScorer(rcompile(rs, rt), counter=RCounter(), **kw)
    pms = MaintainedScorer(compile_ensemble(ps, pt), counter=QueryCounter(), **kw)
    return rms, pms


def _port_delta(d) -> TableDelta:
    return TableDelta(table=d.table, inserts=d.inserts, deletes=d.deletes, updates=d.updates)


def _apply_both(rms, pms, batch):
    assert rms.apply(batch) == pms.apply([_port_delta(d) for d in batch])


def _check(rms, pms, roots):
    """Counts exact, totals within 1e-6·Σ|ŷ|, counters equal, and the
    port's oracle bit-equal to its maintained scores."""
    for root in roots:
        rt, rc = (np.asarray(a) for a in rms.grouped_cached(root))
        pt, pc = pms.grouped_cached(root)
        np.testing.assert_array_equal(pc.numpy(), rc)
        mag = contract(pms._counts(root), pms.leaf_values.abs(), pms.tree0_leaves)[0]
        assert bool(((pt.double() - torch.from_numpy(np.array(rt)).double()).abs()
                     <= 1e-6 * mag.double() + 1e-30).all()), root
    assert (pms.counter.count, pms.counter.edges) == (rms.counter.count, rms.counter.edges)
    for root in roots:
        ot, oc = pms.recompute_oracle(root)
        mt, mc = pms.grouped_cached(root)
        assert torch.equal(ot, mt) and torch.equal(oc, mc), root


@pytest.mark.parametrize("fixture", FIXTURES)
def test_delta_stream_matches_reference_and_oracle(fitted, fixture):
    rms, pms = _pair(fitted, fixture)
    roots = [t.name for t in rms.schema.tables]
    _check(rms, pms, roots)
    n = 0
    for batch in rdelta_stream(rms.schema, rms.live_rows, seed=17, n_batches=3,
                               ops_per_batch=6):
        _apply_both(rms, pms, batch)
        _check(rms, pms, roots)
        n += 1
    assert n == 3


def test_single_table_delta_is_path_local(fitted):
    """A sub-dimension update re-emits its 2-edge root path of the
    snowflake's 4, in both packages."""
    rms, pms = _pair(fitted, "snowflake")
    _check(rms, pms, ["fact"])
    rng = np.random.default_rng(3)
    slots = rms.live_rows("sub0")[:2]
    e0 = pms.counter.edges
    _apply_both(rms, pms, [RDelta("sub0", updates=(slots, {
        "s0f0": rng.standard_normal(2).astype(np.float32)}))])
    _check(rms, pms, ["fact"])
    assert pms.counter.edges - e0 == 2


def test_new_join_key_joins_once_the_other_side_has_it(fitted):
    rms, pms = _pair(fitted, "star")
    _check(rms, pms, ["fact", "dim0"])
    fact, dim = rms.schema.table("fact"), rms.schema.table("dim0")
    new_key = int(max(np.asarray(dim.col("k0")).max(), np.asarray(fact.col("k0")).max())) + 5
    row = {c: (np.asarray([new_key], fact.col(c).dtype) if c == "k0"
               else np.zeros(1, fact.col(c).dtype)) for c in fact.columns}
    n_before = pms.tables["fact"].n_live
    _apply_both(rms, pms, [RDelta("fact", inserts=row)])
    slot = int(np.setdiff1d(pms.live_rows("fact"), np.arange(n_before))[0])
    _check(rms, pms, ["fact", "dim0"])
    assert float(pms.grouped_cached("fact")[1][slot]) == 0.0      # dangling key
    drow = {c: (np.asarray([new_key], dim.col(c).dtype) if c == "k0"
                else np.zeros(1, dim.col(c).dtype)) for c in dim.columns}
    _apply_both(rms, pms, [RDelta("dim0", inserts=drow)])
    _check(rms, pms, ["fact", "dim0"])
    assert float(pms.grouped_cached("fact")[1][slot]) > 0.0


def test_capacity_growth_keeps_slots_and_scores(fitted):
    rms, pms = _pair(fitted, "star", slack=0.05)
    _check(rms, pms, ["fact", "dim1"])
    live0 = pms.live_rows("fact")
    tot0, cnt0 = (t.clone() for t in pms.grouped_cached("fact"))
    fact = rms.schema.table("fact")
    k = pms.tables["fact"].capacity - pms.tables["fact"].n_live + 3
    rng = np.random.default_rng(9)
    ins = {c: (rng.integers(0, 24, k).astype(fact.col(c).dtype) if c.startswith("k")
               else rng.standard_normal(k).astype(fact.col(c).dtype)) for c in fact.columns}
    cap0 = pms.tables["fact"].capacity
    _apply_both(rms, pms, [RDelta("fact", inserts=ins)])
    assert pms.tables["fact"].capacity == rms.tables["fact"].capacity > cap0
    _check(rms, pms, ["fact", "dim1"])
    tot1, cnt1 = pms.grouped_cached("fact")
    assert torch.equal(tot1[live0], tot0[live0]) and torch.equal(cnt1[live0], cnt0[live0])


def test_key_column_update_is_rejected_in_both(fitted):
    rms, pms = _pair(fitted, "star")
    bad = (np.asarray([0]), {"k0": np.asarray([3])})
    with pytest.raises(ValueError):
        rms.apply([RDelta("fact", updates=bad)])
    with pytest.raises(ValueError):
        pms.apply([TableDelta("fact", updates=bad)])
    assert pms.data_version == rms.data_version == 0
    _check(rms, pms, ["fact"])


def test_snapshot_is_unchanged_by_later_deltas(fitted):
    _, pms = _pair(fitted, "snowflake")
    pms.grouped_cached("fact")
    for batch in delta_stream(pms.schema, pms.live_rows, seed=5, n_batches=1, ops_per_batch=6):
        pms.apply(batch)
    snap = pms.snapshot(pin_oracle=True)
    pinned = [t.clone() for t in snap.grouped_cached("fact")]
    want = pms.recompute_oracle("fact")
    for batch in delta_stream(pms.schema, pms.live_rows, seed=6, n_batches=3, ops_per_batch=8):
        pms.apply(batch)
        pms.grouped_cached("fact")
    again = snap.score_grouped("fact")                    # recomputed from the pin
    for a, b, c, d in zip(again, pinned, snap.recompute_oracle("fact"), want):
        assert torch.equal(a, b) and torch.equal(c, d) and torch.equal(a, c)
    assert snap.data_version == 1 and pms.data_version == 4


def test_service_never_serves_stale_scores_across_deltas_and_swap(fitted):
    rs, ps, rt, pt = fitted("star")
    ms = MaintainedScorer(compile_ensemble(ps, pt))
    reg = ModelRegistry()
    reg.publish(ms)
    svc = RelationalScoringService(reg, "fact", max_batch=16, max_wait_ms=2.0,
                                   cache_size=256)
    rid = 3

    def mean(ens):
        tot, cnt = ens.grouped_cached("fact")
        return float(tot[rid]) / max(float(cnt[rid]), 1.0)

    async def run():
        await svc.start()
        before = await svc.score(rid)
        assert await svc.score(rid) == before and svc.stats.cache_hits >= 1
        dk = int(ms.tables["fact"].columns["k0"][rid])
        cols = {c: np.asarray([7.5], np.float32) for c in ps.table("dim0").feature_columns}
        ms.apply([TableDelta("dim0", updates=(np.asarray([dk]), cols))])
        np.testing.assert_allclose(await svc.score(rid), mean(ms), rtol=1e-6)
        assert before != 0.0
        ms.apply([TableDelta("dim0", deletes=np.asarray([dk]))])
        assert await svc.score(rid) == 0.0                    # left the join
        e1 = compile_ensemble(ps, pt[:1])
        reg.publish(e1)
        np.testing.assert_allclose(await svc.score(rid), mean(e1), rtol=1e-6)
        await svc.stop()

    asyncio.run(run())


def test_unchanged_edges_keep_their_csr_and_rebuilt_ones_match_from_ids(fitted):
    """A structural batch on a leaf table rebuilds only its edge's CSR."""
    _, pms = _pair(fitted, "snowflake")
    st = pms.state
    jt0 = st.jt("fact")
    sub = pms.schema.table("sub0")
    row = {c: np.asarray(sub.col(c)[:1]) for c in sub.columns}       # an existing key
    pms.apply([TableDelta("sub0", inserts=row)])
    jt1 = st.jt("fact")
    assert jt1 is not jt0
    names = pms.schema.names
    for e0, e1 in zip(jt0.edges, jt1.edges):
        pair = {names[e1.child], names[e1.parent]}
        de = st.edges[frozenset(pair)]
        if "sub0" in pair:                      # sub0 → dim0: the child's ids changed
            assert e1.child_seg is not e0.child_seg
        else:
            assert e1.child_seg is e0.child_seg and e1.parent_ids is e0.parent_ids
        want = Segments.from_ids(de.ids[names[e1.child]], de.n_keys, "cpu")
        for f in ("ids", "order", "offsets"):
            assert torch.equal(getattr(e1.child_seg, f), getattr(want, f))
        assert torch.equal(e1.child_seg.plan.item_offsets, want.plan.item_offsets)
        assert torch.equal(e1.parent_ids, torch.from_numpy(de.ids[names[e1.parent]]).long())


def test_edge_side_ids_cross_once_as_child_and_parent(fitted):
    """After a fact insert, the fact side of fact–dim0 is dim0's tree's
    CSR ids and fact's tree's parent ids: one copy, one CSR built for
    each side the insert moved."""
    _, pms = _pair(fitted, "star")
    st = pms.state
    fact = pms.schema.table("fact")
    st.jt("fact"), st.jt("dim0")
    builds = st.csr_builds
    pms.apply([TableDelta("fact", inserts={c: np.asarray(fact.col(c)[:1])
                                           for c in fact.columns})])
    names = pms.schema.names

    def edge(root, child, parent):
        return next(e for e in st.jt(root).edges
                    if (names[e.child], names[e.parent]) == (child, parent))

    as_parent = edge("fact", "dim0", "fact").parent_ids
    assert edge("dim0", "fact", "dim0").child_seg.ids.data_ptr() == as_parent.data_ptr()
    assert torch.equal(as_parent, torch.from_numpy(
        st.edges[frozenset(("fact", "dim0"))].ids["fact"]).long())
    assert st.csr_builds - builds == 1          # fact's CSR on fact–dim0; dim1 → fact kept


def test_pinned_view_keeps_its_ids_on_the_cpu(fitted):
    """Torn-read regression: an insert reusing a deleted slot rewrites that
    slot's id in the numpy array; a view pinned before keeps the old id."""
    _, pms = _pair(fitted, "star")
    fact = pms.schema.table("fact")
    slot = 0
    pms.apply([TableDelta("fact", deletes=np.asarray([slot]))])
    view = pms.state.snapshot(["dim0"])
    old = view.jt("dim0").edges[-1].child_seg.ids.clone()
    key = int(fact.col("k0")[slot])
    new_key = (key + 1) % int(pms.schema.table("dim0").n_rows)
    row = {c: (np.asarray([new_key], fact.col(c).dtype) if c == "k0"
               else np.asarray(fact.col(c)[:1])) for c in fact.columns}
    pms.apply([TableDelta("fact", inserts=row)])                       # reuses slot 0
    de = pms.state.edges[frozenset(("fact", "dim0"))]
    assert de.ids["fact"][slot] != old[slot]
    assert torch.equal(view.jt("dim0").edges[-1].child_seg.ids, old)


def test_assign_ids_is_the_sequential_setdefault_loop():
    rng = np.random.default_rng(0)
    for n_cols in (1, 2, 3):
        ref_d, got_d = {(7,) * n_cols: 0}, {(7,) * n_cols: 0}
        for _ in range(3):
            cols = [rng.integers(0, 6, 200) for _ in range(n_cols)]
            want = np.asarray([ref_d.setdefault(k, len(ref_d)) for k in zip(*cols)])
            np.testing.assert_array_equal(assign_ids(got_d, cols), want)
            assert ref_d == got_d and list(ref_d) == list(got_d)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_dynamic_edge_and_table_match_reference(fitted, fixture):
    rs = fitted(fixture)[0]
    for a, b, key in rs._undirected_edges:
        rta, rtb = RDynamicTable(rs.table(a)), RDynamicTable(rs.table(b))
        pta, ptb = DynamicTable(rs.table(a)), DynamicTable(rs.table(b))
        re, pe = RDynamicEdge(rta, rtb, key), DynamicEdge(pta, ptb, key)
        assert re.key_to_id == pe.key_to_id and list(re.key_to_id) == list(pe.key_to_id)
        for t in (a, b):
            np.testing.assert_array_equal(re.ids[t], pe.ids[t])
            assert re.ids[t].dtype == pe.ids[t].dtype


@pytest.mark.parametrize("fixture", FIXTURES)
def test_stream_generators_match_reference(fitted, fixture):
    rs, ps = fitted(fixture)[:2]
    rt = RDynamicTable

    def same(xs, ys):
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            assert x.table == y.table
            for u, v in ((x.inserts, y.inserts), (x.updates and x.updates[1],
                                                  y.updates and y.updates[1])):
                assert (u is None) == (v is None)
                if u is not None:
                    assert list(u) == list(v)
                    for c in u:
                        np.testing.assert_array_equal(u[c], v[c])
            for u, v in ((x.deletes, y.deletes), (x.updates and x.updates[0],
                                                  y.updates and y.updates[0])):
                assert (u is None) == (v is None)
                if u is not None:
                    np.testing.assert_array_equal(u, v)

    live = {t.name: rt(t).live_slots() for t in rs.tables}
    for gen, rgen, kw in ((delta_stream, rdelta_stream, dict(n_batches=3, ops_per_batch=9)),
                          (drift_stream, rdrift_stream, dict(n_batches=3))):
        got = list(gen(ps, live.__getitem__, seed=4, **kw))
        want = list(rgen(rs, live.__getitem__, seed=4, **kw))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            same(g, w)
