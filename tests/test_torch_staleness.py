"""Staleness and the full-recompute baseline of the port's maintained
scorer and incremental booster, against the JAX package's: the same trees
over the same tables take the same delta batches; ``staleness_s`` is
positive exactly where the reference's is (per root, aggregated over the
served roots, and for the booster), a catch-up observes one
``ivm.refresh_lag_s`` each and zeroes the ``ivm.staleness_s`` gauge in
both; ``score_full`` re-emits every edge over the maintained state without
touching a cached message, its counts equal to the reference's exactly
and its totals to rtol 1e-5 (atol 1e-4 near zero: the reference
contracts with a matrix product), and bit-equal to the port's own
maintained scores (the same integer counts through ``compile.contract``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BoostConfig as RConfig, QueryCounter as RCounter
from repro.core.tree import TreeArrays as RTree
from repro.incremental import IncrementalBooster as RIncremental, MaintainedScorer as RScorer
from repro.obs import get_registry as rget_registry
from repro.relational.generators import delta_stream as rdelta_stream
from repro.relational.generators import drift_stream as rdrift_stream
from repro.serving import compile_ensemble as rcompile

from repro_torch import convert
from repro_torch.core import BoostConfig, Booster, QueryCounter
from repro_torch.incremental import IncrementalBooster, MaintainedScorer, TableDelta
from repro_torch.obs import get_registry
from repro_torch.serving import compile_ensemble

ROOTS = ("fact", "dim0")


@pytest.fixture(scope="module")
def pair_factory(star):
    rs = star[0]
    ps = convert.schema(rs, device="cpu")
    trees, _ = Booster(ps, BoostConfig(n_trees=2, depth=2, mode="sketch", ssr_mode="off")).fit()
    rtrees = [RTree(feat=jnp.asarray(t.feat.numpy()), thr=jnp.asarray(t.thr.numpy()),
                    leaf=jnp.asarray(t.leaf.numpy())) for t in trees]

    def make(**kw):
        return (RScorer(rcompile(rs, rtrees), counter=RCounter(), **kw),
                MaintainedScorer(compile_ensemble(ps, trees), counter=QueryCounter(), **kw))
    return rs, make


def _port(batch):
    return [TableDelta(table=d.table, inserts=d.inserts, deletes=d.deletes, updates=d.updates)
            for d in batch]


def _lags():
    """refresh-lag observations so far, (port's, reference's)."""
    return tuple(r.snapshot().get("ivm.refresh_lag_s", {"count": 0})["count"]
                 for r in (get_registry(), rget_registry()))


def test_staleness_lifecycle_matches_reference(pair_factory):
    rs, make = pair_factory
    rms, pms = make()
    for m in (rms, pms):
        m.grouped_cached("fact")                  # only fact is served
    for batch in rdelta_stream(rs, rms.live_rows, seed=12, n_batches=3, ops_per_batch=2):
        assert rms.apply(batch) == pms.apply(_port(batch))
        for m in (rms, pms):
            assert m.staleness_s("dim0") == 0.0           # never cached, never stale
            assert m.staleness_s("fact") > 0.0 and m.staleness_s() > 0.0
        lag0 = _lags()
        for m in (rms, pms):
            m.grouped_cached("fact")
            assert m.staleness_s("fact") == 0.0 and m.staleness_s() == 0.0
        assert [b - a for a, b in zip(lag0, _lags())] == [1, 1]
        assert get_registry().gauge("ivm.staleness_s").value == 0.0


@pytest.mark.parametrize("window", [30.0, 0.0])
def test_aggregate_staleness_counts_only_served_roots(pair_factory, window):
    """With a served window of 0 s no root counts as served, so the
    aggregate reads 0 while each root's own lag is positive."""
    rs, make = pair_factory
    rms, pms = make(served_window_s=window)
    for m in (rms, pms):
        for r in ROOTS:
            m.grouped_cached(r)
    batch = next(iter(rdelta_stream(rs, rms.live_rows, seed=13, n_batches=1, ops_per_batch=3)))
    rms.apply(batch)
    pms.apply(_port(batch))
    for m in (rms, pms):
        assert all(m.staleness_s(r) > 0.0 for r in ROOTS)
        assert (m.staleness_s() > 0.0) is (window > 0.0)


def test_score_full_matches_reference_and_leaves_the_cache_alone(pair_factory):
    rs, make = pair_factory
    rms, pms = make()
    for m in (rms, pms):
        for r in ROOTS:
            m.grouped_cached(r)
    for batch in rdelta_stream(rs, rms.live_rows, seed=14, n_batches=2, ops_per_batch=3):
        rms.apply(batch)
        pms.apply(_port(batch))
        for r in ROOTS:
            msgs, dirty = list(pms._msgs[r]), set(pms._dirty.get(r, ()))
            e0 = pms.counter.edges
            tot, cnt = pms.score_full(r)
            assert pms.counter.edges - e0 == len(rs.join_tree(r).edges)
            assert all(a is b for a, b in zip(pms._msgs[r], msgs)) and pms._dirty[r] == dirty
            rtot, rcnt = (np.asarray(a) for a in rms.score_full(r))
            np.testing.assert_array_equal(cnt.numpy(), rcnt)
            np.testing.assert_allclose(tot.numpy(), rtot, rtol=1e-5, atol=1e-4)
            mtot, mcnt = pms.grouped_cached(r)
            assert torch.equal(tot, mtot) and torch.equal(cnt, mcnt)


def test_incremental_booster_staleness_matches_reference(chain):
    rs = chain[0]
    cfg = dict(n_trees=1, depth=2, mode="sketch", ssr_mode="off")
    rib = RIncremental(rs, RConfig(**cfg))
    pib = IncrementalBooster(convert.schema(rs, device="cpu"), BoostConfig(**cfg),
                             hashes=convert.table_hashes(rib.booster.hashes))
    for ib in (rib, pib):
        ib.fit()
        assert ib.staleness_s() == 0.0
    for batch in rdrift_stream(rs, rib.live_rows, seed=5, n_batches=2, rows_per_batch=8):
        rib.apply(batch)
        pib.apply(_port(batch))
        for ib in (rib, pib):
            assert ib.staleness_s() > 0.0 and ib.staleness_s("ignored root") > 0.0
            ib.refit(n_new_trees=1, drift_threshold=np.inf)     # the drift check consumes it
            assert ib.staleness_s() == 0.0
    reg = get_registry().snapshot()
    assert reg["retrain.staleness_s"]["value"] == 0.0 and reg["retrain.delta_lag_s"]["count"] >= 2
