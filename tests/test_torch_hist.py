"""Histogram split mode of the port against the JAX package (core/hist.py).

- ``quantile_cuts``, ``bin_values`` and ``_padded_bin_rows`` are
  bit-identical to the reference's on the fixtures' columns and on a
  skewed column; ``build_hist_plans`` gives the same cuts, bins and
  resolved route for every table.
- ``hist_scores`` on the gather and scatter routes against the
  reference's on the same (K, rows) stats: counts exact, sums within
  rtol 2e-4 (the reference's own route-agreement tolerance), including
  dead +inf slots in the invalid bin.
- ``Booster(split_mode="hist")`` against the reference's with the same
  hash constants: ``feat``/``thr`` identical, leaves within atol 1e-5,
  ``trace.queries`` and ``counter.edges`` equal; on a low-cardinality
  schema the trees also equal exact mode's, and on the continuous star
  the quality stays within 5 % of var(y) of the exact sweep.
- ``refresh_hist_plans`` after a row change: edges frozen under
  ``edge_tol``, re-quantized past it, as in the reference.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import (BoostConfig as RConfig, Booster as RBooster, Schema as RSchema,
                        Table as RTable)
from repro.core import hist as rhist

from repro_torch import convert
from repro_torch.core import BoostConfig, Booster, materialize_join, predict_rows
from repro_torch.core import hist as phist

BASE = dict(mode="sketch", ssr_mode="off")


def _discrete_schema(seed=7, n=200, n_vals=13):
    """Low-cardinality float features: every distinct value fits in a
    small bin budget, where hist must equal exact (as in test_hist.py)."""
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(0, 10, n).astype(np.int64)}
    for f in range(3):
        cols[f"x{f}"] = rng.choice(np.linspace(-2, 2, n_vals), n).astype(np.float32)
    cols["y"] = (cols["x0"] + np.where(cols["x1"] >= 0, 2.0, -1.0)
                 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    dim = {"k": np.arange(10, dtype=np.int64),
           "d0": rng.choice(np.linspace(-1, 1, 7), 10).astype(np.float32)}
    return RSchema([RTable("fact", cols, feature_columns=("x0", "x1", "x2")),
                    RTable("dim", dim, feature_columns=("d0",))], label=("fact", "y"))


def _skewed_schema(seed=13, n=400):
    """One fact column whose single value owns 80 % of the rows: its bin
    cannot be split, the padded row lists blow past 4× n, and "auto"
    resolves to the segment-⊕ route."""
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal(n).astype(np.float32)
    x0[rng.random(n) < 0.8] = 0.5
    cols = {"k": rng.integers(0, 8, n).astype(np.int64), "x0": x0,
            "x1": rng.standard_normal(n).astype(np.float32)}
    cols["y"] = (np.where(x0 > 0.6, 1.0, -1.0) + cols["x1"]).astype(np.float32)
    dim = {"k": np.arange(8, dtype=np.int64),
           "d0": rng.standard_normal(8).astype(np.float32)}
    return RSchema([RTable("fact", cols, feature_columns=("x0", "x1")),
                    RTable("dim", dim, feature_columns=("d0",))], label=("fact", "y"))


@pytest.fixture(scope="module")
def schemas(request):
    """name → (reference schema, port schema on the CPU)."""
    cache = {}

    def get(name):
        if name not in cache:
            if name == "discrete":
                rs = _discrete_schema()
            elif name == "skewed":
                rs = _skewed_schema()
            else:
                rs = request.getfixturevalue(name)[0]
            cache[name] = (rs, convert.schema(rs, device="cpu"))
        return cache[name]
    return get


def _featmats(rs):
    return [np.asarray(rs.featmat[t.name]) for t in rs.tables
            if np.asarray(rs.featmat[t.name]).shape[1]]


# ------------------------------------------------------------ numpy parts --

@pytest.mark.parametrize("name", ["star", "chain", "snowflake", "discrete", "skewed"])
@pytest.mark.parametrize("B", [4, 16, 256])
def test_cuts_bins_and_row_lists_bit_identical(schemas, name, B):
    rs, _ = schemas(name)
    for fm in _featmats(rs):
        fm = np.concatenate([fm, np.full((5, fm.shape[1]), np.inf, np.float32)])  # dead slots
        bins = []
        for col in fm.T:
            rc, pc = rhist.quantile_cuts(col, B), phist.quantile_cuts(col, B)
            assert pc.dtype == rc.dtype and pc.tobytes() == rc.tobytes()
            rb, pb = rhist.bin_values(rc, col, B), phist.bin_values(pc, col, B)
            assert pb.dtype == rb.dtype and np.array_equal(pb, rb)
            bins.append(rb)
        bins = np.stack(bins)
        assert np.array_equal(phist._padded_bin_rows(bins, B),
                              rhist._padded_bin_rows(bins, B))


@pytest.mark.parametrize("name", ["star", "chain", "snowflake", "skewed"])
def test_build_hist_plans_match_reference(schemas, name):
    rs, ps = schemas(name)
    rp, pp = rhist.build_hist_plans(rs, n_bins=32), phist.build_hist_plans(ps, n_bins=32)
    assert list(pp) == list(rp)
    for tn in rp:
        r, p = rp[tn], pp[tn]
        assert p.cuts.tobytes() == r.cuts.tobytes()
        assert np.array_equal(p.n_cuts, r.n_cuts) and np.array_equal(p.bins, r.bins)
        assert np.array_equal(p.global_ids.numpy(), np.asarray(r.global_ids))
        assert p.device()[0] == r.device()[0]
    if name == "skewed":
        assert pp["fact"].device()[0] == "scatter"


# -------------------------------------------------------------- the sweep --

def _stats(rng, K, rows):
    n = (rng.random((K, rows)) < 0.8).astype(np.float32) * rng.integers(1, 4, (K, rows))
    s = rng.standard_normal((K, rows)).astype(np.float32) * (n > 0)
    return n.astype(np.float32), s


def _same_scores(p_parts, r_parts):
    score, thr, sl, nl, sr, nr = (x.numpy() for x in p_parts)
    rscore, rthr, rsl, rnl, rsr, rnr = (np.asarray(x) for x in r_parts)
    np.testing.assert_array_equal(nl, rnl)              # counts: exact
    np.testing.assert_array_equal(nr, rnr)
    np.testing.assert_array_equal(thr, rthr)
    for a, b in ((score, rscore), (sl, rsl), (sr, rsr)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("route", ["gather", "scatter"])
@pytest.mark.parametrize("name", ["star", "snowflake", "skewed"])
def test_hist_scores_match_reference(schemas, name, route):
    rs, ps = schemas(name)
    rp, pp = rhist.build_hist_plans(rs, n_bins=32), phist.build_hist_plans(ps, n_bins=32)
    rng = np.random.default_rng(3)
    for tn in rp:
        n, s = _stats(rng, 4, rp[tn].n_rows)
        rn, rs_ = jnp.asarray(n), jnp.asarray(s)
        pn, ps_ = torch.from_numpy(n), torch.from_numpy(s)
        r = rhist.hist_scores(rp[tn], rn, rs_, rn.sum(1), rs_.sum(1), route=route)
        p = phist.hist_scores(pp[tn], pn, ps_, pn.sum(1), ps_.sum(1), route=route)
        _same_scores(p, r)


@pytest.mark.parametrize("route", ["gather", "scatter"])
def test_dead_slots_bin_invalid_and_never_thresholds(schemas, route):
    """+inf capacity slots land in the invalid bin, stay out of the
    edges, and the sweep over ALL slots gives the reference's finite
    thresholds (the dead-slot case of test_hist.py)."""
    rs, ps = schemas("discrete")
    rfm, pfm = {}, {}
    for t in rs.tables:
        fm = np.asarray(rs.featmat[t.name]).copy()
        fm = np.concatenate([fm, np.full((7, fm.shape[1]), np.inf, np.float32)])
        rfm[t.name], pfm[t.name] = fm, torch.from_numpy(fm)
    rp = rhist.build_hist_plans(rs, featmats=rfm, n_bins=16)
    pp = phist.build_hist_plans(ps, featmats=pfm, n_bins=16)
    for tn, plan in pp.items():
        assert (plan.bins[:, -7:] == plan.n_bins).all()
        assert np.isfinite(plan.cuts[plan.cuts < np.inf]).all()
        rows = plan.n_rows
        n = np.ones((2, rows), np.float32)
        s = np.tile(np.linspace(-1, 1, rows, dtype=np.float32), (2, 1))
        pn, ps_ = torch.from_numpy(n), torch.from_numpy(s)
        rn, rs_ = jnp.asarray(n), jnp.asarray(s)
        p = phist.hist_scores(plan, pn, ps_, pn.sum(1), ps_.sum(1), route=route)
        r = rhist.hist_scores(rp[tn], rn, rs_, rn.sum(1), rs_.sum(1), route=route)
        assert np.isfinite(p[1].numpy()).all(), tn
        _same_scores(p, r)


# ---------------------------------------------------------------- boosting --

def _same_trees(port_trees, ref_trees, leaf_atol=1e-5):
    assert len(port_trees) == len(ref_trees)
    for p, r in zip(port_trees, ref_trees):
        np.testing.assert_array_equal(p.feat.numpy(), np.asarray(r.feat))
        np.testing.assert_array_equal(p.thr.numpy(), np.asarray(r.thr))
        np.testing.assert_allclose(p.leaf.numpy(), np.asarray(r.leaf), atol=leaf_atol)


FITS = {   # name → (n_trees, depth, hist_bins)
    "discrete": (3, 3, 16),
    "star": (3, 2, 32),
}


@pytest.fixture(scope="module")
def hist_fits(schemas):
    """name → (ref fit, port fit, ref booster, port booster, port exact trees)."""
    cache = {}

    def get(name):
        if name not in cache:
            rs, ps = schemas(name)
            n_trees, depth, B = FITS[name]
            kw = dict(n_trees=n_trees, depth=depth, **BASE)
            rb = RBooster(rs, RConfig(**kw, split_mode="hist", hist_bins=B))
            pb = Booster(ps, BoostConfig(**kw, split_mode="hist", hist_bins=B),
                         hashes=convert.table_hashes(rb.hashes))
            exact, _ = Booster(ps, BoostConfig(**kw)).fit()
            cache[name] = (rb.fit(), pb.fit(), rb, pb, exact)
        return cache[name]
    return get


@pytest.mark.parametrize("name", ["discrete", "star"])
def test_hist_booster_matches_reference(hist_fits, name):
    (rt, rtr), (pt, ptr), rb, pb, _ = hist_fits(name)
    _same_trees(pt, rt)
    assert ptr.queries == rtr.queries
    assert pb.counter.count == rb.counter.count
    assert pb.counter.edges == rb.counter.edges


def test_hist_degenerates_to_exact_when_bins_cover_distinct(hist_fits):
    (_, _), (pt, _), _, _, exact = hist_fits("discrete")
    _same_trees(pt, exact, leaf_atol=1e-4)


def test_hist_quality_parity_on_continuous_star(schemas, hist_fits):
    (_, _), (pt, _), _, _, exact = hist_fits("star")
    ps = schemas("star")[1]
    J = materialize_join(ps)
    X = torch.stack([J[c].to(torch.float32) for (_, c) in ps.features], dim=1)
    y = J[ps.label_column].double()
    mse_e = float(torch.mean((y - predict_rows(exact, X).double()) ** 2))
    mse_h = float(torch.mean((y - predict_rows(pt, X).double()) ** 2))
    var = float(torch.var(y, unbiased=False))
    assert (mse_h - mse_e) / var <= 0.05, (mse_h, mse_e, var)
    assert mse_h < 0.5 * var


@pytest.mark.parametrize("route", ["scatter", "kernel"])
def test_hist_segment_routes_give_the_same_trees(schemas, hist_fits, route):
    """The segment-⊕ routes (the kernel's route on the card) train the
    same trees as the gather route the fixture resolved to."""
    (_, _), (pt, _), _, pb, _ = hist_fits("star")
    ps = schemas("star")[1]
    n_trees, depth, B = FITS["star"]
    other = Booster(ps, BoostConfig(n_trees=n_trees, depth=depth, **BASE, split_mode="hist",
                                    hist_bins=B, hist_route=route), hashes=pb.hashes)
    assert all(p.device()[0] == route for p in other.plans.values())
    _same_trees(other.fit()[0], pt, leaf_atol=1e-5)


# ------------------------------------------------------------ maintenance --

@pytest.mark.parametrize("edge_tol,requantized", [(0.25, False), (0.0, True)])
def test_refresh_hist_plans_matches_reference(schemas, edge_tol, requantized):
    rs, ps = schemas("star")
    rp, pp = rhist.build_hist_plans(rs, n_bins=32), phist.build_hist_plans(ps, n_bins=32)
    fm = np.asarray(rs.featmat["fact"]).copy()
    rng = np.random.default_rng(5)
    rows = rng.choice(len(fm), 20, replace=False)
    fm[rows] = rng.standard_normal((20, fm.shape[1])).astype(np.float32) * 3
    fm[rows[:3]] = np.inf                                 # three rows die
    dirty = {"fact": (rows, fm[rows])}
    kw = dict(n_rows_fn=lambda t: len(fm), featmat_fn=lambda t: fm, n_bins=32,
              edge_tol=edge_tol)
    r2 = rhist.refresh_hist_plans(rp, dirty, **kw)
    p2 = phist.refresh_hist_plans(pp, dirty, **kw)
    assert (p2["fact"] is not pp["fact"]) == requantized
    assert (r2["fact"] is not rp["fact"]) == requantized
    for tn in r2:
        assert p2[tn].cuts.tobytes() == r2[tn].cuts.tobytes()
        assert np.array_equal(p2[tn].bins, r2[tn].bins)
        assert p2[tn].rebinned_since_edges == r2[tn].rebinned_since_edges
    assert (p2["fact"].bins[:, rows[:3]] == 32).all()
    if not requantized:                                   # frozen edges
        assert p2["fact"].cuts.tobytes() == pp["fact"].cuts.tobytes()
    else:
        assert p2["fact"].cuts.tobytes() != pp["fact"].cuts.tobytes()
    # the route's artifacts follow the new bins
    n, s = _stats(rng, 2, len(fm))
    pn, ps_ = torch.from_numpy(n), torch.from_numpy(s)
    g = phist.hist_scores(p2["fact"], pn, ps_, pn.sum(1), ps_.sum(1), route="gather")
    sc = phist.hist_scores(p2["fact"], pn, ps_, pn.sum(1), ps_.sum(1), route="scatter")
    for a, b in zip(g, sc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)


def test_booster_refresh_plans(schemas):
    """``Booster.refresh_plans(dirty)`` re-bins in hist mode and rebuilds
    in exact mode."""
    rs, ps = schemas("star")
    pb = Booster(ps, BoostConfig(n_trees=1, depth=2, **BASE, split_mode="hist",
                                 hist_bins=32))
    fm = ps.featmat["fact"].numpy()
    rows = np.arange(4)
    before = pb.plans["fact"]
    pb.refresh_plans({"fact": (rows, fm[rows] + 0.25)})
    assert pb.plans["fact"] is before and before.rebinned_since_edges == 4
    want = phist.bin_values(before.cuts[0, :before.n_cuts[0]], fm[rows, 0] + 0.25, 32)
    assert np.array_equal(before.bins[0, rows], want)
    pb.refresh_plans()                                     # no rows named: rebuild
    assert pb.plans["fact"] is not before
    assert pb.plans["fact"].bins.tobytes() == phist.build_hist_plans(
        ps, n_bins=32)["fact"].bins.tobytes()
