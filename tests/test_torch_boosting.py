"""Boosting of the port against the JAX package (paper Algorithms 1–3).

- Exact mode on star/chain/snowflake: ``feat``/``thr`` identical, ``leaf``
  within atol 1e-5, ``trace.queries`` and ``counter.edges`` equal.
- Sketch mode in both domains with the reference's hash constants
  carried across: ``node_ssr`` within rtol 1e-4 of the reference's, and
  the trees equal to the exact-mode trees.
- The materialized baseline: predictions within atol 1e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import (BoostConfig as RConfig, Booster as RBooster,
                        MaterializedBooster as RMaterialized, predict_rows as rpredict)

from repro_torch import convert
from repro_torch.core import BoostConfig, Booster, MaterializedBooster, predict_rows

SIZES = {"star": (3, 3), "chain": (2, 2), "snowflake": (2, 3)}   # (n_trees, depth)


def _cfg(cls, fixture, **kw):
    n_trees, depth = SIZES[fixture]
    return cls(n_trees=n_trees, depth=depth, **kw)


def _same_trees(port_trees, ref_trees, leaf_atol=1e-5):
    assert len(port_trees) == len(ref_trees)
    for p, r in zip(port_trees, ref_trees):
        np.testing.assert_array_equal(p.feat.numpy(), np.asarray(r.feat))
        np.testing.assert_array_equal(p.thr.numpy(), np.asarray(r.thr))
        np.testing.assert_allclose(p.leaf.numpy(), np.asarray(r.leaf), atol=leaf_atol)


@pytest.fixture(scope="module")
def exact(request):
    """Per fixture: (ref schema, port schema, ref fit, port fit, boosters)."""
    cache = {}

    def get(name):
        if name not in cache:
            rs = request.getfixturevalue(name)[0]
            ps = convert.schema(rs, device="cpu")
            rb = RBooster(rs, _cfg(RConfig, name, mode="exact"))
            pb = Booster(ps, _cfg(BoostConfig, name, mode="exact"))
            cache[name] = (rs, ps, rb.fit(), pb.fit(), rb, pb)
        return cache[name]
    return get


@pytest.mark.parametrize("fixture", ["star", "chain", "snowflake"])
def test_exact_trees_identical(exact, fixture):
    rs, ps, (rt, rtr), (pt, ptr), rb, pb = exact(fixture)
    _same_trees(pt, rt)
    assert ptr.queries == rtr.queries
    assert pb.counter.count == rb.counter.count
    assert pb.counter.edges == rb.counter.edges


@pytest.mark.parametrize("fixture", ["star", "chain", "snowflake"])
def test_exact_node_stats_match(exact, fixture):
    rs, ps, (rt, rtr), (pt, ptr), rb, pb = exact(fixture)
    assert len(ptr.node_ssr) == len(rtr.node_ssr)
    for p, r in zip(ptr.node_ssr, rtr.node_ssr):
        assert set(p) == set(r)
        for tn in r:
            np.testing.assert_allclose(p[tn].numpy(), np.asarray(r[tn]), rtol=1e-4, atol=1e-3)
    for p, r in zip(ptr.node_counts, rtr.node_counts):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.fixture(scope="module")
def sketched(request, exact):
    """Sketch-mode fits (2 trees, depth 3) on star in both domains,
    sharing the reference's hash constants."""
    rs, ps = exact("star")[:2]
    out = {}
    for domain, k in (("freq", 256), ("coeff", 64)):
        rb = RBooster(rs, RConfig(n_trees=2, depth=3, mode="sketch", sketch_k=k,
                                  sketch_domain=domain))
        pb = Booster(ps, BoostConfig(n_trees=2, depth=3, mode="sketch", sketch_k=k,
                                     sketch_domain=domain),
                     hashes=convert.table_hashes(rb.hashes))
        out[domain] = (rb.fit(), pb.fit(), rb, pb)
    return out


@pytest.mark.parametrize("domain", ["freq", "coeff"])
def test_sketch_ssr_matches_reference(sketched, domain):
    (rt, rtr), (pt, ptr), rb, pb = sketched[domain]
    assert ptr.queries == rtr.queries and pb.counter.edges == rb.counter.edges
    for p, r in zip(ptr.node_ssr, rtr.node_ssr):
        for tn in r:
            np.testing.assert_allclose(p[tn].numpy(), np.asarray(r[tn]), rtol=1e-4,
                                       atol=1e-3)


@pytest.mark.parametrize("domain", ["freq", "coeff"])
def test_sketch_trees_equal_exact_trees(exact, sketched, domain):
    pt_exact = exact("star")[3][0]
    (rt, _), (pt, _), _, _ = sketched[domain]
    _same_trees(pt, pt_exact[:len(pt)], leaf_atol=1e-4)     # boosting is sequential
    _same_trees(pt, rt, leaf_atol=1e-5)


def test_sketch_hashes_match_reference(exact):
    """The carried-across hash constants give the reference's buckets and
    signs (uint32 wraparound reproduced in int64)."""
    from repro.core.sketch import TableHashes as RHashes
    import jax

    rs, ps = exact("star")[:2]
    rh = RHashes.make(jax.random.PRNGKey(11), rs, 256)
    ph = convert.table_hashes(rh)
    x = np.arange(0, 5000, 7)
    for name, h in rh.hashes.items():
        p = ph.hashes[name]
        np.testing.assert_array_equal(p.bucket(torch.from_numpy(x)).numpy(),
                                      np.asarray(h.bucket(jnp.asarray(x))))
        np.testing.assert_array_equal(p.sign(torch.from_numpy(x)).numpy(),
                                      np.asarray(h.sign(jnp.asarray(x))))


@pytest.mark.parametrize("fixture", ["star", "chain"])
def test_materialized_baseline(request, fixture):
    rs, J, X, y = request.getfixturevalue(fixture)
    cfg_r = RConfig(n_trees=2, depth=3, mode="exact")
    cfg_p = BoostConfig(n_trees=2, depth=3, mode="exact")
    rt = RMaterialized(X, y, cfg_r).fit()
    Xp, yp = torch.from_numpy(np.array(X)), torch.from_numpy(np.array(y))
    pt = MaterializedBooster(Xp, yp, cfg_p).fit()
    np.testing.assert_allclose(predict_rows(pt, Xp).numpy(), np.asarray(rpredict(rt, X)),
                               atol=1e-5)
    # and the port's relational trees agree with the port's baseline
    ps = convert.schema(rs, device="cpu")
    rel, _ = Booster(ps, cfg_p).fit()
    np.testing.assert_allclose(predict_rows(rel, Xp).numpy(), predict_rows(pt, Xp).numpy(),
                               atol=2e-2)


def test_config_guards(exact):
    ps = exact("chain")[1]
    from repro_torch.core import TableHistPlan
    hist = Booster(ps, BoostConfig(split_mode="hist"))       # ported: no longer raises
    assert hist.plans and all(isinstance(p, TableHistPlan) for p in hist.plans.values())
    with pytest.raises(ValueError, match="split_mode"):
        Booster(ps, BoostConfig(split_mode="histo"))
    with pytest.raises(ValueError, match="hist_route"):
        Booster(ps, BoostConfig(split_mode="hist", hist_route="onehot"))
    with pytest.raises(ValueError):
        Booster(ps, BoostConfig(mode="approximate"))
    if not torch.cuda.is_available():        # no silent fallback to the host
        with pytest.raises(RuntimeError, match="cuda"):
            convert.schema(exact("chain")[0], device="cuda")
