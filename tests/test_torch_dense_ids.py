"""Dense ids of the port against the JAX package where keys hold NaN.

The reference numbers projections with ``np.unique(proj, axis=0)``
(``src/repro/core/schema.py:159``), which gives every NaN row an id of
its own, and maintained projections with ``dict.setdefault`` over
tuples of numpy scalars (``src/repro/incremental/retrain.py:144-148``),
under which a NaN key equals no stored key.  Held here:

- ``dense_ids`` against that unique on seeded one- and two-column inputs
  holding NaN, ±inf and ±0 (exact);
- ``Schema.w_ids`` / ``domain_sizes`` against the reference's on a star
  whose dimension features hold them (exact);
- ``assign_ids`` against the ``setdefault`` loop, fresh and with keys
  already stored (exact);
- sketch fits on a star with three NaN rows in dim0's one owned
  feature, sharing the reference's hashes: ``node_ssr`` within the
  boosting tests' rtol 1e-4 of the reference's.
"""
import numpy as np
import pytest

import repro.core.schema as RS
from repro.core import BoostConfig as RConfig, Booster as RBooster
from repro.relational.generators import star_schema as rstar

from repro_torch import convert
from repro_torch.core import BoostConfig, Booster
from repro_torch.core.schema import dense_ids
from repro_torch.incremental.deltas import assign_ids

SPECIALS = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -2.0], np.float32)


def _draw(rng, n, n_cols):
    """n rows of n_cols float32 columns drawn from SPECIALS (collisions
    on purpose), a few plain normals among them."""
    cols = []
    for _ in range(n_cols):
        c = SPECIALS[rng.integers(0, len(SPECIALS), n)]
        plain = rng.random(n) < 0.2
        c[plain] = rng.standard_normal(int(plain.sum())).astype(np.float32)
        cols.append(c)
    return cols


def _setdefault_ids(key_to_id, cols):
    """The reference's maintained projection ids (retrain.py:144-148)."""
    return np.array([key_to_id.setdefault(tuple(c[s] for c in cols), len(key_to_id))
                     for s in range(len(cols[0]))], np.int64)


@pytest.mark.parametrize("n_cols", [1, 2])
def test_dense_ids_number_nan_rows_as_the_row_wise_unique(n_cols):
    rng = np.random.default_rng(n_cols)
    for _ in range(100):
        cols = _draw(rng, int(rng.integers(1, 40)), n_cols)
        want = np.unique(np.stack(cols, 1), axis=0, return_inverse=True)[1].reshape(-1)
        np.testing.assert_array_equal(dense_ids(cols), want)


def test_dense_ids_without_nan_keep_the_fast_branches_numbering():
    rng = np.random.default_rng(7)
    for n_cols in (1, 2, 3):
        cols = [rng.integers(-3, 3, 50).astype(np.float32) for _ in range(n_cols)]
        cols[0][:3] = [np.inf, -0.0, 0.0]
        want = np.unique(np.stack(cols, 1), axis=0, return_inverse=True)[1].reshape(-1)
        np.testing.assert_array_equal(dense_ids(cols), want)


def _nan_star(feats_per_dim, seed=0):
    """The reference's star with NaN, ±inf and ±0 in dim0's owned
    features (one column for feats_per_dim 1, two for 2)."""
    rs = rstar(seed=seed, n_fact=200, n_dim=12, feats_per_dim=feats_per_dim)
    tabs = []
    for t in rs.tables:
        cols = {c: np.array(v) for c, v in t.columns.items()}
        if t.name == "dim0":
            cols["d0f0"][[1, 4, 7]] = np.nan
            cols["d0f0"][[2, 5]] = [np.inf, -0.0]
            cols["d0f0"][[3, 6]] = [-np.inf, 0.0]
            if feats_per_dim == 2:
                cols["d0f1"][[1, 4, 8]] = [2.0, 2.0, np.nan]
        tabs.append(RS.Table(t.name, cols, feature_columns=tuple(t.feature_columns)))
    return RS.Schema(tabs, label=(rs.label_table, rs.label_column))


@pytest.mark.parametrize("feats_per_dim", [1, 2])
def test_schema_w_ids_and_domain_sizes_match_the_reference(feats_per_dim):
    rs = _nan_star(feats_per_dim)
    ps = convert.schema(rs, device="cpu")
    assert ps.domain_sizes == rs.domain_sizes
    for name in rs.w_ids:
        np.testing.assert_array_equal(ps.w_ids[name].numpy(), np.asarray(rs.w_ids[name]))


@pytest.mark.parametrize("n_cols", [1, 2])
def test_assign_ids_match_setdefault(n_cols):
    rng = np.random.default_rng(10 + n_cols)
    port, ref = {}, {}
    for _ in range(20):                       # later batches meet stored keys
        cols = _draw(rng, int(rng.integers(1, 30)), n_cols)
        np.testing.assert_array_equal(assign_ids(port, cols), _setdefault_ids(ref, cols))
        assert len(port) == len(ref)


@pytest.fixture(scope="module")
def nan_fits():
    """Sketch fits of 2 trees x depth 3 on ROADMAP §3's NaN star, in both
    domains, the port sharing the reference's hashes."""
    rs = _nan_star(1)
    ps = convert.schema(rs, device="cpu")
    out = {}
    for domain, k in (("freq", 256), ("coeff", 64)):
        rb = RBooster(rs, RConfig(n_trees=2, depth=3, mode="sketch", sketch_k=k,
                                  sketch_domain=domain))
        pb = Booster(ps, BoostConfig(n_trees=2, depth=3, mode="sketch", sketch_k=k,
                                     sketch_domain=domain),
                     hashes=convert.table_hashes(rb.hashes))
        out[domain] = (rb.fit(), pb.fit())
    return out


@pytest.mark.parametrize("domain", ["freq", "coeff"])
def test_sketch_ssr_with_nan_rows_matches_reference(nan_fits, domain):
    (rt, rtr), (pt, ptr) = nan_fits[domain]
    assert ptr.queries == rtr.queries
    for p, r in zip(pt, rt):
        np.testing.assert_array_equal(p.feat.numpy(), np.asarray(r.feat))
    assert len(ptr.node_ssr) == len(rtr.node_ssr)
    for p, r in zip(ptr.node_ssr, rtr.node_ssr):
        for tn in r:
            np.testing.assert_allclose(p[tn].numpy(), np.asarray(r[tn]), rtol=1e-4,
                                       atol=1e-3)
