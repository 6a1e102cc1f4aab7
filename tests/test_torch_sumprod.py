"""SumProd of the port against the JAX package on the star, chain and
snowflake fixtures: grouped Channels(3) queries by every root, query and
edge counts, the Tropical and Boolean semirings, the message-pass
variants, and ``materialize_join``.

Tolerances: counts and Boolean/Tropical results exact; Σy and Σy² rtol
1e-5 (float sums in another order)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import (Arithmetic as RArith, BooleanSR as RBool, Channels as RC,
                        QueryCounter as RCounter, SumProd as RSP, Tropical as RTrop,
                        materialize_join as rmaterialize, refresh_plan as rrefresh_plan)

from repro_torch import convert
from repro_torch.core import (Arithmetic, BooleanSR, Channels, MessageCache, QueryCounter,
                              SumProd, Tropical, materialize_join, refresh_plan)

FIXTURES = ["star", "chain", "snowflake"]


@pytest.fixture(scope="module")
def pair(request):
    """(reference schema, port schema on the CPU) per fixture name."""
    cache = {}

    def get(name):
        if name not in cache:
            rs = request.getfixturevalue(name)[0]
            cache[name] = (rs, convert.schema(rs, device="cpu"))
        return cache[name]
    return get


def _c3(rs, ps):
    rf = RSP(rs).ones_factors(RC(3))
    y = rs.labels
    rf[rs.label_table] = jnp.stack([jnp.ones_like(y), y, y * y], -1)
    pf = SumProd(ps).ones_factors(Channels(3))
    py = ps.labels
    pf[ps.label_table] = torch.stack([torch.ones_like(py), py, py * py], -1)
    return rf, pf


@pytest.mark.parametrize("fixture", FIXTURES)
def test_grouped_channels3_every_root(pair, fixture):
    rs, ps = pair(fixture)
    rf, pf = _c3(rs, ps)
    rc, pc = RCounter(), QueryCounter()
    for t in rs.tables:
        want = np.asarray(RSP(rs, rc)(RC(3), rf, group_by=t.name))
        got = SumProd(ps, pc)(Channels(3), pf, group_by=t.name).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=1e-5, atol=1e-4)
    # ungrouped: one value per query
    want = np.asarray(RSP(rs, rc)(RC(3), rf))
    got = SumProd(ps, pc)(Channels(3), pf).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (pc.count, pc.edges) == (rc.count, rc.edges)
    assert pc.edges == (len(rs.tables) + 1) * (len(rs.tables) - 1)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_batched_family_equals_single_queries(pair, fixture):
    """A leading K dim on the factors evaluates K queries in one pass."""
    rs, ps = pair(fixture)
    rng = np.random.default_rng(2)
    root = ps.names[-1]
    masks = {t.name: torch.from_numpy(rng.random((3, t.n_rows)) < 0.7) for t in ps.tables}
    sp = SumProd(ps)
    batched = sp(Arithmetic(), {tn: m.float() for tn, m in masks.items()}, group_by=root)
    for k in range(3):
        single = sp(Arithmetic(), {tn: m[k].float() for tn, m in masks.items()},
                    group_by=root)
        want = RSP(rs)(RArith(), {tn: jnp.asarray(m[k].numpy(), jnp.float32)
                                  for tn, m in masks.items()}, group_by=root)
        np.testing.assert_array_equal(batched[k].numpy(), single.numpy())
        np.testing.assert_array_equal(single.numpy(), np.asarray(want))


@pytest.mark.parametrize("fixture", FIXTURES)
def test_tropical_and_boolean(pair, fixture):
    rs, ps = pair(fixture)
    rng = np.random.default_rng(5)
    w = {t.name: rng.standard_normal(t.n_rows).astype(np.float32) for t in rs.tables}
    keep = {t.name: rng.random(t.n_rows) < 0.8 for t in rs.tables}
    for t in rs.tables:
        want = RSP(rs)(RTrop(), {k: jnp.asarray(v) for k, v in w.items()}, group_by=t.name)
        got = SumProd(ps)(Tropical(), {k: torch.from_numpy(v) for k, v in w.items()},
                          group_by=t.name)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = SumProd(ps)(BooleanSR(), {k: torch.from_numpy(v) for k, v in keep.items()},
                          group_by=t.name).numpy()
        count = RSP(rs)(RArith(), {k: jnp.asarray(v, jnp.float32) for k, v in keep.items()},
                        group_by=t.name)
        np.testing.assert_array_equal(got, np.asarray(count) > 0)
        # the reference's Boolean pass agrees wherever it says False; where
        # a key has no child rows its int32 segment_max gives INT32_MIN,
        # which casts to True, so it may only err towards True
        want = np.asarray(RSP(rs)(RBool(), {k: jnp.asarray(v) for k, v in keep.items()},
                                  group_by=t.name))
        assert not (got & ~want).any()
    want = RSP(rs)(RTrop(), {k: jnp.asarray(v) for k, v in w.items()})
    got = SumProd(ps)(Tropical(), {k: torch.from_numpy(v) for k, v in w.items()})
    assert float(got) == float(want)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_message_pass_variants(pair, fixture):
    """messages == reference messages; refresh_messages and messages_memo
    re-emit only what changed and reproduce the full pass bit for bit."""
    rs, ps = pair(fixture)
    rf, pf = _c3(rs, ps)
    sem, root = Channels(3), ps.names[0]
    jt, rjt = ps.join_tree(root), rs.join_tree(root)
    full = SumProd(ps).messages(sem, pf, jt=jt)
    ref = RSP(rs).messages(RC(3), rf, jt=rjt)
    for a, b in zip(full, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)

    dirty = [jt.edges[0].child]
    assert refresh_plan(jt, dirty) == rrefresh_plan(rjt, dirty)
    pf2 = dict(pf)
    pf2[ps.names[dirty[0]]] = pf[ps.names[dirty[0]]] * 2
    c = QueryCounter()
    fresh = SumProd(ps, c).refresh_messages(sem, pf2, full, dirty, jt)
    assert c.edges == sum(refresh_plan(jt, dirty))
    for a, b in zip(fresh, SumProd(ps).messages(sem, pf2, jt=jt)):
        assert torch.equal(a, b)

    cache, c = MessageCache(), QueryCounter()
    batched = {tn: f[None] for tn, f in pf.items()}
    sigs = {tn: ("v0", tn) for tn in pf}
    first = SumProd(ps, c).messages_memo(sem, batched, jt, sigs, cache)
    again = SumProd(ps, c).messages_memo(sem, batched, jt, sigs, cache)
    assert c.edges == len(jt.edges) and cache.hits == len(jt.edges)
    for a, b, m in zip(first, again, full):
        assert a is b
        assert torch.equal(a[0], m)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_materialize_join_identical(pair, fixture):
    rs, ps = pair(fixture)
    want = rmaterialize(rs)
    got = materialize_join(ps)
    assert list(got) == list(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)
