"""Stacked A/B scoring (``serving/multi.py``) against each model's own pass
and against the JAX package's ``stack_ensembles``: variants trained by the
port on the fixtures' schemas, stacked and scored on every table in ONE
SumProd pass, and the same trees compiled and stacked by the reference;
the registry's ``stacked()`` cache across publish and swap; the refusals.

Tolerances: in float32 a stacked model's (Σŷ, count) equal its own
``score_grouped`` bit for bit (its counts are integer-valued, and its
slice contracts through the same ``compile.contract``); against the
reference, counts exactly and totals to rtol 1e-5 (atol 1e-4 near zero),
the reference contracting with a matrix product in another order; a
bfloat16 stack's counts within 2⁻⁸·|count| of the float32 stack's (one
rounding of the kernel's float32 sums to bf16's 8-bit mantissa)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tree import TreeArrays as RTree
from repro.serving import compile_ensemble as rcompile
from repro.serving.multi import stack_ensembles as rstack

from repro_torch import convert
from repro_torch.core import BoostConfig, Booster, QueryCounter
from repro_torch.core import semiring
from repro_torch.incremental import MaintainedScorer
from repro_torch.serving import ModelRegistry, compile_ensemble, stack_ensembles

VARIANTS = ((0, 1.0), (7, 0.5), (8, 0.25))        # (seed, shrinkage) of each A/B variant


@pytest.fixture(scope="module")
def variants(request):
    """Per fixture: (ref schema, port schema, [ref trees], [port trees]),
    one 2-tree, depth-2 sketch-mode variant a (seed, shrinkage), trained
    by the port as ``serve_relational`` trains; the reference's trees hold
    the same arrays."""
    cache = {}

    def get(name):
        if name not in cache:
            rs = request.getfixturevalue(name)[0]
            ps = convert.schema(rs, device="cpu")
            pts = [Booster(ps, BoostConfig(n_trees=2, depth=2, mode="sketch", ssr_mode="off",
                                           seed=s, lr=lr)).fit()[0] for s, lr in VARIANTS]
            rts = [[RTree(feat=jnp.asarray(t.feat.numpy()), thr=jnp.asarray(t.thr.numpy()),
                          leaf=jnp.asarray(t.leaf.numpy())) for t in trees] for trees in pts]
            cache[name] = (rs, ps, rts, pts)
        return cache[name]
    return get


@pytest.fixture
def emissions(monkeypatch):
    """Counts the segment-⊕ calls of every message emission."""
    calls = []
    real = semiring.segment_sum

    def counting(vals, seg):
        calls.append(tuple(vals.shape))
        return real(vals, seg)

    monkeypatch.setattr(semiring, "segment_sum", counting)
    return calls


@pytest.mark.parametrize("fixture", ["star", "snowflake"])
def test_stacked_pass_equals_each_models_own_bit_for_bit(variants, fixture, emissions):
    _, ps, _, pts = variants(fixture)
    ens = [compile_ensemble(ps, t) for t in pts]
    counter = QueryCounter()
    st = stack_ensembles(ens, counter=counter)
    assert st.n_models == 3 and st.offsets == [0, 8, 16, 24]
    assert st.factors[ps.names[0]].shape[1] == 24 and st.data_versions == (0, 0, 0)
    n_edges = ps.n_tables - 1
    for t in ps.names:
        del emissions[:]
        got = st.score_grouped(t)
        assert len(emissions) == n_edges                # one pass at C = ΣA_m
        assert all(shape[-1] == 24 for shape in emissions)
        del emissions[:]
        own = [e.score_grouped(t) for e in ens]
        assert len(emissions) == 3 * n_edges
        for (tot, cnt), (want_tot, want_cnt) in zip(got, own):
            assert tot.dtype == cnt.dtype == torch.float32
            assert torch.equal(tot, want_tot) and torch.equal(cnt, want_cnt)
    assert counter.count == ps.n_tables


@pytest.mark.parametrize("fixture", ["star", "snowflake"])
def test_stacked_pass_matches_reference(variants, fixture):
    rs, ps, rts, pts = variants(fixture)
    st = stack_ensembles([compile_ensemble(ps, t) for t in pts])
    rst = rstack([rcompile(rs, rt) for rt in rts])
    assert st.offsets == rst.offsets
    assert not any(torch.equal(a[0].leaf, b[0].leaf) for a, b in zip(pts, pts[1:]))
    np.testing.assert_array_equal(st.leaf_values.numpy(), np.asarray(rst.leaf_values))
    for t in ps.names:
        for (tot, cnt), (rtot, rcnt) in zip(st.score_grouped(t), rst.score_grouped(t)):
            np.testing.assert_array_equal(cnt.numpy(), np.asarray(rcnt))
            np.testing.assert_allclose(tot.numpy(), np.asarray(rtot), rtol=1e-5, atol=1e-4)


def test_bf16_stack_only_when_every_model_is_bf16(variants):
    _, ps, _, pts = variants("star")
    f32 = [compile_ensemble(ps, t) for t in pts]
    b16 = [compile_ensemble(ps, t, factor_dtype=torch.bfloat16) for t in pts]
    assert stack_ensembles(f32[:1] + b16[1:]).factors["fact"].dtype == torch.float32
    sb, sf = stack_ensembles(b16), stack_ensembles(f32)
    assert sb.factors["fact"].dtype == torch.bfloat16
    for t in ps.names:
        for (_, cb), (_, cf) in zip(sb.score_grouped(t), sf.score_grouped(t)):
            assert bool(((cb - cf).abs() <= 2.0 ** -8 * cf.abs()).all())


def test_stacked_refuses_padded_scorers_and_other_schemas(variants):
    _, ps, _, pts = variants("star")
    _, ps2, _, pts2 = variants("snowflake")
    ens = compile_ensemble(ps, pts[0])
    with pytest.raises(ValueError, match="at least one"):
        stack_ensembles([])
    with pytest.raises(ValueError, match="padded"):
        stack_ensembles([ens, MaintainedScorer(compile_ensemble(ps, pts[1]))])
    with pytest.raises(ValueError, match="share one schema"):
        stack_ensembles([ens, compile_ensemble(ps2, pts2[0])])


def test_registry_stacked_is_cached_until_a_publish_swap_or_data_version(variants):
    _, ps, _, pts = variants("star")
    a, b, c = (compile_ensemble(ps, t) for t in pts)
    reg = ModelRegistry()
    v1, v2 = reg.publish(a), reg.publish(b)
    s1 = reg.stacked()
    assert s1 is reg.stacked() and s1.ensembles == [a, b]
    v3 = reg.publish(c)
    s2 = reg.stacked()
    assert s2 is not s1 and s2.ensembles == [a, b, c] and s2 is reg.stacked()
    reg.swap(v2, c)                               # same slot, a new model
    s3 = reg.stacked()
    assert s3 is not s2 and s3.ensembles == [a, c, c]
    c.data_version = 5                            # a model maintained in place
    s4 = reg.stacked()
    assert s4 is not s3 and s4.data_versions == (0, 5, 5)
    s5 = reg.stacked([v1, v3])
    assert s5.ensembles == [a, c] and s5 is reg.stacked([v1, v3])
    for (tot, cnt), e in zip(s5.score_grouped("dim0"), (a, c)):
        want_tot, want_cnt = e.score_grouped("dim0")
        assert torch.equal(tot, want_tot) and torch.equal(cnt, want_cnt)
