"""Serving of the port against the JAX package: trees trained by the
reference, carried across with ``convert.trees``, compiled and scored by
the port on every table, and compared with the reference's scorer (both
``use_kernel`` values); the interactive entry points; the micro-batching
service with a hot swap; the ``serve_relational`` launcher.

Tolerances: counts exact; totals rtol 1e-5 (atol 1e-4 for totals near
zero); per-row means as the reference's service tests (rtol 1e-5)."""
import asyncio

import numpy as np
import pytest
import torch

from repro.core import BoostConfig as RConfig, Booster as RBooster
from repro.serving import (compile_ensemble as rcompile, score_fresh as rscore_fresh,
                           score_grouped as rscore_grouped,
                           score_grouped_reference as rscore_reference,
                           stack_table_factor as rstack)

from repro_torch import convert
from repro_torch.core import QueryCounter, materialize_join, predict_rows
from repro_torch.serving import (LRUCache, ModelRegistry, RelationalScoringService,
                                 compile_ensemble, score_fresh, score_grouped,
                                 score_grouped_reference, score_mean_rows, score_rows,
                                 stack_table_factor)

FIXTURES = ["star", "chain", "snowflake"]


@pytest.fixture(scope="module")
def served(request):
    """Per fixture: (ref schema, port schema, ref trees, port trees); the
    reference trains as ``serve_relational`` does (sketch, no SSR)."""
    cache = {}

    def get(name):
        if name not in cache:
            rs = request.getfixturevalue(name)[0]
            rt, _ = RBooster(rs, RConfig(n_trees=3, depth=2, mode="sketch",
                                         ssr_mode="off")).fit()
            cache[name] = (rs, convert.schema(rs, device="cpu"), rt,
                           convert.trees(rt, device="cpu"))
        return cache[name]
    return get


@pytest.mark.parametrize("use_kernel", [False, True], ids=["dense", "kernel"])
@pytest.mark.parametrize("fixture", FIXTURES)
def test_score_grouped_every_table_matches_reference(served, fixture, use_kernel):
    rs, ps, rt, pt = served(fixture)
    rens = rcompile(rs, rt, use_kernel=use_kernel)
    ens = compile_ensemble(ps, pt, use_kernel=use_kernel)
    for t in rs.tables:
        want_tot, want_cnt = (np.asarray(a) for a in rscore_grouped(rens, t.name))
        tot, cnt = score_grouped(ens, t.name)
        np.testing.assert_array_equal(cnt.numpy(), want_cnt)
        np.testing.assert_allclose(tot.numpy(), want_tot, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_score_grouped_matches_oracle(served, fixture):
    """materialize_join + predict_rows + bincount, all in the port."""
    rs, ps, rt, pt = served(fixture)
    J = materialize_join(ps)
    X = torch.stack([J[c].to(torch.float32) for (_, c) in ps.features], dim=1)
    preds = predict_rows(pt, X).double()
    ens = compile_ensemble(ps, pt)
    for t in ps.tables:
        rows = J["__rows__" + t.name]
        tot, cnt = score_grouped(ens, t.name)
        np.testing.assert_array_equal(cnt.numpy(),
                                      torch.bincount(rows, minlength=t.n_rows).numpy())
        want = torch.bincount(rows, weights=preds, minlength=t.n_rows).numpy()
        np.testing.assert_allclose(tot.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fixture", FIXTURES)
def test_stacked_factors_match_reference(served, fixture):
    rs, ps, rt, pt = served(fixture)
    for t in rs.tables:
        np.testing.assert_array_equal(stack_table_factor(ps, pt, t.name).numpy(),
                                      np.asarray(rstack(rs, rt, t.name)))


def test_one_pass_vs_per_leaf_reference(served):
    """score_grouped counts 1 evaluation; the per-leaf loop n_trees·L + 1,
    and both give the reference's totals."""
    rs, ps, rt, pt = served("star")
    c_old, c_new = QueryCounter(), QueryCounter()
    tot_ref, cnt_ref = score_grouped_reference(ps, pt, "fact", counter=c_old)
    tot, cnt = score_grouped(compile_ensemble(ps, pt, counter=c_new), "fact")
    assert c_new.count == 1
    assert c_old.count == sum(int(t.leaf.shape[0]) for t in pt) + 1 == 13
    want_tot, want_cnt = (np.asarray(a) for a in rscore_reference(rs, rt, "fact"))
    np.testing.assert_array_equal(cnt_ref.numpy(), want_cnt)
    np.testing.assert_allclose(tot_ref.numpy(), want_tot, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tot.numpy(), tot_ref.numpy(), rtol=1e-5, atol=1e-4)


def test_bf16_factors_count_within_bf16(served):
    rs, ps, rt, pt = served("snowflake")
    tot, cnt = score_grouped(compile_ensemble(ps, pt), "dim0")
    tot16, cnt16 = score_grouped(compile_ensemble(ps, pt, factor_dtype=torch.bfloat16), "dim0")
    np.testing.assert_allclose(cnt16.numpy(), cnt.numpy(), rtol=2 ** -8)
    np.testing.assert_allclose(tot16.numpy(), tot.numpy(), rtol=2e-2, atol=0.5)


def test_score_rows_and_fresh(served):
    rs, ps, rt, pt = served("star")
    ens = compile_ensemble(ps, pt)
    tot, cnt = score_grouped(ens, "fact")
    ids = np.asarray([0, 3, 3, 17, 299])
    t2, c2 = score_rows(ens, "fact", ids)
    np.testing.assert_array_equal(t2.numpy(), tot.numpy()[ids])
    np.testing.assert_array_equal(c2.numpy(), cnt.numpy()[ids])
    mean = score_mean_rows(ens, "fact", ids).numpy()
    np.testing.assert_allclose(mean, tot.numpy()[ids] / np.maximum(cnt.numpy()[ids], 1.0),
                               rtol=1e-6)
    feats = {c: np.asarray(rs.table(tn).col(c))[:8] for (tn, c) in rs.features
             if tn == "fact"}
    feats.update({c: np.zeros(8, np.float32) for (tn, c) in rs.features if tn != "fact"})
    want = np.asarray(rscore_fresh(rcompile(rs, rt), feats))
    np.testing.assert_allclose(score_fresh(ens, feats).numpy(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(KeyError):
        score_fresh(ens, {"x0": np.zeros(2)})
    for bad in ([-1], [ps.table("fact").n_rows]):
        with pytest.raises(IndexError, match="out of range"):
            score_rows(ens, "fact", bad)


def test_lru_and_registry(served):
    c = LRUCache(2)
    assert c.get("a") is None
    c.put("a", 1.0)
    c.put("b", 2.0)
    assert c.get("a") == 1.0
    c.put("c", 3.0)
    assert c.get("b") is None and c.get("a") == 1.0 and c.get("c") == 3.0
    assert c.hits == 3 and c.misses == 2 and len(c) == 2

    rs, ps, rt, pt = served("star")
    reg = ModelRegistry(max_versions=2)
    with pytest.raises(LookupError):
        reg.latest_version()
    e1, e2 = compile_ensemble(ps, pt[:1]), compile_ensemble(ps, pt[:2])
    v1, v2 = reg.publish(e1), reg.publish(e2)
    assert reg.latest_version() == v2 and reg.get(v1)[1] is e1
    ep = reg.epoch(v1)
    reg.swap(v1, e2)
    assert reg.epoch(v1) > ep and reg.get(v1)[1] is e2
    v3 = reg.publish(e1)
    assert reg.versions() == [v2, v3]
    with pytest.raises(KeyError):
        reg.get(v1)


def test_service_microbatching_and_hot_swap(served):
    rs, ps, rt, pt = served("star")
    reg = ModelRegistry()
    e1 = compile_ensemble(ps, pt[:1])
    v1 = reg.publish(e1)
    svc = RelationalScoringService(reg, "fact", max_batch=32, max_wait_ms=5.0, cache_size=64)
    want1 = score_mean_rows(e1, "fact", np.arange(40)).numpy()

    async def run():
        with pytest.raises(RuntimeError):
            await svc.score(0)
        await svc.start()
        with pytest.raises(IndexError):
            await svc.score(10_000)
        got = await svc.score_many(range(40))
        np.testing.assert_allclose(got, want1, rtol=1e-5)
        rep = await svc.score_many(range(20))               # cache hits
        np.testing.assert_allclose(rep, want1[:20], rtol=1e-5)
        e2 = compile_ensemble(ps, pt)
        v2 = reg.publish(e2)
        got2 = await svc.score_many(range(10))
        np.testing.assert_allclose(got2, score_mean_rows(e2, "fact", np.arange(10)).numpy(),
                                   rtol=1e-5)
        assert not np.allclose(got2, want1[:10])              # the swap took effect
        np.testing.assert_allclose(await svc.score(5, version=v1), want1[5], rtol=1e-5)
        # swapping a slot in place invalidates its cached scores
        reg.swap(v1, e2)
        np.testing.assert_allclose(await svc.score(5, version=v1), got2[5], rtol=1e-5)
        await svc.stop()
        with pytest.raises(RuntimeError):
            await svc.score(0)

    asyncio.run(run())
    st = svc.stats
    assert st.requests == 72 and st.rejected == 1
    assert st.cache_hits >= 20
    assert st.batches < st.requests - st.cache_hits
    snap = svc.stats_snapshot()
    assert snap["latency_ms"]["count"] == st.requests


def test_service_retries_a_failing_dispatch(served):
    rs, ps, rt, pt = served("star")
    reg = ModelRegistry()
    ens = compile_ensemble(ps, pt)
    reg.publish(ens)
    svc = RelationalScoringService(reg, "fact", max_batch=8, max_wait_ms=1.0)
    real, calls = ens.grouped_cached, []

    def flaky(group_by):
        calls.append(group_by)
        if len(calls) == 1:
            raise RuntimeError("transient")
        return real(group_by)
    ens.grouped_cached = flaky

    async def run():
        await svc.start()
        out = await svc.score_many(range(4))
        await svc.stop()
        return out

    got = asyncio.run(run())
    np.testing.assert_allclose(got, score_mean_rows(ens, "fact", np.arange(4)).numpy())
    assert svc.stats.retries == 1 and svc.stats.errors == 0


def test_serve_relational_launcher(capsys):
    from repro_torch.launch import serve_relational

    out = serve_relational.main(["--schema", "snowflake", "--n-fact", "300", "--n-dim", "16",
                                 "--trees", "2", "--depth", "2", "--requests", "300",
                                 "--concurrency", "64", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "compiled ensemble: 2 trees, 8 stacked leaves over 5 tables" in text
    assert "hot-swapped to version 2" in text
    assert out["evals"] == 2                        # one bulk pass per model version
    with pytest.raises(SystemExit):
        serve_relational.main(["--kernel"])         # later slices' flags are absent
