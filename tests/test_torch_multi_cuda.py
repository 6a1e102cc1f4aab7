"""Stacked A/B scoring on the card.

These tests need a CUDA device and the CUDA toolkit; on a host without
one they skip.  The file imports no JAX, so on the GPU machine it runs
without the shared fixtures:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_multi_cuda.py

Four variants stacked into one factor set score every table in one pass
whose every edge is one segment-⊕ kernel launch at C = ΣA_m channels,
each model's (Σŷ, count) bit-equal to its own pass (integer-valued counts
through the same contraction), in float32 and, for a bf16 stack against
its constituents' own bf16 passes, in bfloat16 too.
"""
import pytest
import torch

from repro_torch.core import BoostConfig, Booster
from repro_torch.kernels.segment_sum import ops
from repro_torch.relational.generators import snowflake_schema, star_schema
from repro_torch.serving import ModelRegistry, compile_ensemble, stack_ensembles


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the segment-⊕ kernel has no CPU mode)")
    return "cuda"


def _variants(sch, n=4):
    return [Booster(sch, BoostConfig(n_trees=3, depth=3, mode="sketch", ssr_mode="off",
                                     seed=s, lr=1.0 / (s + 1))).fit()[0] for s in range(n)]


@pytest.mark.parametrize("make", [
    lambda dev: star_schema(seed=2, n_fact=60_000, n_dim=512, device=dev),
    lambda dev: snowflake_schema(seed=13, n_fact=20_000, n_dim=64, n_sub=8, device=dev),
], ids=["star", "snowflake"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stacked_pass_is_each_models_own_and_launches_once_an_edge(dev, make, dtype):
    sch = make(dev)
    models = [compile_ensemble(sch, t, factor_dtype=dtype) for t in _variants(sch)]
    registry = ModelRegistry()
    for m in models:
        registry.publish(m)
    st = registry.stacked()
    assert st.factors[sch.names[0]].dtype == dtype
    assert st.factors[sch.names[0]].shape[1] == 4 * 24
    for t in sch.names:
        edges = len(sch.join_tree(t).edges)
        ops.reset_launches()
        got = st.score_grouped(t)
        assert ops.launches == edges
        ops.reset_launches()
        own = [m.score_grouped(t) for m in models]
        assert ops.launches == 4 * edges
        for (tot, cnt), (want_tot, want_cnt) in zip(got, own):
            assert torch.equal(cnt, want_cnt) and bool((cnt >= 0).all())
            if dtype == torch.float32:
                assert torch.equal(tot, want_tot)
    assert registry.stacked() is st
