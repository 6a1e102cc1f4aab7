"""Incremental maintenance and retraining on the card.

These tests need a CUDA device and the CUDA toolkit; on a host without
one they skip.  The file imports no JAX, so on the GPU machine it runs
without the shared fixtures:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_incremental_cuda.py

After a short delta stream, the maintained scores are bit-equal to the
recompute oracle for every root (integer-valued counts, one contraction
order), every refresh emission is a segment-⊕ kernel launch, the
maintained CSRs equal ``Segments.from_ids``, and a recovery from the log
is bit-equal to the live scorer.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import BoostConfig, Booster, QueryCounter
from repro_torch.incremental import IncrementalBooster, MaintainedScorer
from repro_torch.incremental.recover import recover_scorer, save_checkpoint
from repro_torch.incremental.wal import WalWriter
from repro_torch.kernels.segment_sum import Segments, ops
from repro_torch.relational.generators import delta_stream, drift_stream, snowflake_schema
from repro_torch.serving import compile_ensemble


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the segment-⊕ kernel has no CPU mode)")
    return "cuda"


def _scorer(dev):
    sch = snowflake_schema(seed=13, n_fact=3000, n_dim=64, n_sub=8, device=dev)
    trees, _ = Booster(sch, BoostConfig(n_trees=3, depth=3, mode="sketch",
                                        ssr_mode="off")).fit()
    return sch, trees, MaintainedScorer(compile_ensemble(sch, trees), counter=QueryCounter())


def test_from_tensor_is_from_ids_on_the_card(dev):
    rng = np.random.default_rng(1)
    for n, k in ((100_000, 4096), (9_000, 3), (0, 2)):
        ids = np.minimum(rng.zipf(1.3, n) - 1, k - 1)
        a = Segments.from_ids(ids, k, dev)
        b = Segments.from_tensor(torch.from_numpy(ids).to(dev), k)
        for f in ("ids", "order", "offsets"):
            assert torch.equal(getattr(a, f), getattr(b, f))
        assert torch.equal(a.plan.item_offsets, b.plan.item_offsets)
        assert torch.equal(a.plan.item_slot, b.plan.item_slot)


def test_stream_is_oracle_exact_and_every_emission_launches(dev, tmp_path):
    sch, trees, ms = _scorer(dev)
    roots = [t.name for t in sch.tables]
    for r in roots:
        ms.grouped_cached(r)
    wal = WalWriter(str(tmp_path / "wal"), sync_every=4).attach(ms.state)
    total = 0
    for i, batch in enumerate(delta_stream(sch, ms.live_rows, seed=17, n_batches=6,
                                           ops_per_batch=40)):
        ms.apply(batch)
        ops.reset_launches()
        e0 = ms.counter.edges
        for r in roots:
            ms.grouped_cached(r)
        torch.cuda.synchronize()
        assert ops.launches == ms.counter.edges - e0
        total += ops.launches
        if i == 2:
            save_checkpoint(ms.state, str(tmp_path / "ckpt"))
        snap = ms.snapshot(roots, pin_oracle=True)          # one effective schema
        for r in roots:
            ot, oc = snap.recompute_oracle(r)
            mt, mc = ms.grouped_cached(r)
            assert torch.equal(ot, mt) and torch.equal(oc, mc), (i, r)
    assert total > 0
    wal.close()
    st = ms.state
    for key, de in st.edges.items():
        for t in key:
            seg = st._child_seg(key, de, t)
            want = Segments.from_ids(de.ids[t], de.n_keys, dev)
            assert torch.equal(seg.order, want.order) and torch.equal(seg.offsets, want.offsets)
    got, rep = recover_scorer(compile_ensemble(sch, trees), str(tmp_path / "wal"),
                              str(tmp_path / "ckpt"))
    assert (rep.checkpoint_lsn, rep.recovered_lsn) == (3, ms.data_version)
    for r in roots:
        for a, b in zip(got.grouped_cached(r), ms.grouped_cached(r)):
            assert torch.equal(a, b)


def test_refit_on_the_card_matches_a_scratch_warm_start(dev):
    sch = snowflake_schema(seed=5, n_fact=4000, n_dim=64, n_sub=8, device=dev)
    cfg = BoostConfig(n_trees=2, depth=3, mode="sketch", ssr_mode="off")
    ib = IncrementalBooster(sch, cfg)
    ib.fit()
    frozen = list(ib.trees)
    batch = next(drift_stream(sch, ib.live_rows, seed=3, n_batches=1, rows_per_batch=256))
    ops.reset_launches()
    e0 = ib.counter.edges
    rep = ib.refit(deltas=batch, n_new_trees=1, drift_threshold=-np.inf)
    assert rep.refitted and ops.launches == ib.counter.edges - e0 > 0
    oracle = Booster(ib.effective_schema(), cfg, hashes=ib.booster.hashes)
    want, _ = oracle.boost(frozen, 1)
    got = ib.trees[-1]
    assert torch.equal(got.feat, want[-1].feat)
    torch.testing.assert_close(got.thr, want[-1].thr, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got.leaf, want[-1].leaf, rtol=1e-4, atol=1e-5)
    assert rep.edges < oracle.counter.edges
