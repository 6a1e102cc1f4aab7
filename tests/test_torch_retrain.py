"""Warm-start retraining of the port against the JAX package, and the
two maintenance CLIs.

The port's and the reference's ``IncrementalBooster`` fit the same tables
(``convert.schema``) with the reference's sketch hashes
(``convert.table_hashes``), then take the same drift batches and refit:
trees match as the reference's ``tests/test_retrain.py`` holds them
(``feat`` equal, ``thr`` within 1e-6, leaves within rtol 1e-4 and atol
1e-5); each ``RefitReport``'s counts (queries, edges, trees, refitted)
are equal, its cache hit rate equal, and its MSEs and drift within rtol
1e-4 (sketched SSR sums in float32), over one refit and one drift check
that keeps the model.  Exact and histogram split modes, and exact
(Alg. 2) training with per-table SSR.  A port refit also
matches a scratch ``Booster`` on the effective tables warm-started from
the same frozen prefix, with fewer edges."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import BoostConfig as RConfig
from repro.incremental import IncrementalBooster as RIncremental
from repro.relational.generators import drift_stream as rdrift_stream

from repro_torch import convert
from repro_torch.core import BoostConfig, Booster
from repro_torch.incremental import IncrementalBooster, TableDelta

ROOT = Path(__file__).resolve().parents[1]

CONFIGS = {
    "sketch-exact-splits": dict(n_trees=2, depth=2, mode="sketch", ssr_mode="off"),
    "sketch-hist-splits": dict(n_trees=2, depth=2, mode="sketch", ssr_mode="off",
                               split_mode="hist", hist_bins=16),
    "exact-ssr": dict(n_trees=2, depth=2, mode="exact", ssr_mode="per_table"),
}


def _assert_trees_match(a, b, atol=1e-5):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x.feat), np.asarray(y.feat))
        np.testing.assert_allclose(np.asarray(x.thr), np.asarray(y.thr), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(x.leaf), np.asarray(y.leaf), rtol=1e-4, atol=atol)


def _port_batch(batch):
    return [TableDelta(table=d.table, inserts=d.inserts, deletes=d.deletes, updates=d.updates)
            for d in batch]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_refits_match_reference(star, config):
    rs = star[0]
    rib = RIncremental(rs, RConfig(**CONFIGS[config]))
    pib = IncrementalBooster(convert.schema(rs, device="cpu"), BoostConfig(**CONFIGS[config]),
                             hashes=convert.table_hashes(rib.booster.hashes))
    rib.fit()
    pib.fit()
    _assert_trees_match(pib.trees, rib.trees)
    assert (pib.counter.count, pib.counter.edges) == (rib.counter.count, rib.counter.edges)
    # the first batch refits, the second stays under its drift gate
    for batch, gate in zip(rdrift_stream(rs, rib.live_rows, seed=41, n_batches=2,
                                         rows_per_batch=12), (-np.inf, np.inf)):
        want = rib.refit(deltas=batch, n_new_trees=1, drift_threshold=gate)
        got = pib.refit(deltas=_port_batch(batch), n_new_trees=1, drift_threshold=gate)
        assert got.refitted == (gate < 0)
        for f in ("refitted", "n_new", "n_trees", "queries", "edges", "cache_hit_rate"):
            assert getattr(got, f) == getattr(want, f), f
        for f in ("drift", "mse_before", "mse_after"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-4)
        _assert_trees_match(pib.trees, rib.trees)
    assert (pib.counter.count, pib.counter.edges) == (rib.counter.count, rib.counter.edges)


@pytest.mark.parametrize("split_mode", ["exact", "hist"])
def test_refit_matches_scratch_warm_start_with_fewer_edges(chain, split_mode):
    # hist: edge_tol 0 re-quantizes a dirty table's bins from its live
    # values, as a scratch fit on the effective tables does
    cfg = BoostConfig(n_trees=2, depth=2, mode="sketch", ssr_mode="off",
                      split_mode=split_mode, hist_bins=16, hist_edge_tol=0.0)
    ib = IncrementalBooster(convert.schema(chain[0], device="cpu"), cfg)
    ib.fit()
    frozen = list(ib.trees)
    for batch in rdrift_stream(chain[0], ib.live_rows, seed=43, n_batches=2,
                               rows_per_batch=16):
        ib.apply(_port_batch(batch))
    e0 = ib.counter.edges
    rep = ib.refit(n_new_trees=2, drift_threshold=-np.inf)
    assert rep.refitted and len(ib.trees) == 4
    oracle = Booster(ib.effective_schema(), cfg, hashes=ib.booster.hashes)
    trees_o, _ = oracle.boost(list(frozen), 2)
    _assert_trees_match(ib.trees, trees_o)
    assert all(a is b for a, b in zip(ib.trees[:2], frozen))
    assert ib.counter.edges - e0 < oracle.counter.edges


def _run(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True,
                          timeout=600, env=env, cwd=str(ROOT))


def test_stream_deltas_cli_audits_exact_and_recovers(tmp_path):
    wal = str(tmp_path / "wal")
    args = ("repro_torch.launch.stream_deltas", "--device", "cpu", "--batches", "4",
            "--n-fact", "300", "--trees", "2", "--depth", "2", "--wal-dir", wal,
            "--checkpoint-every", "2")
    first = _run(*args)
    assert first.returncode == 0, first.stderr
    assert "audit max|Δ|=0.0e+00  OK" in first.stdout
    assert "final audit vs fresh recompute: max|Δ|=0.0e+00 (exact)" in first.stdout
    assert "WAL: durable through lsn 4" in first.stdout
    second = _run(*args)
    assert second.returncode == 0, second.stderr
    assert "recovered: checkpoint lsn 4 + 0 replayed → data_v4" in second.stdout
    assert "final audit vs fresh recompute: max|Δ|=0.0e+00 (exact)" in second.stdout
    assert "WAL: durable through lsn 8" in second.stdout


def test_retrain_stream_cli_runs_at_its_smallest_size():
    out = _run("repro_torch.launch.retrain_stream", "--device", "cpu", "--batches", "2",
               "--n-fact", "120", "--n-dim", "8", "--trees", "1", "--depth", "1",
               "--audit-every", "2", "--split-mode", "hist")
    assert out.returncode == 0, out.stderr
    assert "final model: mse" in out.stdout and out.stdout.count("+1 trees") + \
        out.stdout.count("kept model") == 2


def test_clis_default_to_cuda_and_raise_without_a_card(monkeypatch):
    from repro_torch.launch import retrain_stream, stream_deltas
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (stream_deltas.main, retrain_stream.main):
        with pytest.raises(RuntimeError, match="is_available"):
            main(["--batches", "1"])
