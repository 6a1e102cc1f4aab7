"""The generators and the plain reference, without the port."""
import numpy as np
import pytest

from rbrt_bench.lib import registry
from rbrt_bench.lib.data import Dataset, TableData
from rbrt_bench.reference import join as rjoin, sketch as rsketch

SEEDS = [7, 2 ** 31 + 11, 9_000_000_000_123]


@pytest.mark.parametrize("seed", SEEDS)
def test_favorita_tables_at_the_cut(seed):
    cfg = registry.config("favorita_star")
    ds = registry.generator("favorita").generate(cfg, seed, sales_rows=8192, days=6)
    n = {t.name: t.n_rows for t in ds.tables}
    assert n == {"sales": 8192, "items": 4100, "stores": 54, "transactions": 6 * 54,
                 "oil": 6, "holidays": 6}
    join = rjoin.materialize(ds)
    assert join.n == 8192                    # the natural join keeps every sale
    dates = ds.table("sales").columns["date"]
    assert np.ptp(np.bincount(dates - dates.min())) <= 1     # sales even over the dates
    again = registry.generator("favorita").generate(cfg, seed, sales_rows=8192, days=6)
    assert all(np.array_equal(a.columns[c], b.columns[c])
               for a, b in zip(ds.tables, again.tables) for c in a.columns)


@pytest.mark.parametrize("seed", SEEDS)
def test_tpch_sizes_and_refresh_functions(seed):
    cfg = dict(registry.config("tpch_snowflake"), scale_factor=0.01)
    gen = registry.generator("tpch")
    ds = gen.generate(cfg, seed)
    n = {t.name: t.n_rows for t in ds.tables}
    assert n["orders"] == 15_000 and n["customer"] == 1500 and n["part"] == 2000
    assert n["supplier"] == 100 and n["nation"] == 25
    assert n["lineitem"] == pytest.approx(4 * 15_000, abs=7)     # 1-7 lines an order
    assert rjoin.materialize(ds).n == n["lineitem"]
    stream = gen.RefreshStream(cfg, seed)
    kind, (orders, lines) = stream.batch(0)
    assert kind == "insert" and len(orders["orderkey"]) == 15      # SF·1500
    assert 15 <= len(lines["orderkey"]) <= 105
    assert not np.isin(orders["orderkey"], ds.table("orders").columns["orderkey"]).any()
    kind, keys = stream.batch(1)
    assert kind == "delete" and len(keys) == 15
    assert np.isin(keys, ds.table("orders").columns["orderkey"]).all()
    after = gen.apply_refresh(ds, [stream.batch(0), stream.batch(1)])
    assert after.table("orders").n_rows == n["orders"]
    gone = np.isin(ds.table("lineitem").columns["orderkey"], keys).sum()
    assert after.table("lineitem").n_rows == n["lineitem"] + len(lines["orderkey"]) - gone
    sizes = [gen.generate(cfg, s).table("lineitem").n_rows for s in SEEDS]
    assert len(set(sizes)) == 1                  # every seed draws the same sizes


def test_join_drops_unmatched_rows_and_refuses_duplicate_keys():
    fact = TableData("f", {"k": np.array([1, 2, 3, 3]), "y": np.zeros(4)}, ("y",))
    dim = TableData("d", {"k": np.array([3, 1]), "x": np.array([30.0, 10.0])}, ("x",))
    j = rjoin.materialize(Dataset([fact, dim], ("f", "y")))
    assert j.rows["f"].tolist() == [0, 2, 3] and j.rows["d"].tolist() == [1, 0, 0]
    dup = TableData("d", {"k": np.array([1, 1]), "x": np.zeros(2)}, ("x",))
    with pytest.raises(ValueError, match="more than once"):
        rjoin.materialize(Dataset([fact, dup], ("f", "y")))


def test_hash_matches_the_papers_multiply_add_shift():
    w = np.arange(1000)
    a, b, a2, b2, k = 2654435761, 12345, 40503, 777, 256
    bucket, sign = rsketch.hash_rows(w, (a, b, a2, b2), k)
    assert bucket.tolist() == [((a * x + b) % 2 ** 32) >> 24 for x in w.tolist()]
    assert sign.tolist() == [1.0 - 2.0 * (((a2 * x + b2) % 2 ** 32) >> 31) for x in w.tolist()]


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r);"
            "import rbrt_bench.reference.join, rbrt_bench.reference.sketch,"
            " rbrt_bench.reference.trees, rbrt_bench.reference.score;"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('repro_torch', 'repro', 'jax', 'jaxlib')]; print(bad); sys.exit(bool(bad))"
            % str(registry.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
