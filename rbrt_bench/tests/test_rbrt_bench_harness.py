"""The harness finds its pieces by name from files, and its arithmetic."""
import json
import math
import shutil

import numpy as np
import pytest

from rbrt_bench.lib import env, registry, roofline, stats
from rbrt_bench.lib.profile import trace_from_events


def test_every_cell_resolves_from_files():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        cell = registry.resolve(bench, w["name"])
        assert hasattr(cell["loop"], "window") and hasattr(cell["generator"], "generate")
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert callable(registry.metric_reader(m["name"]).read)
        assert set(json.loads((registry.BENCH_DIR / "limits" / f"{w['name']}.json").read_text()))


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A config, a mix, a loop and a metric added as files of their own
    are found by name; nothing that exists is edited."""
    base = tmp_path / "rbrt_bench"
    shutil.copytree(registry.BENCH_DIR, base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "configs" / "dummy_db.json").write_text(json.dumps(
        {"name": "dummy_db", "generator": "favorita", "sales_rows": 64, "days": 2}))
    (base / "traffic" / "dummy_mix.json").write_text(json.dumps({"loop": "dummy_loop", "n": 3}))
    (base / "loops" / "dummy_loop.py").write_text(
        "def setup(ctx):\n    return ctx\n\n\ndef window(st, seconds, requests=0):\n"
        "    return {'e2e': {'dummy_s': 1.0}, 'counters': {'n': st.mix['n']},"
        " 'attempted': 1, 'failed': 0}\n")
    (base / "metrics" / "dummy_count.x.py").write_text(
        "def read(trace):\n    return trace.counters.get('n')\n")
    bench = registry.benchmark()
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy_db",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_s", "unit": "s", "better": "lower",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["dummy.cell"]})
    bench["per_layer"].append({"name": "dummy_count.x", "unit": "n", "better": "lower",
                               "source": "program_counter", "layer": "dummy",
                               "moves": "dummy_s", "workloads": ["dummy.cell"]})
    cell = registry.resolve(bench, "dummy.cell", base=base)
    assert cell["config"]["sales_rows"] == 64
    assert sorted(m["name"] for m in cell["end_to_end"]) == ["dummy_s", "setup_s"]
    assert [m["name"] for m in cell["per_layer"]] == ["dummy_count.x"]
    out = cell["loop"].window(cell["loop"].setup(type("C", (), {"mix": cell["traffic"]})), 0)
    tr = trace_from_events([], 1.0)
    tr.counters = out["counters"]
    assert registry.read_metric("dummy_count.x", tr, base=base) == 3
    assert all(p.read_bytes() == b for p, b in before.items())


def test_metrics_without_a_workloads_key_follow_their_end_to_end_metric():
    bench = {"end_to_end": [{"name": "a_s"}, {"name": "b_s", "workloads": ["y"]}],
             "per_layer": [{"name": "pa", "moves": "a_s"}, {"name": "pb", "moves": "b_s"},
                           {"name": "pc", "moves": "a_s", "workloads": ["x"]}]}
    assert [m["name"] for m in registry.per_layer_of(bench, "x")] == ["pa", "pc"]
    assert [m["name"] for m in registry.per_layer_of(bench, "y")] == ["pa", "pb"]


@pytest.mark.parametrize("starts,ends,want", [
    ([0.0, 5.0, 10.0], [5.0, 10.0, 16.0], 16.0 / 3),
    ([1.0], [4.5], 3.5),
    ([2.0, 3.0], [3.0, 9.0], 3.5),          # the last fit started in the window finishes
])
def test_fit_s_is_the_whole_window_over_whole_fits(starts, ends, want):
    assert stats.per_request_s(starts, ends) == pytest.approx(want)


def test_p95_is_over_all_requests_not_a_median_of_chunks():
    lat = [10.0] * 90 + [100.0] * 10
    np.random.default_rng(0).shuffle(lat)
    assert stats.percentile(lat, 95) == pytest.approx(100.0)
    chunks = [np.median(lat[i:i + 10]) for i in range(0, 100, 10)]
    assert max(chunks) == 10.0


@pytest.mark.parametrize("K,n,C,n_keys,sz,bound_ms", [
    (1, 4_194_304, 3, 4096, 4, 0.0201),        # PERF.md §6's segment_sum rows
    (4, 4_194_304, 3, 4096, 4, 0.0652),
    (1, 4_194_304, 40, 4096, 4, 0.2055),
    (1, 4_194_304, 40, 4096, 2, 0.1054),
])
def test_segment_sum_bound_matches_perf_md(K, n, C, n_keys, sz, bound_ms):
    got = roofline.segment_sum_bound_s(K, n, C, n_keys, n, sz) * 1e3
    assert got == pytest.approx(bound_ms, rel=5e-3)        # PERF.md rounds to 3 digits


@pytest.mark.parametrize("rows_a,rows_b,B,k,sz,bound_ms", [
    (4_194_304, 4_194_304, 4_194_304, 256, 4, 3.8462),   # B 4M, k 256, f32
    (4_194_304, 4_194_304, 4_194_304, 256, 2, 1.9231),   # bf16
    (1 << 20, 4 << 20, 4 << 20, 256, 4, 2.8847),         # fit B's broadcast form
])
def test_polymul_bound_matches_perf_md(rows_a, rows_b, B, k, sz, bound_ms):
    got = roofline.polymul_bound_s(rows_a, rows_b, B, k, sz) * 1e3
    assert got == pytest.approx(bound_ms, rel=2e-3)
    nbytes, ops = roofline.polymul_counts(rows_a, rows_b, B, k, sz)
    assert ops == B * (7.5 * k * math.log2(k) + 6 * (k // 2 + 1))


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.core": 1, "repro": 1, "repro.core": 1,
            "jaxlib.xla": 1, "jaxtyping": 1, "flax": 1, "numpy": 1}
    assert env.forbidden_modules(mods) == ["flax", "jaxlib.xla", "repro", "repro.core"]


def test_trace_attributes_kernels_to_the_ranges_that_launched_them():
    ev = [
        {"cat": "user_annotation", "name": "sumprod.emit", "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "bench.segment_sum", "ts": 10, "dur": 20},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 15, "dur": 1,
         "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 150, "dur": 1,
         "args": {"correlation": 2}},
        {"cat": "kernel", "name": "seg", "ts": 20, "dur": 30, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "other", "ts": 160, "dur": 40, "args": {"correlation": 2}},
    ]
    tr = trace_from_events(ev, window_s=250e-6)
    assert tr.device_s_in(["bench.segment_sum"]) == pytest.approx(30e-6)
    assert tr.device_s_in(["sumprod.emit"]) == pytest.approx(30e-6)
    assert tr.device_s_in(["boost.sweep"]) is None
    assert tr.busy_s == pytest.approx(70e-6)
    assert tr.idle_share == pytest.approx(1 - 70 / 250)
    assert tr.n_kernels == 2
    assert tr.idle_gaps(1) == [["sumprod.emit", pytest.approx(110e-6)]]   # open at 50 µs


@pytest.mark.parametrize("where", ["checkout", "benchmark_files_only"])
def test_no_result_without_a_card_or_the_program(tmp_path, where):
    """Without a CUDA device (here), and in a directory that holds only
    BENCHMARK.json and the benchmark's files, a run exits non-zero and
    prints no result."""
    import subprocess
    import sys

    root = registry.ROOT
    if where == "benchmark_files_only":
        shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
        shutil.copytree(registry.BENCH_DIR, tmp_path / "rbrt_bench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        root = tmp_path
    out = subprocess.run([sys.executable, "rbrt_bench/run.py", "--workload", "favorita.fit",
                          "--seed", str(2 ** 40 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == "", out.stdout + out.stderr


def test_a_run_that_loaded_the_jax_package_prints_no_result(monkeypatch, capsys):
    import sys
    import types

    from rbrt_bench import run as bench_run

    monkeypatch.setattr(bench_run, "run", lambda args: {"correct": True, "checks": {}})
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    rc = bench_run.main(["--workload", "favorita.fit", "--seed", "1", "--seconds", "1"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == "" and "repro.core" in captured.err
