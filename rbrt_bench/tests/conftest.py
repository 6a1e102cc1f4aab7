"""CPU tests of the benchmark harness (``python -m pytest rbrt_bench/tests``).

Tests that need the CUDA card carry the ``chip`` marker and skip here:
the ``cuda`` fixture decides, inside the test, whether there is one.
``tiny`` cuts every configuration and mix to a size the CPU runs in
seconds, by wrapping the registry's readers (the files stay as they are),
and adds ``KEPT``: the tpch.maintain cell, whose files the benchmark keeps
but which ``BENCHMARK.json`` leaves out (its tail spreads too widely from
run to run on the card's shared host for a bound; PERF.md §7).
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

KEPT = {
    "workloads": [{"name": "tpch.maintain", "config": "tpch_snowflake",
                   "traffic": "tpch_refresh", "chips": 1, "why": "kept"}],
    "end_to_end": [{"name": "refresh_ms_p95", "unit": "ms", "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": ["tpch.maintain"]}],
    "per_layer": [{"name": name, "unit": unit, "better": "lower", "source": source,
                   "layer": layer, "moves": "refresh_ms_p95", "workloads": ["tpch.maintain"]}
                  for name, unit, source, layer in [
                      ("csr_builds_per_batch.maintain", "csrs", "program_counter", "incremental"),
                      ("wal_append_ms_p95.maintain", "ms", "program_span", "durability"),
                      ("idle_share.maintain", "%", "device_trace", "device")]],
}
TINY_CONFIG = {"favorita": dict(sales_rows=4096, days=4, items=200, stores=10),
               "tpch": dict(scale_factor=0.002)}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device; skips where there is none")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: the benchmark's runs need the card")
    return "cuda"


@pytest.fixture
def tiny(monkeypatch):
    from rbrt_bench.lib import registry

    config, traffic, benchmark = registry.config, registry.traffic, registry.benchmark

    def with_kept(root=registry.ROOT):
        bench = benchmark(root)
        for key, entries in KEPT.items():
            bench[key] = bench[key] + entries
        for m in bench["per_layer"]:
            if m["name"] == "schema_build_s":
                m["workloads"] = m["workloads"] + ["tpch.maintain"]
        return bench

    def small_config(name, base=registry.BENCH_DIR):
        cfg = dict(config(name, base))
        cfg.update(TINY_CONFIG.get(cfg.get("generator"), {}))
        return cfg

    def small_traffic(name, base=registry.BENCH_DIR):
        mix = dict(traffic(name, base))
        if "generate" in mix:
            mix["generate"] = {"sales_rows": 8192, "days": 6}
        if mix.get("loop") == "score":
            mix["trees"] = 4
            mix["trace_requests"] = 6
        if mix.get("loop") == "maintain":
            mix["trace_requests"] = 6
        if "boost" in mix:
            mix["boost"] = dict(mix["boost"], sketch_k=16)
        return mix

    monkeypatch.setattr(registry, "config", small_config)
    monkeypatch.setattr(registry, "traffic", small_traffic)
    monkeypatch.setattr(registry, "benchmark", with_kept)
    return registry
