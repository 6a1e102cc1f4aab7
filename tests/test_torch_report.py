"""``repro_torch.obs.report`` against the reference's ``repro.obs.report``:
the schema check's violations on the same documents, a report's keys,
metrics and rows for the same inputs, the file it writes (under
``tmp_path``: ``out_dir`` and ``REPRO_BENCH_DIR``), its refusal of a bad
metric, and the port's fingerprint (torch's version; the CUDA fields None
on a host without CUDA; the data mesh where one is active)."""
import copy
import json

import numpy as np
import pytest
import torch

from repro.obs import report as ref
from repro_torch.distributed import spmd
from repro_torch.obs import BenchReport, bench_path, fingerprint, validate_bench
from repro_torch.obs import report as port
from repro_torch.obs import trace as port_trace

VALID = {"schema_version": 1, "bench": "demo", "fingerprint": {"cpus": 8},
         "config": {"n": 3}, "metrics": {"ratio": 1.5, "count": 4},
         "rows": [{"a": 1}, {"b": 2.0}]}


def _without(key):
    doc = copy.deepcopy(VALID)
    del doc[key]
    return doc


def _with(key, value):
    doc = copy.deepcopy(VALID)
    doc[key] = value
    return doc


DOCS = {
    "valid": VALID,
    "no_version": _without("schema_version"),
    "no_bench": _without("bench"),
    "no_fingerprint": _without("fingerprint"),
    "no_metrics": _without("metrics"),
    "no_rows": _without("rows"),
    "bool_metric": _with("metrics", {"ok": True, "ratio": 2.0}),
    "string_metric": _with("metrics", {"ratio": "2.0"}),
    "non_dict_row": _with("rows", [{"a": 1}, 3]),
    "rows_not_a_list": _with("rows", {"a": 1}),
    "wrong_version": _with("schema_version", 2),
    "empty_bench": _with("bench", ""),
    "metrics_a_list": _with("metrics", [1.0]),
    "not_an_object": [VALID],
}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_validate_bench_matches_reference(name):
    doc = DOCS[name]
    got = validate_bench(copy.deepcopy(doc))
    assert got == ref.validate_bench(copy.deepcopy(doc))
    assert (got == []) == (name == "valid")


def _pair(name="trial", config=None):
    rows = [{"k": 1, "ms": 0.25}, {"k": 2, "ms": np.float32(0.5)}]
    out = []
    for cls in (BenchReport, ref.BenchReport):
        r = cls(name, config or {"n_fact": 600})
        r.add_rows(rows).set_metric("edge_ratio", 4).set_metric("qps", np.float64(12.5))
        out.append(r)
    return out


def test_to_dict_has_the_reference_keys_metrics_and_rows():
    mine, theirs = (r.to_dict() for r in _pair())
    assert set(mine) == set(theirs)
    for key in ("schema_version", "bench", "config", "metrics", "rows"):
        assert mine[key] == theirs[key], key
    assert mine["metrics"] == {"edge_ratio": 4.0, "qps": 12.5}
    assert validate_bench(mine) == [] and ref.validate_bench(mine) == []


def test_write_round_trips_under_out_dir(tmp_path):
    mine, theirs = _pair()
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    p = mine.write(str(tmp_path / "port"))
    q = theirs.write(str(tmp_path / "ref"))
    assert p == str(tmp_path / "port" / "BENCH_trial.json") == bench_path("trial",
                                                                          str(tmp_path / "port"))
    got, want = json.loads(open(p).read()), json.loads(open(q).read())
    assert validate_bench(got) == []
    assert set(got) == set(want)
    for key in ("schema_version", "bench", "config", "metrics", "rows"):
        assert got[key] == want[key], key
    assert got["rows"][1]["ms"] == 0.5                 # a numpy scalar written as a number


def test_write_honours_repro_bench_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_DIR", str(tmp_path))
    assert bench_path("x") == ref.bench_path("x") == str(tmp_path / "BENCH_x.json")
    path = _pair("env")[0].write()
    assert path == str(tmp_path / "BENCH_env.json")
    assert json.loads(open(path).read())["bench"] == "env"
    monkeypatch.delenv("REPRO_BENCH_DIR")
    monkeypatch.chdir(tmp_path / ".")
    assert bench_path("y") == ref.bench_path("y") == str(tmp_path / "BENCH_y.json")


def test_write_raises_on_a_bad_metric_and_writes_nothing(tmp_path):
    mine, theirs = _pair("bad")
    for r in (mine, theirs):
        r.metrics["flag"] = True                        # set past set_metric's float()
    with pytest.raises(ValueError, match="flag"):
        mine.write(str(tmp_path))
    with pytest.raises(ValueError, match="flag"):
        theirs.write(str(tmp_path))
    assert not list(tmp_path.iterdir())


def test_span_rollup_and_trace_sink_while_tracing(tmp_path):
    port_trace.enable_tracing()
    try:
        port_trace.get_tracer().clear()
        with port_trace.span("report.demo"):
            pass
        r = _pair("traced")[0]
        doc = r.to_dict()
        assert "report.demo" in doc["span_rollup"]
        r.write(str(tmp_path))
    finally:
        port_trace.disable_tracing()
        port_trace.get_tracer().clear()
    assert (tmp_path / "TRACE_traced.jsonl").exists()
    assert "span_rollup" not in _pair("quiet")[0].to_dict()


def test_fingerprint_on_the_cpu():
    fp = fingerprint()
    assert fp is not None and port.fingerprint().keys() == fp.keys()
    want = ref.fingerprint()
    for key in ("platform", "python", "cpus"):
        assert fp[key] == want[key], key
    assert fp["torch"] == torch.__version__
    assert "jax" not in fp
    if not torch.cuda.is_available():
        assert fp["device"] is None and fp["capability"] is None and fp["device_count"] is None
    assert "mesh" not in fp


def test_fingerprint_records_the_data_mesh():
    with spmd.use_data_mesh(spmd.DataMesh(size=2, rank=1)):
        fp = fingerprint()
    assert fp["mesh"] == {"data": 2} == spmd.mesh_fingerprint(spmd.DataMesh(size=2, rank=1))
    assert "mesh" not in fingerprint()
