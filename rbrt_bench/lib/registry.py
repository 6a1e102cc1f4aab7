"""Find the benchmark's pieces by name, from files.

``BENCHMARK.json`` names cells, metrics and configurations; each piece
lives in a file of its own under the benchmark's folder, found by that
name and never listed in code:

- ``configs/<config>.json``: a deployment (schema, data scale), naming
  its ``generator``;
- ``generators/<generator>.py``: the numpy tables of a configuration;
- ``traffic/<mix>.json``: a traffic mix's parameters, naming its
  ``loop``;
- ``loops/<loop>.py``: the window loop that a mix's parameters drive;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

A later change adds a cell, a mix or a metric by adding files.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(base: Path, kind: str, name: str) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind} file {path.name} under {base / kind}")
    return json.loads(path.read_text())


def _module(base: Path, kind: str, name: str) -> ModuleType:
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file {path.name} under {base / kind}")
    mod_name = f"rbrt_bench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    if mod_name in sys.modules and getattr(sys.modules[mod_name], "__file__", None) == str(path):
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def config(name: str, base: Path = BENCH_DIR) -> dict:
    return _json(base, "configs", name)


def traffic(name: str, base: Path = BENCH_DIR) -> dict:
    return _json(base, "traffic", name)


def generator(name: str, base: Path = BENCH_DIR) -> ModuleType:
    return _module(base, "generators", name)


def loop(name: str, base: Path = BENCH_DIR) -> ModuleType:
    return _module(base, "loops", name)


def metric_reader(name: str, base: Path = BENCH_DIR) -> ModuleType:
    return _module(base, "metrics", name)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in bench['workloads']]})")


def end_to_end_of(bench: dict, workload: str) -> List[dict]:
    """The end-to-end metrics a cell reports: those without a
    ``workloads`` key, and those that list it."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer_of(bench: dict, workload: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and
    those without a ``workloads`` key whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end_of(bench, workload)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out


def resolve(bench: dict, workload: str, base: Path = BENCH_DIR) -> Dict[str, object]:
    """Everything one cell needs, found by name: its config, traffic mix,
    generator and loop modules, and its metric lists."""
    w = cell(bench, workload)
    cfg = config(w["config"], base)
    mix = traffic(w["traffic"], base)
    return {
        "cell": w, "config": cfg, "traffic": mix,
        "generator": generator(cfg["generator"], base),
        "loop": loop(mix["loop"], base),
        "end_to_end": end_to_end_of(bench, workload),
        "per_layer": per_layer_of(bench, workload),
    }


def read_metric(name: str, trace, base: Path = BENCH_DIR) -> Optional[float]:
    """One per-layer metric from a traced window; None where its reader
    found nothing to read."""
    return metric_reader(name, base).read(trace)
