"""Schema-versioned ``BENCH_<name>.json`` perf-trajectory reports (the
reference's ``obs/report.py``).

A benchmark funnels its result rows and headline metrics through a
:class:`BenchReport`, which stamps a machine/config fingerprint, the
process metrics snapshot and (when tracing is on) a per-span rollup, then
writes ``BENCH_<name>.json`` in the working directory, or in
``REPRO_BENCH_DIR`` where it is set.

Schema v1 (validated by :func:`validate_bench`):

    {"schema_version": 1, "bench": str, "fingerprint": {...},
     "config": {...}, "metrics": {str: number}, "rows": [dict, ...],
     "metrics_snapshot": {...}?, "span_rollup": {...}?}

``metrics`` holds the headline scalars a baseline pins (count-derived
ratios preferred over wall-clock: they are free of scheduler noise).

The fingerprint records torch's version and the CUDA device (its name,
capability and ``torch.cuda.device_count()``, each None on a host without
CUDA) where the reference records jax's version, device kind and backend,
and the data mesh (``distributed.spmd.mesh_fingerprint``) where one is
active.
"""
from __future__ import annotations

import json
import os
import platform
from typing import Dict, List, Optional

import torch

from .metrics import get_registry
from .trace import get_tracer, tracing_enabled

__all__ = ["BenchReport", "fingerprint", "validate_bench", "bench_path"]

SCHEMA_VERSION = 1


def fingerprint() -> dict:
    """Machine/config identity a report was measured on: enough to judge
    whether two trajectory points are comparable."""
    fp = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "cpus": os.cpu_count(),
        "torch": torch.__version__,
        "device": None,
        "capability": None,
        "device_count": None,
    }
    if torch.cuda.is_available():
        fp["device"] = torch.cuda.get_device_name(0)
        fp["capability"] = list(torch.cuda.get_device_capability(0))
        fp["device_count"] = torch.cuda.device_count()
    from ..distributed import spmd

    mesh = spmd.mesh_fingerprint()
    if mesh is not None:                # an active data mesh at report time
        fp["mesh"] = mesh
    return fp


def bench_path(name: str, out_dir: Optional[str] = None) -> str:
    """Where ``BENCH_<name>.json`` goes: ``out_dir``, else
    ``REPRO_BENCH_DIR``, else the working directory."""
    if out_dir is None:
        out_dir = os.environ.get("REPRO_BENCH_DIR") or os.getcwd()
    return os.path.join(out_dir, f"BENCH_{name}.json")


class BenchReport:
    """Accumulates one benchmark's rows and headline metrics, then writes
    the schema-versioned JSON artifact."""

    def __init__(self, name: str, config: Optional[dict] = None):
        self.name = name
        self.config = dict(config or {})
        self.rows: List[dict] = []
        self.metrics: Dict[str, float] = {}

    def add_rows(self, rows: List[dict]) -> "BenchReport":
        self.rows.extend(rows)
        return self

    def set_metric(self, key: str, value) -> "BenchReport":
        self.metrics[key] = float(value)
        return self

    def to_dict(self) -> dict:
        doc = {
            "schema_version": SCHEMA_VERSION,
            "bench": self.name,
            "fingerprint": fingerprint(),
            "config": self.config,
            "metrics": self.metrics,
            "rows": self.rows,
            "metrics_snapshot": get_registry().snapshot(),
        }
        if tracing_enabled():
            doc["span_rollup"] = get_tracer().rollup()
        return doc

    def write(self, out_dir: Optional[str] = None) -> str:
        """Write ``BENCH_<name>.json`` (and, when tracing is enabled, the
        raw span sink ``TRACE_<name>.jsonl`` beside it); raises
        ``ValueError`` on a schema violation, writing nothing."""
        path = bench_path(self.name, out_dir)
        doc = self.to_dict()
        errors = validate_bench(doc)
        if errors:
            raise ValueError(errors)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True, default=_jsonable)
            f.write("\n")
        if tracing_enabled():
            get_tracer().dump_jsonl(os.path.join(os.path.dirname(path),
                                                 f"TRACE_{self.name}.jsonl"))
        return path


def _jsonable(o):
    import numpy as np

    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, torch.Tensor) and o.numel() == 1:
        return o.item()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


def validate_bench(doc: dict) -> List[str]:
    """Schema-v1 structural check; returns human-readable violations (an
    empty list: valid)."""
    errs = []
    if not isinstance(doc, dict):
        return ["report is not an object"]
    if doc.get("schema_version") != SCHEMA_VERSION:
        errs.append(f"schema_version must be {SCHEMA_VERSION}, "
                    f"got {doc.get('schema_version')!r}")
    if not isinstance(doc.get("bench"), str) or not doc.get("bench"):
        errs.append("bench must be a non-empty string")
    if not isinstance(doc.get("fingerprint"), dict):
        errs.append("fingerprint must be an object")
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict):
        errs.append("metrics must be an object")
    else:
        for k, v in metrics.items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                errs.append(f"metrics[{k!r}] must be a number, got {v!r}")
    rows = doc.get("rows")
    if not isinstance(rows, list) or any(not isinstance(r, dict) for r in rows):
        errs.append("rows must be a list of objects")
    return errs
