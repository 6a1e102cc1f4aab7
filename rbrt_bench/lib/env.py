"""The run's surroundings: caches inside the checkout, the program on the
path, the device, and the check that the JAX package stayed out.

Every build or kernel cache of a run sits at a fixed path inside the
checkout (``.bench_cache/``), so the first run of a checkout builds and
every later one finds the builds; the port's own kernel libraries are
content-hashed under ``src/repro_torch/_build/``, also in the checkout.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Dict, List

from .registry import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare(root: Path = ROOT) -> None:
    """Put the port's package on the path, and every cache the run may
    fill under the checkout."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    cache = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def device_info(count: int) -> Dict[str, object]:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}
