"""The PyTorch port stands alone: no file of ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and importing every
module of the port loads neither."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s)"
    r"|from\s+\.\.+\s+import\s+repro\b)", re.M)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_forbidden_pattern_catches_reference_imports():
    bad = ["import jax", "import jax.numpy as jnp", "from jax import lax",
           "import repro.core", "from repro.core import Schema", "from repro import obs"]
    good = ["import repro_torch.core", "from repro_torch.core import Schema",
            "from .core import Schema", "import jaxlike"]
    assert all(_FORBIDDEN.search(s) for s in bad)
    assert not any(_FORBIDDEN.search(s) for s in good)


def test_importing_the_port_loads_neither_jax_nor_reference():
    mods = _modules()
    assert "repro_torch.core.trainer" in mods and "repro_torch.launch.serve_relational" in mods
    for m in ("repro_torch.models.lm", "repro_torch.models.rwkv6",
              "repro_torch.kernels.rwkv6_chunk.ops", "repro_torch.launch.serve",
              "repro_torch.kernels.flash_attention.ops", "repro_torch.kernels.count_sketch.ops",
              "repro_torch.optim.adamw", "repro_torch.optim.grad_compress",
              "repro_torch.data.pipeline", "repro_torch.data.synthetic",
              "repro_torch.checkpoint.checkpointer", "repro_torch.launch.train",
              "repro_torch.launch.steps", "repro_torch.obs.flight", "repro_torch.obs.slo",
              "repro_torch.obs.exposition", "repro_torch.serving.multi"):
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'jax' or k.startswith('jax.') or k == 'repro'\n"
        "             or k.startswith('repro.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port imports pulled in: {out.stdout.strip()}"
