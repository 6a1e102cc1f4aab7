"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each kernel is a plain-C source compiled by ``nvcc`` for sm_90a into
``src/repro_torch/_build/<name>-<hash>.so``, where the hash covers the
source and the flags, so an edited source never loads a stale library.
The library is loaded with ``ctypes``; the kernel's wrapper declares
its functions' argument types.  Nothing here runs at import: a kernel is
built the first time its wrapper launches it, or by ``build``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(name: str, verbose: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` into a shared library (cached by the
    hash of source and flags); returns its path and the compiler's
    messages (the ``-Xptxas -v`` register and spill report when
    ``verbose``, which always recompiles)."""
    path = CSRC_DIR / f"{name}.cu"
    src = path.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"{name}-{tag}.so"
    if lib.exists() and not verbose:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path.name} with code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)           # atomic: concurrent builders never see a torn file
    return lib, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (building it if needed)."""
    return ctypes.CDLL(str(build(name)[0]))
