"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each kernel is a plain-C source compiled by ``nvcc`` for sm_90a into
``src/repro_torch/_build/<name>-<hash>.so``, where the hash covers the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header never loads a stale library.
The library is loaded with ``ctypes``; the kernel's wrapper declares
its functions' argument types.  Nothing here runs at import: a kernel is
built the first time its wrapper launches it, or by ``build``.
:func:`raw_stream` and :func:`on_device` are the wrappers' launch helpers,
:func:`refuse_grad` their guard for kernels that have no backward and
:func:`refuse_dtensor` their guard against a placed (DTensor) operand.

On a ``meta`` tensor a wrapper launches nothing: it returns outputs of
the kernel's shapes and dtypes, and adds the operations the kernel would
do (PERF.md §6's formulas) to :data:`meta_operations`, which the dry run
(``launch/dryrun.py``) reads, since a kernel on ``meta`` runs no ATen op
that a flop counter could see.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

meta_operations: Dict[str, int] = {}   # kernel → operations of its meta calls since the reset


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def cuobjdump() -> str:
    """The toolkit's ``cuobjdump`` (beside ``nvcc``), else the one Triton's
    package carries; raises if neither exists."""
    cands = [Path(nvcc()).parent / "cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    for cand in cands:
        if os.access(cand, os.X_OK):
            return str(cand)
    raise RuntimeError(f"cuobjdump not found (looked at {', '.join(map(str, cands))})")


def build(name: str, verbose: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` into a shared library (cached by the
    hash of source, headers and flags); returns its path and the
    compiler's messages (the ``-Xptxas -v`` register and spill report when
    ``verbose``, which always recompiles)."""
    path = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(path.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    tag = hashlib.sha1(digest.digest() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
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


def raw_stream(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it but without
    building a Stream object, whose 8–12 µs are on a short call's path.  A
    private binding, checked against torch 2.11 and 2.13;
    ``tests/test_torch_flash_attention_cuda.py`` and
    ``tests/test_torch_count_sketch_cuda.py`` hold it to the public form."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device, for a
    launch through the runtime API: ``torch.cuda.device(device)``, or
    nothing when it is current already (entering that guard costs a few
    µs on every call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise if a gradient is wanted through a kernel that has no backward:
    a launch through ``ctypes`` returns a tensor that autograd does not see,
    so the gradient would be dropped without a word.  Called by such a
    wrapper for every tensor that does not lie on the CPU (whose plain
    version autograd follows)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: the kernel has no backward, so an input that requires "
                           f"grad would get no gradient; call it under torch.no_grad() or "
                           f"pass detached inputs")


def refuse_dtensor(kernel: str, *tensors) -> None:
    """Raise TypeError on a DTensor operand: a kernel takes the plain local
    tensors of one rank (the placed step gathers a block's weights first,
    ``distributed/sharding.py``), and a DTensor would send the call through
    DTensor's dispatch, which knows no rule for it, unseen."""
    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(f"{kernel}: takes plain tensors, got a DTensor on "
                            f"{t.device_mesh} with placements {t.placements}; call it on "
                            f"the local tensors")


def count_meta(kernel: str, operations: int) -> None:
    """Add a meta call's operations to :data:`meta_operations`."""
    meta_operations[kernel] = meta_operations.get(kernel, 0) + int(operations)


def reset_meta_operations() -> None:
    meta_operations.clear()
