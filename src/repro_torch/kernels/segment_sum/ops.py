"""Wrapper of the segment-⊕ kernel (``csrc/segment_sum.cu``).

:func:`segment_sum` takes values (K, n, C) and a :class:`Segments` CSR
and returns (K, n_keys, C) in float32.  CUDA tensors go to the kernel,
which is compiled with ``nvcc`` for sm_90a at first use into
``src/repro_torch/_build/`` and bound through ``ctypes``; CPU tensors
go to the plain version in ``ref.py``.  A tensor on any other device,
or one the kernel does not take, raises.

``launches`` counts kernel launches since the last
:func:`reset_launches`; a run reads it to show that its segment-⊕ work
went through the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .ref import segment_sum_ref

_PKG = Path(__file__).resolve().parents[2]
_SRC = _PKG / "csrc" / "segment_sum.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC")

launches = 0
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    global launches
    launches = 0


@dataclasses.dataclass(frozen=True)
class Segments:
    """CSR of a static key column: row ``order[offsets[key]:offsets[key+1]]``
    are the rows whose key is ``key``, in ascending row order."""

    ids: torch.Tensor      # (n,) int64 key per row
    order: torch.Tensor    # (n,) int32 rows sorted by key, stable
    offsets: torch.Tensor  # (n_keys+1,) int32 run starts
    n_keys: int

    @staticmethod
    def from_ids(ids: np.ndarray, n_keys: int, device) -> "Segments":
        ids = np.asarray(ids, np.int64).reshape(-1)
        if len(ids) >= 2 ** 31:
            raise ValueError(f"segment_sum takes < 2^31 rows, got {len(ids)}")
        order = np.argsort(ids, kind="stable").astype(np.int32)
        offsets = np.zeros(n_keys + 1, np.int64)
        np.cumsum(np.bincount(ids, minlength=n_keys), out=offsets[1:])
        return Segments(
            ids=torch.from_numpy(ids).to(device),
            order=torch.from_numpy(order).to(device),
            offsets=torch.from_numpy(offsets.astype(np.int32)).to(device),
            n_keys=int(n_keys),
        )


# ------------------------------------------------------------------ build --
def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the segment_sum kernel is built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile the kernel into a shared library (cached by the source's
    hash); returns its path and the compiler's messages (``-Xptxas -v``
    register and spill report when ``verbose``)."""
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = _BUILD_DIR / f"segment_sum-{tag}.so"
    if lib.exists() and not verbose:
        return lib, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)           # atomic: concurrent builders never see a torn file
    return lib, proc.stdout + proc.stderr


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        for name in ("segment_sum_f32", "segment_sum_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.segment_sum_error_string.argtypes = [ctypes.c_int]
        lib.segment_sum_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ---------------------------------------------------------------- wrapper --
def _check_cuda(vals: torch.Tensor, seg: Segments) -> None:
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segment_sum kernel takes float32 or bfloat16, got {vals.dtype}")
    if not vals.is_contiguous():
        raise ValueError("segment_sum kernel takes contiguous values")
    for name in ("order", "offsets"):
        t = getattr(seg, name)
        if t.device != vals.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"segment_sum: {name} must be contiguous int32 on {vals.device}, "
                             f"got {t.dtype} on {t.device}")


def segment_sum(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    """out[k, key, c] = Σ_{r : ids[r] = key} vals[k, r, c], in float32."""
    if vals.dim() != 3:
        raise ValueError(f"segment_sum takes (K, n, C) values, got shape {tuple(vals.shape)}")
    K, n, C = vals.shape
    if seg.order.shape != (n,) or seg.offsets.shape != (seg.n_keys + 1,):
        raise ValueError(f"segment_sum: CSR of {seg.order.shape[0]} rows / "
                         f"{seg.offsets.shape[0] - 1} keys does not fit values of {n} rows")
    if vals.device.type == "cpu":
        return segment_sum_ref(vals, seg.order, seg.offsets)
    if vals.device.type != "cuda":
        raise RuntimeError(f"segment_sum: no route for device {vals.device}")
    _check_cuda(vals, seg)
    out = torch.empty((K, seg.n_keys, C), dtype=torch.float32, device=vals.device)
    if out.numel() == 0:
        return out
    lib = _load()
    fn = lib.segment_sum_f32 if vals.dtype == torch.float32 else lib.segment_sum_bf16
    with torch.cuda.device(vals.device):
        rc = fn(vals.data_ptr(), seg.order.data_ptr(), seg.offsets.data_ptr(),
                out.data_ptr(), K, n, seg.n_keys, C,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("segment_sum kernel launch failed: "
                           + lib.segment_sum_error_string(rc).decode())
    global launches
    launches += 1
    return out
