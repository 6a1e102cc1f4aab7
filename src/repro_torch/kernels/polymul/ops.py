"""Wrapper of the polymul kernel (``csrc/polymul.cu``).

:func:`poly_mul` takes two real coefficient tensors (..., k) and returns
their circular product mod z^k over the last axis; leading dims
broadcast, as in the reference's ``poly_mul_op``.  CUDA tensors go to
the kernel (a block-Toeplitz product on the tensor cores for k a
multiple of 16 up to 128 and for 256, 512 and 1024, the direct form on
the FMA pipe for other k; see the source's note), which is compiled with ``nvcc`` for sm_90a at first use
(``kernels/_build.py``) and bound through ``ctypes``; CPU tensors go to
the plain version in ``ref.py``.  Any other device raises, as do k
outside 2..1024, a dtype other than float32/bfloat16 and operands of two
dtypes.

Broadcasting: an operand that is broadcast only over a prefix of the
leading dims (the (1, n, k) factor of a one-node level against (K, n, k)
messages) is read in place, by a row period: row r of the output reads
its row r mod (its own row count).  An operand broadcast any other way
is expanded into a contiguous copy first.

``launches`` counts kernel launches since the last
:func:`reset_launches`; a run reads it to show that its ⊗ work went
through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import poly_mul_ref

K_MIN, K_MAX = 2, 1024

launches = 0
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    global launches
    launches = 0


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/polymul.cu`` (see ``kernels/_build.py``); returns
    the library's path and the compiler's messages."""
    return _build.build("polymul", verbose=verbose)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("polymul")
        for name in ("poly_mul_f32", "poly_mul_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.poly_mul_error_string.argtypes = [ctypes.c_int]
        lib.poly_mul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _operand(x: torch.Tensor, shape: torch.Size) -> Tuple[torch.Tensor, int]:
    """``x`` as contiguous rows, 16-byte aligned (the kernel copies rows in
    16-byte pieces), and its row period against ``shape``."""
    lead = (1,) * (len(shape) - x.dim()) + tuple(x.shape)
    rows, period = None, math.prod(shape[:-1])
    for p in range(len(shape)):             # x is (1, …, 1, *shape[p:])?
        if lead[p:] == tuple(shape[p:]):
            rows, period = x.contiguous(), math.prod(shape[p:-1])
            break
        if lead[p] != 1:
            break
    if rows is None:                        # broadcast elsewhere
        rows = x.expand(shape).contiguous()
    return (rows.clone() if rows.data_ptr() % 16 else rows), period


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for x in (a, b):
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"poly_mul takes float32 or bfloat16, got {x.dtype}")
    if a.dtype != b.dtype:
        raise TypeError(f"poly_mul takes operands of one dtype, got {a.dtype} and {b.dtype}")
    if a.dim() == 0 or b.dim() == 0 or a.shape[-1] != b.shape[-1]:
        raise ValueError(f"poly_mul takes (..., k) operands of one k, got shapes "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    k = a.shape[-1]
    if not K_MIN <= k <= K_MAX:
        raise ValueError(f"poly_mul takes {K_MIN} <= k <= {K_MAX}, got k = {k}")
    if a.device != b.device:
        raise ValueError(f"poly_mul operands lie on {a.device} and {b.device}")


def poly_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[..., i] = Σ_j a[..., j] · b[..., (i − j) mod k], in the
    operands' dtype."""
    _check(a, b)
    if a.device.type == "cpu":
        return poly_mul_ref(a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"poly_mul: no route for device {a.device}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    (ax, pa), (bx, pb) = _operand(a, shape), _operand(b, shape)
    lib = _load()
    fn = lib.poly_mul_f32 if a.dtype == torch.float32 else lib.poly_mul_bf16
    with torch.cuda.device(a.device):
        rc = fn(ax.data_ptr(), bx.data_ptr(), out.data_ptr(), math.prod(shape[:-1]),
                shape[-1], pa, pb, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("poly_mul kernel launch failed: "
                           + lib.poly_mul_error_string(rc).decode())
    global launches
    launches += 1
    return out
