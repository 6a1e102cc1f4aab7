"""Wrapper of the rwkv6_chunk kernel (``csrc/rwkv6_chunk.cu``).

:func:`rwkv6_chunk` takes r, k, v and logw (≤ 0) of shape (B, S, H, hs)
and u of shape (H, hs), all float32, and returns the chunked RWKV-6 WKV
(B, S, H, hs) in float32, with a zero state at the start of each
sequence; the reference's ``kernels/rwkv6_chunk/ops.rwkv6_chunk`` has
the same call.  CUDA tensors go to the kernel, which is compiled with
``nvcc`` for sm_90a at first use (``kernels/_build.py``) and bound
through ``ctypes``; CPU tensors go to the plain version in ``ref.py``.
Any other device raises, as do a dtype other than float32, S not a
multiple of ``chunk``, and a head size or chunk the kernel does not
take (on the CPU too, so a shape that runs here runs on the card).

``launches`` counts kernel launches since the last
:func:`reset_launches`; a run reads it to show that its WKV went through
the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import rwkv6_chunk_ref

HEAD_SIZES = (16, 32, 64)
CHUNKS = (8, 16)

launches = 0
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    global launches
    launches = 0


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/rwkv6_chunk.cu`` (see ``kernels/_build.py``);
    returns the library's path and the compiler's messages."""
    return _build.build("rwkv6_chunk", verbose=verbose)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("rwkv6_chunk")
        lib.rwkv6_chunk_f32.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3
                                        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.rwkv6_chunk_f32.restype = ctypes.c_int
        lib.rwkv6_chunk_error_string.argtypes = [ctypes.c_int]
        lib.rwkv6_chunk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(r, k, v, logw, u, chunk: int) -> None:
    for name, x in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u)):
        if x.dtype != torch.float32:
            raise TypeError(f"rwkv6_chunk takes float32, got {name} of {x.dtype}")
        if x.device != r.device:
            raise ValueError(f"rwkv6_chunk operands lie on {r.device} and {x.device}")
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, logw)):
        raise ValueError("rwkv6_chunk takes r, k, v, logw of one (B, S, H, hs) shape, got "
                         f"{[tuple(x.shape) for x in (r, k, v, logw)]}")
    B, S, H, hs = r.shape
    if tuple(u.shape) != (H, hs):
        raise ValueError(f"rwkv6_chunk takes u of shape (H, hs) = {(H, hs)}, got {tuple(u.shape)}")
    if hs not in HEAD_SIZES or chunk not in CHUNKS:
        raise ValueError(f"rwkv6_chunk takes hs in {HEAD_SIZES} and chunk in {CHUNKS}, "
                         f"got hs = {hs}, chunk = {chunk}")
    if S % chunk:
        raise ValueError(f"rwkv6_chunk needs S % chunk == 0 (pad first), got S = {S}, "
                         f"chunk = {chunk}")


def rwkv6_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                u: torch.Tensor, chunk: int = 16) -> torch.Tensor:
    """The chunked WKV (B, S, H, hs) of r, k, v, logw (B, S, H, hs) and
    the bonus u (H, hs), float32."""
    _check(r, k, v, logw, u, chunk)
    if r.device.type == "cpu":
        return rwkv6_chunk_ref(r, k, v, logw, u, chunk)
    if r.device.type != "cuda":
        raise RuntimeError(f"rwkv6_chunk: no route for device {r.device}")
    B, S, H, hs = r.shape
    out = torch.empty_like(r, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    args = [x.contiguous() for x in (r, k, v, logw, u)]   # read in place when contiguous
    lib = _load()
    with torch.cuda.device(r.device):
        rc = lib.rwkv6_chunk_f32(*(x.data_ptr() for x in args), out.data_ptr(), B, S, H, hs,
                                 chunk, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("rwkv6_chunk kernel launch failed: "
                           + lib.rwkv6_chunk_error_string(rc).decode())
    global launches
    launches += 1
    return out
