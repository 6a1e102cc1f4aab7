"""Wrapper of the flash_attention kernel (``csrc/flash_attention.cu``).

:func:`flash_attention_gqa` takes q (B, S, N, dh) and k, v (B, Sk, Kh, dh)
and returns softmax(q·kᵀ/√dh)·v as (B, S, N·dh) in q's dtype, causal or
not, query head n reading K/V head n // (N // Kh); the reference's
``kernels/flash_attention/ops.flash_attention_gqa`` has the same call,
without its repeat of K/V.  A non-causal call may take Sk ≠ S (the
cross-attention of an encoder–decoder: every query sees every key, the
reference model's ``attention(..., kv=...)``); a causal call takes Sk =
S and raises otherwise, as the reference bands only self-attention.  A
causal call may take a sliding ``window``
w ≥ 1: query i then sees the w keys (i − w, i], as the reference's
``models/layers._attn_mask`` masks them; None or w ≥ 2²⁹
(``ref.GLOBAL_WINDOW``, the reference's test in ``models/lm.py``) is full
causal attention, and a window on a non-causal call raises (the
reference bands only causal calls).  CUDA tensors go to the kernel, which is
compiled with ``nvcc`` for sm_90a at first use (``kernels/_build.py``)
and bound through ``ctypes``; it reads the operands in place through
their strides (a copy only where the last dimension is not contiguous,
the base is off 16 bytes, or a dimension longer than 1 has a stride that
is 0 or off 16 bytes: the bf16 kernel's TMA tensor maps take none of
these).  CPU tensors go to the plain version in ``ref.py``; a ``meta``
tensor gets empty outputs of the kernel's shapes and dtypes, and its
:func:`operations` go to ``_build.meta_operations`` (the dry run's
count).  Any other device raises, as do a DTensor operand, dtypes other
than float32 and bfloat16, operands of two dtypes or devices, shapes
that do not match, dh outside (16, 32, 64, 128), N not a multiple of Kh, and B or a tile count ⌈S / tile⌉ or ⌈Sk /
tile⌉ above 65,535, the tile 128 rows in bf16 and 64 in float32
(``ref.KERNEL_TILE``; on the CPU too, so a shape that runs here runs on
the card).

With ``return_lse`` the call also returns each query row's log-sum-exp,
float32 (B, N, S) in natural log (the kernel writes it in its epilogue;
on the CPU it is :func:`ref.block_attn_fwd`'s).  :func:`attention_train`
is the differentiable form that the training path calls: an
``autograd.Function`` whose forward is this call with ``return_lse`` and
the layer's window and whose backward is the plain
:func:`ref.block_attn_bwd` with that window (the reference has no
backward kernel either: its custom VJP is plain jnp).

``launches`` counts kernel launches since the last
:func:`reset_launches`, ``windowed_launches`` those of them made with a
window and ``noncausal_launches`` those made without causality (an
encoder's self-attention, a cross-attention); a run reads them to show
that its attention went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import (GLOBAL_WINDOW, KERNEL_TILE, KV_CHUNK, Q_CHUNK, block_attn_bwd,
                  block_attn_fwd, flash_attention_ref)

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
GRID_MAX = 65535                   # B and the query-tile count are grid dimensions

launches = 0
windowed_launches = 0              # those of ``launches`` made with a window
noncausal_launches = 0             # ... and those made without causality
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    global launches, windowed_launches, noncausal_launches
    launches = windowed_launches = noncausal_launches = 0


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/flash_attention.cu`` (see ``kernels/_build.py``);
    returns the library's path and the compiler's messages."""
    return _build.build("flash_attention", verbose=verbose)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_longlong] * 5
            + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_bf16_smem_bytes.argtypes = [ctypes.c_int]
        lib.flash_attention_bf16_smem_bytes.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def bf16_smem_bytes(dh: int) -> int:
    """Dynamic shared memory of the bf16 kernel at head width ``dh``."""
    return _load().flash_attention_bf16_smem_bytes(dh)


def pairs(S: int, causal: bool, window: Optional[int] = None, Sk: Optional[int] = None) -> int:
    """Key-query pairs of one (b, head): S·Sk full, S(S + 1)/2 causal, and
    Σ_{i<S} min(i + 1, w) in a causal band of w."""
    if not causal:
        return S * (S if Sk is None else Sk)
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def operations(B: int, S: int, Sk: int, N: int, dh: int, causal: bool,
               window: Optional[int] = None) -> int:
    """A call's operations, 4·B·N·dh·pairs (two products of dh a pair)."""
    return 4 * B * N * dh * pairs(S, causal, window, Sk)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True) -> None:
    _build.refuse_dtensor("flash_attention", q, k, v)
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"flash_attention takes operands of one dtype, got q {q.dtype} "
                            f"and {name} {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"flash_attention operands lie on {q.device} and {x.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention takes q (B, S, N, dh) and k, v (B, Sk, Kh, dh), got "
                         f"{[tuple(x.shape) for x in (q, k, v)]}")
    B, S, N, dh = q.shape
    Sk = k.shape[1]
    if k.shape[0] != B or k.shape[3] != dh or (Sk == 0 and S > 0):
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if causal and Sk != S:
        raise ValueError(f"flash_attention: a causal call takes as many keys as queries, got "
                         f"S = {S} and Sk = {Sk}")
    Kh = k.shape[2]
    if dh not in HEAD_DIMS or Kh == 0 or N % Kh:
        raise ValueError(f"flash_attention takes dh in {HEAD_DIMS} and N a multiple of Kh, "
                         f"got dh = {dh}, N = {N}, Kh = {Kh}")
    tile = KERNEL_TILE[q.dtype]
    if B > GRID_MAX or -(-S // tile) > GRID_MAX or -(-Sk // tile) > GRID_MAX:
        raise ValueError(f"flash_attention takes B, ceil(S / {tile}) and ceil(Sk / {tile}) up "
                         f"to {GRID_MAX} in {q.dtype}, got B = {B}, S = {S}, Sk = {Sk}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernel can read it in place (last dim contiguous,
    a 16-byte base, and every stride of a dimension longer than 1 a
    positive multiple of 16 bytes), else a contiguous copy."""
    per16 = 16 // x.element_size()
    if (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(n == 1 or (s > 0 and s % per16 == 0)
                    for s, n in zip(x.stride()[:3], x.shape[:3]))):
        return x
    return x.contiguous()


def _positions(B: int, S: int, Sk: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The query positions 0..S−1 and the key positions 0..Sk−1, (B, ·) int32."""
    pos = lambda n: torch.arange(n, dtype=torch.int32, device=device).expand(B, n)
    return pos(S), pos(Sk)


def band(window: Optional[int], causal: bool) -> Optional[int]:
    """The window a call runs with: None for full attention (None or w ≥
    2²⁹), else w; raises for w < 1 and for a window on a non-causal call."""
    if window is None or window >= GLOBAL_WINDOW:
        return None
    if not causal:
        raise ValueError(f"flash_attention: a window ({window}) needs a causal call")
    if window < 1:
        raise ValueError(f"flash_attention: a window is at least 1 key, got {window}")
    return int(window)


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, return_lse: bool = False,
                        window: Optional[int] = None):
    """softmax(q·kᵀ/√dh)·v of q (B, S, N, dh) and k, v (B, Sk, Kh, dh),
    as (B, S, N·dh) in q's dtype, each query over the keys its causal
    mask and ``window`` leave it (Sk = S when causal); with
    ``return_lse``, (out, lse (B, N, S) float32)."""
    _check(q, k, v, causal)
    window = band(window, causal)
    B, S, N, dh = q.shape
    Sk = k.shape[1]
    if q.device.type == "cpu":
        if not return_lse:
            return flash_attention_ref(q, k, v, causal, window)
        out, lse = block_attn_fwd(q, k, v, *_positions(B, S, Sk, q.device), causal, window,
                                  Q_CHUNK, KV_CHUNK)
        return out.to(q.dtype), lse.reshape(B, N, S)
    if q.device.type == "meta":
        _build.count_meta("flash_attention", operations(B, S, Sk, N, dh, causal, window))
        out = q.new_empty(B, S, N * dh)
        return (out, q.new_empty(B, N, S, dtype=torch.float32)) if return_lse else out
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no route for device {q.device}")
    out = torch.empty(B, S, N * dh, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, N, S, dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    q, k, v = (_aligned(x) for x in (q, k, v))
    strides = [s for x in (q, k, v) for s in x.stride()[:3]] + [S * N * dh, N * dh, dh]
    lib = _load()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), int(q.dtype == torch.bfloat16), B, S, Sk,
            N, k.shape[2], dh, int(causal), window or 0, (ctypes.c_longlong * 12)(*strides),
            _build.raw_stream(q.device))
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    global launches, windowed_launches, noncausal_launches
    launches += 1
    windowed_launches += window is not None
    noncausal_launches += not causal
    return (out, lse) if return_lse else out


class _Attention(torch.autograd.Function):
    """Forward: :func:`flash_attention_gqa` with the log-sum-exp and the
    layer's window (the kernel on CUDA); backward: :func:`ref.block_attn_bwd`
    with the same window, which recomputes the probabilities from q, k and
    that log-sum-exp per kv block, over the band's query rows only.  Under
    activation checkpointing the forward runs twice (the pass and the
    recompute); nothing is kept between the two runs.  The backward runs
    inside a ``record_function`` range ``attention_bwd``, which a profile
    counts as a kind of its own."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kv_chunk: int, window: Optional[int]):
        out, lse = flash_attention_gqa(q, k, v, causal, return_lse=True, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.kv_chunk, ctx.window = causal, kv_chunk, band(window, causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        with torch.profiler.record_function("attention_bwd"):
            q, k, v, out, lse = ctx.saved_tensors
            B, S, N, _ = q.shape
            Kh = k.shape[2]
            dq, dk, dv = block_attn_bwd(q, k, v, out, lse.reshape(B, Kh, N // Kh, S), dout,
                                        *_positions(B, S, k.shape[1], q.device), ctx.causal,
                                        ctx.window, ctx.kv_chunk)
        return dq, dk, dv, None, None, None


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    kv_chunk: int = KV_CHUNK, window: Optional[int] = None) -> torch.Tensor:
    """:func:`flash_attention_gqa` with gradients for q, k and v, each query
    over the keys its causal mask and ``window`` leave it (k, v may hold
    Sk ≠ S keys on a non-causal call: cross-attention); the backward
    scans kv blocks of ``kv_chunk`` keys (the model's ``cfg.kv_chunk``, as
    the reference's custom VJP does)."""
    return _Attention.apply(q, k, v, causal, kv_chunk, window)
