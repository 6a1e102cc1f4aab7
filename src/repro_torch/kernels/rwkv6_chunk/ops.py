"""Wrapper of the rwkv6_chunk kernel (``csrc/rwkv6_chunk.cu``).

:func:`rwkv6_chunk` takes r, k, v and logw (≤ 0) of shape (B, S, H, hs)
and u of shape (H, hs), all float32, and returns the chunked RWKV-6 WKV
(B, S, H, hs) in float32, with a zero state at the start of each
sequence; the reference's ``kernels/rwkv6_chunk/ops.rwkv6_chunk`` has
the same call.  With ``return_state=True`` it also returns the state
after the last token, (B, H, hs, hs) float32 with S[b, h, key, value]:
the prefill's cache, written by the kernel (its plain version returns
the state its loop carries).  CUDA tensors go to the kernel, which is
compiled with ``nvcc`` for sm_90a at first use (``kernels/_build.py``)
and bound through ``ctypes``; CPU tensors go to the plain version in
``ref.py``; a ``meta`` tensor gets empty outputs of the kernel's shapes,
and its :func:`operations` go to ``_build.meta_operations`` (the dry
run's count).  Any other device raises, as do a DTensor operand, a dtype
other than float32, S not a multiple of ``chunk``, and a head size or
chunk the kernel does not take (on the CPU too, so a shape that runs
here runs on the card).

For a small batch the kernel cuts each sequence into :func:`segments`:
a first launch walks every segment but the last for its state alone,
and a second walks them all, each from the state the earlier segments
give it, so that the serial walk is shorter and the card fuller.

Gradients: where autograd wants one (grad mode on and an input that
requires grad), :func:`rwkv6_chunk` goes through :class:`_WKV`, whose
forward is the same kernel launch (its plain version on the CPU) and
whose backward is :func:`rwkv6_chunk_bwd`: the backward kernel
(``csrc/rwkv6_chunk_bwd.cu``) on a CUDA tensor, ``ref.rwkv6_chunk_bwd_ref``
on a CPU tensor.  The terminal state has no backward: asking for it with
gradients on raises.  The backward kernel runs a cluster of CTAs a
(b, h), each owning hs / split value columns of the state; the kernel
chooses the split by hs, and :func:`bwd_info` reports it.

``launches`` counts forward kernel calls (one a call, whether it launches
once or, with segments, twice) and ``bwd_launches`` backward kernel
calls, since the last :func:`reset_launches`; a run reads them to show
that its WKV went through the kernels.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import rwkv6_chunk_bwd_ref, rwkv6_chunk_ref

HEAD_SIZES = (16, 32, 64)
CHUNKS = (8, 16)
SMS = 132                     # streaming multiprocessors of an H100 SXM
MAX_SEGMENTS = 8
MIN_SEGMENT = 8               # chunks

launches = 0
bwd_launches = 0
_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/rwkv6_chunk.cu`` (see ``kernels/_build.py``);
    returns the library's path and the compiler's messages."""
    return _build.build("rwkv6_chunk", verbose=verbose)


def build_bwd(verbose: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/rwkv6_chunk_bwd.cu``, the backward kernel."""
    return _build.build("rwkv6_chunk_bwd", verbose=verbose)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("rwkv6_chunk")
        lib.rwkv6_chunk_f32.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 3
                                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.rwkv6_chunk_f32.restype = ctypes.c_int
        lib.rwkv6_chunk_error_string.argtypes = [ctypes.c_int]
        lib.rwkv6_chunk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _load_bwd() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load("rwkv6_chunk_bwd")
        lib.rwkv6_chunk_bwd_f32.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 3
                                            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.rwkv6_chunk_bwd_f32.restype = ctypes.c_int
        lib.rwkv6_chunk_bwd_info.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        lib.rwkv6_chunk_bwd_info.restype = ctypes.c_int
        lib.rwkv6_chunk_bwd_error_string.argtypes = [ctypes.c_int]
        lib.rwkv6_chunk_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def _check(r, k, v, logw, u, chunk: int) -> None:
    _build.refuse_dtensor("rwkv6_chunk", r, k, v, logw, u)
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


def segments(B: int, H: int, n_chunks: int) -> int:
    """Sequence segments of the kernel's walk: the most, a power of two up
    to ``MAX_SEGMENTS``, that keep B·H·segments blocks within two an SM and
    every segment at least ``MIN_SEGMENT`` chunks long (1: one walk)."""
    p = 1
    while (2 * p <= MAX_SEGMENTS and B * H * 2 * p <= 2 * SMS
           and n_chunks // (2 * p) >= MIN_SEGMENT):
        p *= 2
    return p


def bwd_info(hs: int, chunk: int) -> dict:
    """The backward kernel's launch for (hs, chunk) as the card sees it:
    the split (CTAs a (b, h), a thread-block cluster; the grid has
    B·H·split), the shared memory a CTA takes and the CTAs an SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).  Needs the card."""
    split, smem, per_sm = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    lib = _load_bwd()
    rc = lib.rwkv6_chunk_bwd_info(hs, chunk, ctypes.byref(split), ctypes.byref(smem),
                                  ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError("rwkv6_chunk_bwd_info failed: "
                           + lib.rwkv6_chunk_bwd_error_string(rc).decode())
    return {"split": split.value, "design": "A: a cluster of split CTAs a (b, h)",
            "smem_bytes": smem.value, "ctas_per_sm": per_sm.value}


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte address (the backward kernel reads rows
    as float4): read in place when it is, else a copy."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(args, chunk: int, n_seg: int, return_state: bool):
    """The kernel on contiguous CUDA (r, k, v, logw, u) in ``n_seg``
    sequence segments: the output and, if asked, the terminal state."""
    r = args[0]
    B, S, H, hs = r.shape
    dev = r.device
    out = torch.empty_like(r)
    state = torch.empty(B, H, hs, hs, dtype=torch.float32, device=dev) if return_state else None
    U = D = None
    if n_seg > 1:
        U = torch.empty(B, H, n_seg - 1, hs, hs, dtype=torch.float32, device=dev)
        D = torch.empty(B, H, n_seg - 1, hs, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _load()
    with _build.on_device(dev):
        rc = lib.rwkv6_chunk_f32(*(x.data_ptr() for x in args), out.data_ptr(), ptr(state),
                                 ptr(U), ptr(D), B, S, H, hs, chunk, n_seg,
                                 _build.raw_stream(dev))
    if rc != 0:
        raise RuntimeError("rwkv6_chunk kernel launch failed: "
                           + lib.rwkv6_chunk_error_string(rc).decode())
    global launches
    launches += 1
    return out, state


def rwkv6_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                u: torch.Tensor, chunk: int = 16, return_state: bool = False):
    """The chunked WKV (B, S, H, hs) of r, k, v, logw (B, S, H, hs) and
    the bonus u (H, hs), float32; with ``return_state``, (out, state),
    state (B, H, hs, hs) after the last token.  Differentiable in every
    input (through :class:`_WKV`) when grad mode is on, without the state."""
    _check(r, k, v, logw, u, chunk)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (r, k, v, logw, u)):
        if return_state:
            raise RuntimeError("rwkv6_chunk: the terminal state has no backward; ask for it "
                               "under torch.no_grad() (a prefill) or leave return_state off")
        return _WKV.apply(r, k, v, logw, u, chunk)
    return _forward(r, k, v, logw, u, chunk, return_state)


def operations(B: int, S: int, H: int, hs: int, chunk: int) -> int:
    """The chunked WKV's operations: per chunk c and head, the pairwise
    decays of the strictly lower triangle (a difference, an exponential, two
    products and a sum a key: 5·c(c−1)/2·hs), the bonus diagonal (3·c·hs),
    A·v over the lower triangle and its diagonal (c(c+1)·hs), the two state
    products (4·c·hs²), the state's decay (2·hs²) and the elementwise
    cumsum, decays and sum (7·c·hs).  The backward counts twice that."""
    c = chunk
    per = (5 * c * (c - 1) // 2 * hs + 3 * c * hs + c * (c + 1) * hs + 4 * c * hs * hs
           + 2 * hs * hs + 7 * c * hs)
    return B * H * (S // c) * per


def _forward(r, k, v, logw, u, chunk: int, return_state: bool):
    """The WKV of checked inputs: the kernel on CUDA, the plain version on the CPU."""
    if r.device.type == "cpu":
        return rwkv6_chunk_ref(r, k, v, logw, u, chunk, return_state=return_state)
    B, S, H, hs = r.shape
    if r.device.type == "meta":
        _build.count_meta("rwkv6_chunk", operations(B, S, H, hs, chunk))
        out = torch.empty_like(r, memory_format=torch.contiguous_format)
        return (out, r.new_empty(B, H, hs, hs)) if return_state else out
    if r.device.type != "cuda":
        raise RuntimeError(f"rwkv6_chunk: no route for device {r.device}")
    if r.numel() == 0:
        out = torch.empty_like(r, memory_format=torch.contiguous_format)
        state = torch.zeros(B, H, hs, hs, dtype=torch.float32, device=r.device)
        return (out, state) if return_state else out
    args = [x.contiguous() for x in (r, k, v, logw, u)]   # read in place when contiguous
    out, state = _launch(args, chunk, segments(B, H, S // chunk), return_state)
    return (out, state) if return_state else out


def rwkv6_chunk_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                    u: torch.Tensor, do: torch.Tensor, chunk: int = 16):
    """Gradients (dr, dk, dv, dlogw (B, S, H, hs), du (H, hs)), float32,
    of :func:`rwkv6_chunk`'s output (zero initial state) against ``do``:
    the backward kernel on CUDA tensors, ``ref.rwkv6_chunk_bwd_ref`` on CPU
    tensors; the shapes :func:`rwkv6_chunk` takes, ``do`` of r's shape."""
    _build.refuse_dtensor("rwkv6_chunk_bwd", do)
    _check(r, k, v, logw, u, chunk)
    if do.dtype != torch.float32 or do.shape != r.shape or do.device != r.device:
        raise ValueError(f"rwkv6_chunk_bwd takes do of r's shape, dtype and device, got "
                         f"{tuple(do.shape)} {do.dtype} on {do.device}")
    if r.device.type == "cpu":
        return rwkv6_chunk_bwd_ref(r, k, v, logw, u, do, chunk)
    B, S, H, hs = r.shape
    if r.device.type == "meta":
        _build.count_meta("rwkv6_chunk_bwd", 2 * operations(B, S, H, hs, chunk))
        return (*(torch.empty_like(r, memory_format=torch.contiguous_format) for _ in range(4)),
                torch.empty_like(u, memory_format=torch.contiguous_format))
    if r.device.type != "cuda":
        raise RuntimeError(f"rwkv6_chunk_bwd: no route for device {r.device}")
    if r.numel() == 0:
        return (*(torch.zeros_like(r) for _ in range(4)), torch.zeros_like(u))
    args = [_aligned(x) for x in (r, k, v, logw, u, do)]
    grads = [torch.empty_like(args[0]) for _ in range(4)]        # dr, dk, dv, dlogw
    du_part = torch.empty(B, H, hs, dtype=torch.float32, device=r.device)
    states = torch.empty(B, H, S // chunk, hs, hs, dtype=torch.float32, device=r.device)
    lib = _load_bwd()
    with _build.on_device(r.device):
        rc = lib.rwkv6_chunk_bwd_f32(*(x.data_ptr() for x in args),
                                     *(g.data_ptr() for g in grads), du_part.data_ptr(),
                                     states.data_ptr(), B, S, H, hs, chunk,
                                     _build.raw_stream(r.device))
    if rc != 0:
        raise RuntimeError("rwkv6_chunk_bwd kernel launch failed: "
                           + lib.rwkv6_chunk_bwd_error_string(rc).decode())
    global bwd_launches
    bwd_launches += 1
    return (*grads, du_part.sum(0))


class _WKV(torch.autograd.Function):
    """The WKV with its gradient: forward :func:`_forward` (the kernel on
    CUDA), backward :func:`rwkv6_chunk_bwd` from the saved inputs (the
    chunk states are rebuilt by the backward, nothing else is kept).  Under
    activation checkpointing the forward runs twice a backward pass."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, chunk: int):
        ctx.save_for_backward(r, k, v, logw, u)
        ctx.chunk = chunk
        return _forward(r, k, v, logw, u, chunk, False)

    @staticmethod
    def backward(ctx, do):
        r, k, v, logw, u = ctx.saved_tensors
        return (*rwkv6_chunk_bwd(r, k, v, logw, u, do.contiguous(), ctx.chunk), None)
