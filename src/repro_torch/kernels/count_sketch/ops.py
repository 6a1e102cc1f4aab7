"""Wrapper of the count_sketch kernel (``csrc/count_sketch.cu``).

- :func:`count_sketch` (x, buckets, signs, k) → (k,): the TPU kernel's
  own call, buckets int32 in [0, k) and signs as float32 arrays;
- :func:`count_sketch_hashed` (x, h) → (k,): the same sum with the
  buckets and signs of a :class:`~repro_torch.core.sketch.Hash2` at t =
  0..n−1, computed inside the kernel in 32-bit words (the gradient
  compressor's form: no index array is stored);
- :func:`unsketch` (x, sk, h, scale, est, state): the compressor's second
  pass, est[t] = s(t)·sk[h(t)]·scale and, given ``state``, state[t] =
  x[t] − est[t]; ``est`` and ``state`` may be x itself.

x is a 1-D contiguous float32 tensor of fewer than 2³¹ elements; k is a
power of two ≥ 2.  CUDA tensors go to the kernel, which is compiled with
``nvcc`` for sm_90a at first use (``kernels/_build.py``) and bound
through ``ctypes``; CPU tensors go to the plain versions in ``ref.py``;
``meta`` tensors get empty outputs of the kernel's shapes (a sketch's 2n
and an unsketch's 2n operations counted in ``_build.meta_operations``).
Any other device raises, as do a DTensor, other dtypes, shapes and sizes,
and a CUDA tensor that requires grad (the kernel has no backward).

:func:`plan` picks the kernel's route by the sketch's size (the source's
header says why): a sketch of at most ``SMEM_MAX_K`` buckets is summed in
shared memory, one block a tile of ``SMEM_TILE`` elements or more, and
written whole (no memset), by one block or as partials that a second
launch sums in block order; the hashed form of ``BINS_MIN_K`` to
``BINS_MAX_K`` buckets partitions its elements by bin of ``BIN_BUCKETS``
buckets into 8n bytes of scratch and sums each bin in shared memory;
any other sketch is cut into slabs of at most ``SLAB_BUCKETS`` buckets
that L2 holds, walked slab by slab.

Every route adds with atomics, so a bucket's sum order is not fixed and
two runs may differ in the last bits; the comparison on the card holds
each bucket j to 2⁻²³ · m_j · W_j of the float64 sum (m_j terms, W_j =
Σ|x_t| over them).

``launches`` counts sketch calls (either form; a call on the partials
route launches two kernels, one on the bins route four) since the last
:func:`reset_launches`, ``unsketch_launches`` the unsketch's; a run
reads them to show that its sketches went through the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from ...core.sketch import Hash2
from .. import _build
from .ref import count_sketch_op, count_sketch_ref, unsketch_ref

N_MAX = 2 ** 31 - 1
SMEM_MAX_K = 1 << 14          # buckets of a block's shared-memory sketch (64 KiB)
SMEM_TILE = 1 << 16           # least elements a block of the shared-memory route sums
SMEM_MAX_PARTS = 264          # most partial sketches (two blocks of 1,024 threads an SM)
SLAB_BUCKETS = 1 << 23        # most buckets of a slab (32 MiB of the 50 MB L2)
BIN_BUCKETS = 1 << 15         # buckets of a bin of the bins route (128 KiB of shared memory)
BINS_MIN_K, BINS_MAX_K = 1 << 23, 1 << 25   # the bins route's k (at least 256 bins, at most 1,024)

launches = 0
unsketch_launches = 0
_lib: Optional[ctypes.CDLL] = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's route for n elements into k buckets: "smem" sums in
    shared memory, ``parts`` blocks of ``tile`` elements (with parts > 1
    into a parts × k scratch of partials); "slabs" adds into a zeroed
    sketch in ``slabs`` slab-major passes; "bins" (the hashed form only)
    partitions the elements by bin of ``BIN_BUCKETS`` into a scratch of
    pairs and sums each bin in shared memory."""
    route: str
    tile: int = 0
    parts: int = 1
    slabs: int = 1


@functools.lru_cache(maxsize=256)
def plan(n: int, k: int, hashed: bool = True) -> Plan:
    """The route for a sketch of n elements into k buckets."""
    if k <= SMEM_MAX_K:
        parts = min(SMEM_MAX_PARTS, -(-n // SMEM_TILE))
        return Plan("smem", tile=-(-n // parts), parts=parts)
    if hashed and BINS_MIN_K <= k <= BINS_MAX_K:
        return Plan("bins")
    return Plan("slabs", slabs=max(1, k // SLAB_BUCKETS))


def scratch_words(p: Plan, n: int, k: int) -> int:
    """32-bit words of scratch a call on plan ``p`` allocates: the partial
    sketches, or the pairs and the bins' counts, starts and cursors."""
    if p.route == "smem":
        return p.parts * k if p.parts > 1 else 0
    if p.route == "bins":
        return 2 * n + 3 * (k // BIN_BUCKETS) + 1
    return 0


def reset_launches() -> None:
    global launches, unsketch_launches
    launches = unsketch_launches = 0


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/count_sketch.cu`` (see ``kernels/_build.py``);
    returns the library's path and the compiler's messages."""
    return _build.build("count_sketch", verbose=verbose)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("count_sketch")
        P, L, U, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_int
        lib.count_sketch_scatter.argtypes = [P] * 5 + [L, I, L, I, I, P]
        lib.count_sketch_hashed.argtypes = [P] * 3 + [L] + [U] * 4 + [I, L, I, I, P]
        lib.count_sketch_hashed_bins.argtypes = [P] * 3 + [L] + [U] * 4 + [I, P]
        lib.count_sketch_unsketch.argtypes = [P] * 4 + [L] + [U] * 4 + [I, ctypes.c_float, P]
        for fn in (lib.count_sketch_scatter, lib.count_sketch_hashed,
                   lib.count_sketch_hashed_bins, lib.count_sketch_unsketch):
            fn.restype = I
        lib.count_sketch_error_string.argtypes = [I]
        lib.count_sketch_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_k(k: int) -> None:
    if k < 2 or k & (k - 1) or k > 2 ** 31:
        raise ValueError(f"count_sketch takes k a power of two in [2, 2^31], got {k}")


def _check_vec(name: str, x: torch.Tensor, dtype: torch.dtype, n: Optional[int] = None,
               device=None) -> None:
    if x.dtype != dtype:
        raise TypeError(f"count_sketch: {name} must be {dtype}, got {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"count_sketch: {name} must be 1-D and contiguous, got shape "
                         f"{tuple(x.shape)}")
    if n is not None and x.shape[0] != n:
        raise ValueError(f"count_sketch: {name} has {x.shape[0]} elements, expected {n}")
    if not 0 < x.shape[0] <= N_MAX:
        raise ValueError(f"count_sketch takes 1 to {N_MAX} elements, got {x.shape[0]}")
    if device is not None and x.device != device:
        raise ValueError(f"count_sketch: {name} lies on {x.device}, x on {device}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise RuntimeError(f"count_sketch: no route for device {x.device}")


def _run(fn: str, device: torch.device, *args) -> None:
    lib = _load()
    with _build.on_device(device):
        rc = getattr(lib, fn)(*args, _build.raw_stream(device))
    if rc != 0:
        raise RuntimeError(f"count_sketch kernel launch failed ({fn}): "
                           + lib.count_sketch_error_string(rc).decode())


def _words(h: Hash2):
    return h.a, h.b, h.a2, h.b2, h._shift


def _outputs(x: torch.Tensor, n: int, k: int, p: Plan):
    """The sketch (zeroed only on the slab route, which adds into it) and
    the route's scratch (None when it needs none)."""
    if p.route == "slabs":
        out = torch.zeros(k, dtype=torch.float32, device=x.device)
    else:
        out = torch.empty(k, dtype=torch.float32, device=x.device)
    m = scratch_words(p, n, k)
    scratch = torch.empty(m, dtype=torch.int32, device=x.device) if m else None
    return out, scratch


def _route(p: Plan, k: int):
    """The C interface's (tile, parts, slab_shift) of an smem or slab plan."""
    return p.tile, p.parts, k.bit_length() - 1 - (p.slabs.bit_length() - 1)


def _hashed(x: torch.Tensor, h: Hash2, p: Plan) -> torch.Tensor:
    """The hashed sketch on the card, on plan ``p``."""
    n = x.shape[0]
    out, scratch = _outputs(x, n, h.k, p)
    ptr = 0 if scratch is None else scratch.data_ptr()
    if p.route == "bins":
        _run("count_sketch_hashed_bins", x.device, x.data_ptr(), out.data_ptr(), ptr, n,
             *_words(h))
    else:
        _run("count_sketch_hashed", x.device, x.data_ptr(), out.data_ptr(), ptr, n, *_words(h),
             *_route(p, h.k))
    global launches
    launches += 1
    return out


def count_sketch(x: torch.Tensor, buckets: torch.Tensor, signs: torch.Tensor,
                 k: int) -> torch.Tensor:
    """sketch[j] = Σ_t [buckets[t] = j] · signs[t] · x[t], (k,) float32."""
    _build.refuse_dtensor("count_sketch", x, buckets, signs)
    _check_k(k)
    if x.device.type != "cpu":
        _build.refuse_grad("count_sketch", x, signs)
    _check_vec("x", x, torch.float32)
    n = x.shape[0]
    _check_vec("buckets", buckets, torch.int32, n, x.device)
    _check_vec("signs", signs, torch.float32, n, x.device)
    if x.device.type == "meta":
        _build.count_meta("count_sketch", 2 * n)
        return x.new_empty(k)
    lo, hi = torch.aminmax(buckets)
    if int(lo) < 0 or int(hi) >= k:
        raise ValueError(f"count_sketch: buckets in [{int(lo)}, {int(hi)}] outside [0, {k})")
    if x.device.type == "cpu":
        return count_sketch_ref(x, buckets, signs, k)
    p = plan(n, k, hashed=False)
    out, scratch = _outputs(x, n, k, p)
    _run("count_sketch_scatter", x.device, x.data_ptr(), buckets.data_ptr(), signs.data_ptr(),
         out.data_ptr(), 0 if scratch is None else scratch.data_ptr(), n,
         33 - k.bit_length(), *_route(p, k))
    global launches
    launches += 1
    return out


def count_sketch_hashed(x: torch.Tensor, h: Hash2) -> torch.Tensor:
    """The sketch of x (n,) under ``h`` at t = 0..n−1, (h.k,) float32."""
    _build.refuse_dtensor("count_sketch", x)
    _check_k(h.k)
    if x.device.type != "cpu":
        _build.refuse_grad("count_sketch", x)
    _check_vec("x", x, torch.float32)
    if x.device.type == "cpu":
        return count_sketch_op(x, h)
    if x.device.type == "meta":
        _build.count_meta("count_sketch", 2 * x.shape[0])
        return x.new_empty(h.k)
    return _hashed(x, h, plan(x.shape[0], h.k))


def unsketch(x: torch.Tensor, sk: torch.Tensor, h: Hash2, scale: float = 1.0,
             est: Optional[torch.Tensor] = None,
             state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """est[t] = s(t)·sk[h(t)]·scale for t < n = len(x), written into
    ``est`` (a new tensor if None, else may be x); with ``state`` (may be
    x), also state[t] = x[t] − est[t].  Returns est."""
    _build.refuse_dtensor("count_sketch unsketch", x, sk, est, state)
    _check_k(h.k)
    if x.device.type != "cpu":
        _build.refuse_grad("count_sketch unsketch", x, sk)
    _check_vec("x", x, torch.float32)
    n = x.shape[0]
    _check_vec("sk", sk, torch.float32, h.k, x.device)
    est = torch.empty_like(x) if est is None else est
    _check_vec("est", est, torch.float32, n, x.device)
    if state is not None:
        _check_vec("state", state, torch.float32, n, x.device)
    if x.device.type == "cpu":
        e = unsketch_ref(sk, h, n, scale)
        if state is not None:
            state.copy_(x - e)
        return est.copy_(e)
    if x.device.type == "meta":
        _build.count_meta("count_sketch_unsketch", 2 * n)
        return est
    _run("count_sketch_unsketch", x.device, x.data_ptr(), sk.data_ptr(), est.data_ptr(),
         0 if state is None else state.data_ptr(), n, *_words(h), float(scale))
    global unsketch_launches
    unsketch_launches += 1
    return est
