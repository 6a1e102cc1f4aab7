"""Commutative semirings for SumProd queries.

A SumProd query ``⊕_{x∈J} ⊗_f q_f(x_f)`` (paper §1.1.1) is generic over
a commutative semiring ``(S, ⊕, ⊗)``.  Every semiring here represents
an element of S as a tensor whose *trailing* ``value_shape`` dims hold
the element; leading dims are batch dims (query batch, rows, leaves).

- :class:`Arithmetic`  — (R, +, ·): counts / sums / products.
- :class:`Channels`    — (R^c, +, ⊙): c independent arithmetic channels;
  fuses the paper's three node queries (count, Σy, Σy²) into one pass.
- :class:`PolyCoeff`   — (R^k, +, ·mod z^k): the tensor-sketch polynomial
  semiring in coefficient space; ⊗ = circular convolution (the polymul
  kernel on CUDA tensors, FFT on CPU tensors).
- :class:`PolyFreq`    — rfft image of PolyCoeff; ⊗ = elementwise complex
  product (O(k)).
- :class:`Tropical`    — (R∪{+inf}, min, +).
- :class:`BooleanSR`   — ({0,1}, or, and): join emptiness tests.

Segment-⊕ (``segment_add``) reduces the row axis of ``vals`` (shape
``(*batch, n, *value_shape)``) over a static CSR.  For the four
semirings whose ⊕ is +, it runs the segment-⊕ kernel on CUDA tensors
(``kernels/segment_sum``), with the batch dims flattened into the
kernel's K and the value dims into its C; complex values go through as
``view_as_real``, i.e. twice the channels in float32, which is exact
because ⊕ is linear.  Tropical and Boolean use ``scatter_reduce`` on an
output filled with the semiring zero, so empty segments yield zero.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..kernels.polymul import poly_mul
from ..kernels.segment_sum import Segments, segment_sum


class Semiring:
    """Base class.  Elements: tensors [..., *value_shape] of ``dtype``."""

    value_shape: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32
    all_reduce_op = "sum"          # ⊕ across ranks (``spmd.psum_message``)

    def zeros(self, batch_shape=(), device=None) -> torch.Tensor:
        raise NotImplementedError

    def ones(self, batch_shape=(), device=None) -> torch.Tensor:
        raise NotImplementedError

    def add(self, a, b):
        raise NotImplementedError

    def mul(self, a, b):
        raise NotImplementedError

    def segment_add(self, vals: torch.Tensor, seg: Segments) -> torch.Tensor:
        """⊕-reduce the row axis of ``vals`` by ``seg``'s keys:
        (*batch, n, *value_shape) → (*batch, n_keys, *value_shape).
        Empty segments yield the ⊕-identity (semiring zero)."""
        raise NotImplementedError

    def reduce_add(self, vals, dim=0):
        """⊕-reduce along one batch dim."""
        raise NotImplementedError

    def row_dim(self, vals: torch.Tensor) -> int:
        """The row axis of ``vals``: the last one before the value dims."""
        return vals.dim() - 1 - len(self.value_shape)

    def _bmask(self, mask):
        """Reshape a batch-shaped boolean mask to broadcast over value dims."""
        return mask.reshape(mask.shape + (1,) * len(self.value_shape))

    def mask(self, vals, keep):
        """Row exclusion: masked-out rows become semiring zero."""
        zero = self.zeros((), device=vals.device)
        return torch.where(self._bmask(keep), vals, zero)

    def scale(self, vals, scalars):
        """Multiply semiring values by *real* scalars (valid when ⊕ is +)."""
        raise NotImplementedError


class _ModuleSemiring(Semiring):
    """Shared impl for semirings whose ⊕ is elementwise +."""

    def zeros(self, batch_shape=(), device=None):
        return torch.zeros(tuple(batch_shape) + self.value_shape, dtype=self.dtype,
                           device=device)

    def add(self, a, b):
        return a + b

    def segment_add(self, vals, seg):
        rd = self.row_dim(vals)
        batch, n = vals.shape[:rd], vals.shape[rd]
        x = torch.view_as_real(vals) if vals.is_complex() else vals
        tail = tuple(x.shape[rd + 1:])
        flat = x.reshape((math.prod(batch), n, math.prod(tail))).contiguous()
        out = segment_sum(flat, seg)                      # (K, n_keys, C) f32
        out = out.reshape(tuple(batch) + (seg.n_keys,) + tail)
        if vals.is_complex():
            return torch.view_as_complex(out.contiguous()).to(self.dtype)
        return out.to(self.dtype)

    def reduce_add(self, vals, dim=0):
        return torch.sum(vals, dim=dim)

    def scale(self, vals, scalars):
        s = scalars.reshape(scalars.shape + (1,) * len(self.value_shape))
        return vals * s.to(vals.dtype)


@dataclasses.dataclass(frozen=True)
class Arithmetic(_ModuleSemiring):
    value_shape: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32

    def ones(self, batch_shape=(), device=None):
        return torch.ones(tuple(batch_shape), dtype=self.dtype, device=device)

    def mul(self, a, b):
        return a * b


@dataclasses.dataclass(frozen=True)
class Channels(_ModuleSemiring):
    """c independent arithmetic channels: ⊗ is elementwise per channel.

    ``dtype`` is configurable: the serving factors are 0/1 leaf masks, so
    bf16 channels halve factor memory (the kernel still accumulates in
    float32; the result is cast back to ``dtype``).
    """

    channels: int = 3
    dtype: torch.dtype = torch.float32

    @property
    def value_shape(self):  # type: ignore[override]
        return (self.channels,)

    def ones(self, batch_shape=(), device=None):
        return torch.ones(tuple(batch_shape) + (self.channels,), dtype=self.dtype,
                          device=device)

    def mul(self, a, b):
        return a * b


@dataclasses.dataclass(frozen=True)
class PolyCoeff(_ModuleSemiring):
    """Polynomials mod z^k, coefficient representation (paper §3).

    ⊗ = circular convolution through ``kernels/polymul``: on CUDA
    tensors the hand-written kernel (the k products of every
    coefficient, on the tensor cores for k a multiple of 16 up to 128 and
    for 256, 512 and 1024, else on the FMA pipe; 2 ≤ k ≤ 1024); on CPU tensors its plain version, real FFTs
    (O(k log k)).  ``k`` must be even.
    """

    k: int = 64
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.k % 2:
            raise ValueError("sketch size k must be even")

    @property
    def value_shape(self):  # type: ignore[override]
        return (self.k,)

    def ones(self, batch_shape=(), device=None):
        out = torch.zeros(tuple(batch_shape) + (self.k,), dtype=self.dtype, device=device)
        out[..., 0] = 1.0
        return out

    def mul(self, a, b):
        return poly_mul(a, b).to(self.dtype)

    def norm_sq(self, vals):
        return torch.sum(torch.square(vals), dim=-1)

    def to_freq(self, vals):
        """The rfft image (…, k//2 + 1) of coefficient vectors (…, k)."""
        return torch.fft.rfft(vals, n=self.k, dim=-1)


@dataclasses.dataclass(frozen=True)
class PolyFreq(_ModuleSemiring):
    """Frequency-domain image of :class:`PolyCoeff` under rfft.

    Elements are the k//2+1 complex rfft coefficients.  ⊕ = + (FFT is
    linear), ⊗ = elementwise complex multiply (convolution theorem).
    Final sketch norms use Parseval (:meth:`norm_sq`).
    """

    k: int = 64
    dtype: torch.dtype = torch.complex64

    def __post_init__(self):
        if self.k % 2:
            raise ValueError("sketch size k must be even")

    @property
    def value_shape(self):  # type: ignore[override]
        return (self.k // 2 + 1,)

    def ones(self, batch_shape=(), device=None):
        return torch.ones(tuple(batch_shape) + (self.k // 2 + 1,), dtype=self.dtype,
                          device=device)

    def mul(self, a, b):
        return a * b

    def scale(self, vals, scalars):
        return vals * scalars.reshape(scalars.shape + (1,)).to(self.dtype)

    def norm_sq(self, vals):
        """Parseval for rfft of a real length-k signal:
        ||x||² = (|X_0|² + 2·Σ_{0<j<k/2}|X_j|² + |X_{k/2}|²) / k."""
        p = torch.square(torch.abs(vals))
        w = torch.full((self.k // 2 + 1,), 2.0, dtype=p.dtype, device=p.device)
        w[0] = w[-1] = 1.0
        return torch.sum(p * w, dim=-1) / self.k

    def to_coeff(self, vals):
        """The coefficient vectors (…, k) of rfft images (…, k//2 + 1)."""
        return torch.fft.irfft(vals, n=self.k, dim=-1)


def _scatter_reduce(vals: torch.Tensor, seg: Segments, zero, reduce: str):
    rd = vals.dim() - 1
    idx = seg.ids.expand(vals.shape)
    out = torch.full(vals.shape[:rd] + (seg.n_keys,), zero, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(rd, idx, vals, reduce, include_self=True)


@dataclasses.dataclass(frozen=True)
class Tropical(Semiring):
    """(R ∪ {+inf}, min, +) — min-plus."""

    all_reduce_op = "min"
    value_shape: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32

    def zeros(self, batch_shape=(), device=None):
        return torch.full(tuple(batch_shape), math.inf, dtype=self.dtype, device=device)

    def ones(self, batch_shape=(), device=None):
        return torch.zeros(tuple(batch_shape), dtype=self.dtype, device=device)

    def add(self, a, b):
        return torch.minimum(a, b)

    def mul(self, a, b):
        return a + b

    def segment_add(self, vals, seg):
        return _scatter_reduce(vals, seg, math.inf, "amin")

    def reduce_add(self, vals, dim=0):
        return torch.amin(vals, dim=dim)


@dataclasses.dataclass(frozen=True)
class BooleanSR(Semiring):
    """({False,True}, or, and)."""

    all_reduce_op = "max"
    value_shape: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.bool

    def zeros(self, batch_shape=(), device=None):
        return torch.zeros(tuple(batch_shape), dtype=self.dtype, device=device)

    def ones(self, batch_shape=(), device=None):
        return torch.ones(tuple(batch_shape), dtype=self.dtype, device=device)

    def add(self, a, b):
        return torch.logical_or(a, b)

    def mul(self, a, b):
        return torch.logical_and(a, b)

    def segment_add(self, vals, seg):
        return _scatter_reduce(vals.to(torch.uint8), seg, 0, "amax").to(torch.bool)

    def reduce_add(self, vals, dim=0):
        return torch.any(vals, dim=dim)
