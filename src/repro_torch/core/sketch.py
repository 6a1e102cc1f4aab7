"""Count sketch / tensor sketch (paper §1.1.2, §3).

TensorSketch(v_1 ⊙ … ⊙ v_τ) uses τ independent 2-wise hash pairs
(h_t: [|D_t|] → [k], s_t: [|D_t|] → {±1}); the Kronecker coordinate
ρ = (j_1..j_τ) lands in bucket H(ρ) = Σ_t h_t(j_t) mod k with sign
Π_t s_t(j_t).  Inside a SumProd query this is exactly the polynomial
semiring: table t contributes the monomial s_t(w)·z^{h_t(w)} and ⊗
(circular convolution mod z^k) adds bucket indices and multiplies signs.

Two representations: coefficient space (:class:`~.semiring.PolyCoeff`,
the paper's FFT cost model) and frequency space
(:class:`~.semiring.PolyFreq`, where monomials have the analytic
transform s·ω^{h·j} with ω = e^{-2πi/k} and ⊗ is O(k) elementwise).

Hashes are Dietzfelbinger multiply-add-shift on 32-bit words.  torch
has no uint32 add or shift, so the words live in int64 and every step
masks with ``& 0xFFFFFFFF``: a < 2^32 and x < 2^31 keep a·x + b below
2^63, so the mask reproduces uint32 wraparound exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from .schema import Schema
from .semiring import PolyCoeff, PolyFreq

_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Hash2:
    """Multiply-add-shift hash into k = 2^M buckets plus a ±1 sign hash.

    h(x) = (a·x + b  mod 2^32) >> (32 - M), a odd;
    s(x) = top bit of an independent copy, mapped to ±1.
    The constants are uint32 values held as Python ints.
    """

    a: int
    b: int
    a2: int
    b2: int
    k: int

    @staticmethod
    def make(rng: np.random.Generator, k: int) -> "Hash2":
        if k < 2 or k & (k - 1):
            raise ValueError(f"sketch size k must be a power of two, got {k}")
        draw = lambda: int(rng.integers(0, np.iinfo(np.int32).max))
        return Hash2(a=(2 * draw() + 1) & _MASK32, b=draw(),
                     a2=(2 * draw() + 1) & _MASK32, b2=draw(), k=k)

    @property
    def _shift(self) -> int:
        return 32 - int(self.k).bit_length() + 1

    def bucket(self, x: torch.Tensor) -> torch.Tensor:
        v = (self.a * (x.to(torch.int64) & _MASK32) + self.b) & _MASK32
        return v >> self._shift

    def sign(self, x: torch.Tensor) -> torch.Tensor:
        v = (self.a2 * (x.to(torch.int64) & _MASK32) + self.b2) & _MASK32
        return (1 - 2 * (v >> 31)).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class TableHashes:
    """One (h_t, s_t) pair per table, shared across a whole training run."""

    hashes: Dict[str, Hash2]
    k: int

    @staticmethod
    def make(rng: np.random.Generator, schema: Schema, k: int) -> "TableHashes":
        return TableHashes(hashes={t.name: Hash2.make(rng, k) for t in schema.tables}, k=k)


def monomial_coeff(sem: PolyCoeff, signs: torch.Tensor, buckets: torch.Tensor):
    """s·z^h as a dense coefficient vector (…, k)."""
    oh = torch.nn.functional.one_hot(buckets, sem.k).to(sem.dtype)
    return oh * signs[..., None]


def monomial_freq(sem: PolyFreq, signs: torch.Tensor, buckets: torch.Tensor):
    """rfft(s·z^h) = s·exp(-2πi·h·j/k), j = 0..k/2 — analytic, no FFT."""
    j = torch.arange(sem.k // 2 + 1, dtype=torch.float32, device=buckets.device)
    ang = -2.0 * math.pi * buckets[..., None].to(torch.float32) * j / sem.k
    return (signs[..., None] * torch.complex(torch.cos(ang), torch.sin(ang))).to(sem.dtype)


def sketch_factors(schema: Schema, sem, hashes: TableHashes, weight_table: str,
                   weights: torch.Tensor):
    """Per-table monomial factors for one sketched SumProd query.

    Every table t contributes s_t(w_t(row))·z^{h_t(w_t(row))}; the
    designated ``weight_table`` additionally carries the real weight per
    row (any single table works since ⊗ is commutative).
    """
    mono = monomial_freq if isinstance(sem, PolyFreq) else monomial_coeff
    factors = {}
    for t in schema.tables:
        h = hashes.hashes[t.name]
        w = schema.w_ids[t.name]
        m = mono(sem, h.sign(w), h.bucket(w))
        if t.name == weight_table:
            m = sem.scale(m, weights)
        factors[t.name] = m
    return factors
