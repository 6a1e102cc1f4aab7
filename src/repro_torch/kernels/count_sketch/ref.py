"""Plain PyTorch versions of the count_sketch kernel.

:func:`count_sketch_ref` is the TPU kernel's function, sketch[j] =
Σ_t [buckets[t] = j] · signs[t] · x[t], summed by ``index_add_`` in
float64 (so it is the comparison oracle too) and returned as float32.
:func:`count_sketch_op` is the reference's ``count_sketch_op(x, h)``: the
buckets and signs of a :class:`~repro_torch.core.sketch.Hash2` at t =
0..n−1.  :func:`unsketch_ref` is the gradient compressor's estimate
s(t) · sketch[h(t)] · scale, with the reference's two float32 roundings.
"""
from __future__ import annotations

import torch

from ...core.sketch import Hash2


def count_sketch_ref(x: torch.Tensor, buckets: torch.Tensor, signs: torch.Tensor, k: int,
                     dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """x, buckets, signs: (n,) → (k,) float32 sketch S·x, summed in ``dtype``."""
    out = torch.zeros(k, dtype=dtype, device=x.device)
    out.index_add_(0, buckets.long(), x.to(dtype) * signs.to(dtype))
    return out.float()


def count_sketch_op(x: torch.Tensor, h: Hash2) -> torch.Tensor:
    """The sketch of x (n,) under ``h`` at indices 0..n−1."""
    idx = torch.arange(x.shape[0], device=x.device)
    return count_sketch_ref(x, h.bucket(idx), h.sign(idx), h.k)


def unsketch_ref(sk: torch.Tensor, h: Hash2, n: int, scale: float = 1.0) -> torch.Tensor:
    """est[t] = s(t) · sk[h(t)] · scale for t = 0..n−1, float32."""
    idx = torch.arange(n, device=sk.device)
    est = h.sign(idx) * sk[h.bucket(idx)]
    return est if scale == 1.0 else est * scale
