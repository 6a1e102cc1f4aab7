"""Plain PyTorch version of the polymul kernel.

The batched circular product mod z^k over the last axis, in the FFT
form: rfft · rfft → irfft.  This is the body ``PolyCoeff.mul`` had
before the kernel, so CPU results do not move.  Leading dims broadcast.
bfloat16 inputs are transformed in float32 (the FFT takes no bfloat16).
With ``dtype=torch.float64`` the transforms run in float64, which makes
it the comparison oracle on the card.  The wrapper uses it for CPU
tensors.
"""
from __future__ import annotations

from typing import Optional

import torch


def poly_mul_ref(a: torch.Tensor, b: torch.Tensor,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a, b: (..., k) real coefficient vectors → (..., k) circular
    product in ``dtype`` (default: ``a``'s dtype)."""
    k = a.shape[-1]
    work = torch.float64 if dtype == torch.float64 else torch.float32
    fa = torch.fft.rfft(a.to(work), n=k, dim=-1)
    fb = torch.fft.rfft(b.to(work), n=k, dim=-1)
    return torch.fft.irfft(fa * fb, n=k, dim=-1).to(dtype or a.dtype)
