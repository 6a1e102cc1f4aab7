"""Plain PyTorch version of the segment-⊕ kernel.

Same function as the kernel, computed in float64: gather the rows in
CSR order, take a running sum along the rows, and difference it at the
segment offsets.  Integer-valued inputs come out exact, empty segments
come out zero, and the result is the same on every run.  The wrapper
uses it for CPU tensors; on the card it is the comparison oracle.
"""
from __future__ import annotations

import torch


def segment_sum_ref(vals: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """vals (K, n, C) → (K, n_keys, C) in ``dtype``; ``order`` (n,) and
    ``offsets`` (n_keys+1,) are the CSR of the row keys."""
    K, _, C = vals.shape
    # (K, C, n): the running sum walks the contiguous last dim
    x = vals.index_select(1, order.long()).to(torch.float64).transpose(1, 2).contiguous()
    cs = torch.cat([x.new_zeros((K, C, 1)), torch.cumsum(x, dim=2)], dim=2)
    off = offsets.long()
    out = cs.index_select(2, off[1:]) - cs.index_select(2, off[:-1])
    return out.transpose(1, 2).to(dtype).contiguous()
