"""Segment-⊕ over a static CSR: Hopper kernel + plain PyTorch version."""
from .ops import Segments, build, reset_launches, segment_sum
from .ref import segment_sum_ref

__all__ = ["Segments", "build", "reset_launches", "segment_sum", "segment_sum_ref"]
