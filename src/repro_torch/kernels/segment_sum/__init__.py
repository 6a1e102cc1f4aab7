"""Segment-⊕ over a static CSR: Hopper kernel + plain PyTorch version."""
from .ops import ITEM_ROWS, Segments, WorkPlan, build, reset_launches, segment_sum
from .ref import segment_sum_ref

__all__ = ["ITEM_ROWS", "Segments", "WorkPlan", "build", "reset_launches", "segment_sum",
           "segment_sum_ref"]
