"""Count sketch (signed scatter-add into k buckets) and its unsketch: Hopper kernel + plain PyTorch versions."""
from .ops import build, count_sketch, count_sketch_hashed, reset_launches, unsketch
from .ref import count_sketch_op, count_sketch_ref, unsketch_ref

__all__ = ["build", "count_sketch", "count_sketch_hashed", "count_sketch_op", "count_sketch_ref",
           "reset_launches", "unsketch", "unsketch_ref"]
