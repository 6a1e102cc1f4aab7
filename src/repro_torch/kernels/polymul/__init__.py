"""Batched circular polynomial product mod z^k: Hopper kernel + plain PyTorch version."""
from .ops import build, poly_mul, reset_launches
from .ref import poly_mul_ref

__all__ = ["build", "poly_mul", "poly_mul_ref", "reset_launches"]
