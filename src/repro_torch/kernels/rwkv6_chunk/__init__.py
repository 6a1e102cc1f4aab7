"""Chunked RWKV-6 WKV: Hopper kernel + plain PyTorch version."""
from .ops import build, reset_launches, rwkv6_chunk
from .ref import rwkv6_chunk_ref

__all__ = ["build", "reset_launches", "rwkv6_chunk", "rwkv6_chunk_ref"]
