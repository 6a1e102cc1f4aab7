"""Chunked RWKV-6 WKV and its backward: Hopper kernels + plain PyTorch versions."""
from .ops import build, build_bwd, reset_launches, rwkv6_chunk, rwkv6_chunk_bwd
from .ref import rwkv6_chunk_bwd_ref, rwkv6_chunk_bwd_scale, rwkv6_chunk_ref

__all__ = ["build", "build_bwd", "reset_launches", "rwkv6_chunk", "rwkv6_chunk_bwd",
           "rwkv6_chunk_bwd_ref", "rwkv6_chunk_bwd_scale", "rwkv6_chunk_ref"]
