"""Causal or non-causal GQA flash attention: Hopper kernel + plain PyTorch versions."""
from .ops import attention_train, build, flash_attention_gqa, reset_launches
from .ref import (attention_dense, attention_limit, attention_lse_dense, block_attn_bwd,
                  block_attn_fwd, flash_attention_ref)

__all__ = ["attention_dense", "attention_limit", "attention_lse_dense", "attention_train", "block_attn_bwd",
           "block_attn_fwd", "build", "flash_attention_gqa", "flash_attention_ref",
           "reset_launches"]
