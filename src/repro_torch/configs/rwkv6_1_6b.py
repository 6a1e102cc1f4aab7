"""rwkv6-1.6b [ssm] 'Finch' — attention-free, data-dependent decay
[arXiv:2404.05892; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", kind="rwkv",
    n_layers=24, d_model=2048, n_heads=32,   # heads = d_model / head_size
    d_ff=7168, vocab=65536, rwkv_head_size=64, ssm_chunk=16,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=2, d_ff=256, vocab=512,
    rwkv_head_size=64, ssm_chunk=8,
)
