"""qwen2.5-32b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", kind="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab=152064, qkv_bias=True, rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
    q_chunk=32, kv_chunk=64,
)
