"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", kind="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256, rope_theta=5e5,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
    q_chunk=32, kv_chunk=64,
)
