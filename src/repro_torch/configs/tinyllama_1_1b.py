"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", kind="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=1, d_ff=256, vocab=512,
    q_chunk=32, kv_chunk=64,
)
