"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", kind="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49155, tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
    q_chunk=32, kv_chunk=64,
)
