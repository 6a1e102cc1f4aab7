"""dbrx-132b [moe] — 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", kind="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352,
    n_experts=16, top_k=4, capacity_factor=1.25,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=128, vocab=512,
    n_experts=4, top_k=2, q_chunk=32, kv_chunk=64,
)
