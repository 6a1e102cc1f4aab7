"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert,
early fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", kind="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, rope_theta=5e5,
    n_experts=16, top_k=1, shared_expert=True, capacity_factor=1.5,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=128, vocab=512,
    n_experts=4, top_k=1, q_chunk=32, kv_chunk=64,
)
