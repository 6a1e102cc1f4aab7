"""llava-next-34b [vlm] — anyres tiling happens in the (stubbed)
frontend; the backbone consumes precomputed patch embeddings
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].  Half of each
sequence is patch embeddings, half text tokens."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", kind="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, frontend="patches", rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
    q_chunk=32, kv_chunk=64,
)
