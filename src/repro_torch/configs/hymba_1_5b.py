"""hymba-1.5b [hybrid] — parallel attention + SSM heads, SWA with 3
global-attention layers, 128 meta tokens [arXiv:2411.13676; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", kind="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, d_head=64,
    window=1024, global_layers=(0, 15, 31),
    ssm_state=16, ssm_heads=25, meta_tokens=128, ssm_chunk=16,
    scan_layers=False,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    d_head=32, window=64, global_layers=(0,), ssm_state=4, ssm_heads=4,
    meta_tokens=8, ssm_chunk=8, q_chunk=32, kv_chunk=64,
)
