"""seamless-m4t-medium [audio] — encoder–decoder, multimodal backbone
[arXiv:2308.11596; hf].  Frontend is a stub: the batch supplies
precomputed speech-frame embeddings (``src_frames``).  The assignment's
single seq_len splits src = tgt = seq_len/2."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", kind="encdec",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, frontend="frames", act="gelu",
)

SMOKE = CONFIG.replace(
    n_layers=2, enc_layers=2, d_model=128, n_heads=8, n_kv_heads=8,
    d_ff=256, vocab=512, q_chunk=32, kv_chunk=64,
)
