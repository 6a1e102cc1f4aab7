"""Model configuration — one dataclass covers all 10 assigned architectures.

The port's own copy of the reference's ``ModelConfig``: the same fields,
defaults and properties, so a config carries over field for field.  The
port runs every kind below and both front ends (``models/lm.py``), served
and trained.  On the card their WKV and their prefill and training
attention take the hand-written kernels whatever ``use_pallas`` says.

``kind`` selects the block wiring:
  dense  — decoder-only transformer (GQA)            [qwen2.5, tinyllama,
                                                      llama3, granite, llava]
  moe    — dense + mixture-of-experts FFN            [dbrx, llama4-scout]
  rwkv   — RWKV-6 'Finch' (attention-free)           [rwkv6]
  hybrid — parallel attention + SSM heads (Hymba)    [hymba]
  encdec — encoder–decoder with cross-attention      [seamless-m4t]

``frontend`` marks modality stubs: the backbone consumes precomputed
patch/frame embeddings supplied by input_specs() (assignment rule).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str                       # dense | moe | rwkv | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: int = 0             # 0 → = n_heads
    d_head: int = 0                 # 0 → d_model // n_heads
    # attention details
    qkv_bias: bool = False          # qwen2-style QKV bias
    rope_theta: float = 1e4
    window: Optional[int] = None    # sliding-window size (None = full)
    global_layers: Tuple[int, ...] = ()  # full-attn layers when window set
    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM / RWKV
    ssm_state: int = 0
    ssm_heads: int = 0
    rwkv_head_size: int = 64
    # encoder–decoder
    enc_layers: int = 0
    # modality stub
    frontend: Optional[str] = None  # "patches" | "frames"
    meta_tokens: int = 0            # Hymba learnable prefix tokens
    # numerics / structure
    act: str = "swiglu"             # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    # attention impl knobs (perf)
    q_chunk: int = 512              # online-softmax query block
    kv_chunk: int = 1024
    ssm_chunk: int = 64
    use_pallas: bool = False        # kept for parity; the port routes kernels by device
    # parallelism hints (see distributed/sharding.py)
    seq_shard: bool = False         # sequence-parallel activations (beyond-paper perf)

    @property
    def padded_vocab(self) -> int:
        """Embedding/logits vocab padded to 512 (= 16 tp × 32 lanes) — the
        standard trick so vocab-sharded logits divide any mesh axis.
        Loss/decode mask ids ≥ vocab."""
        return ((self.vocab + 511) // 512) * 512

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.kind == "encdec"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (assignment rule: SSM/hybrid/linear only)."""
        return self.kind in ("rwkv", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
