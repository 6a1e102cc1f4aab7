"""Building blocks of the LM that the ported configs use: dense init,
RMS norm, RoPE, GQA attention (prefill and decode), the MLPs, token
embedding, logits and the padded-vocab mask.

The port of the reference's ``models/layers.py``.  Weights are plain tensors in
dicts, laid out as the reference's (a (d_in, d_out) matrix is applied as
``x @ w``), and the casts follow the reference (RoPE in float32 cast
back, the prefill's attention scores in float32 and its probabilities
rounded to v's dtype before P·V) except in the decode step's attention,
which runs in float32 throughout (see :func:`decode_attention`).

The prefill's attention (causal self-attention with no window at
positions 0..S−1) goes to ``kernels/flash_attention``: the hand-written
CUDA kernel for a CUDA tensor, its plain version (the port of the
reference's blockwise ``_block_attn``) for a CPU tensor.  Where a
gradient is wanted (training), the attention is the kernel's
``attention_train``, whose backward is the port of the reference's
custom VJP.  Everything here is differentiable and updates nothing in
place.  Windowed and cross-attention wait for the configs that use them
(ROADMAP §1 item 7).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import attention_train, flash_attention_gqa
from ..kernels.flash_attention.ref import KV_CHUNK
from .config import ModelConfig


def _dense_init(gen: torch.Generator, shape, dtype: torch.dtype, scale: float = 1.0,
                device=None) -> torch.Tensor:
    """N(0, scale²/fan_in) weights drawn in float32 from ``gen`` on its
    device, then cast to ``dtype`` and moved to ``device``."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    x = torch.randn(shape, generator=gen, device=gen.device) * (scale / math.sqrt(fan_in))
    return x.to(device=device or gen.device, dtype=dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) · w, computed in float32 and cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


def init_rmsnorm(d: int, dtype: torch.dtype, device=None):
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


# ------------------------------------------------------------------ rope --

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, N, dh) rotated over its last dim by ``positions``
    (..., S); computed in float32 and cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].float() * freqs                   # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


# ------------------------------------------------------------- attention --

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, device=None):
    D, N, Kh, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    dense = lambda shape, scale=1.0: _dense_init(gen, shape, dtype, scale, device=device)
    p = {"wq": dense((D, N * dh)), "wk": dense((D, Kh * dh)), "wv": dense((D, Kh * dh)),
         "wo": dense((N * dh, D), 1.0 / math.sqrt(2 * cfg.n_layers))}
    if cfg.qkv_bias:
        dev = device or gen.device
        for name, width in (("bq", N * dh), ("bk", Kh * dh), ("bv", Kh * dh)):
            p[name] = torch.zeros(width, dtype=dtype, device=dev)
    return p


def attention_qkv(p, cfg: ModelConfig, x, positions):
    """q (B, S, N, dh) and k, v (B, S, Kh, dh) of x, q and k rotated by
    ``positions`` (B, S)."""
    B, S, _ = x.shape
    N, Kh, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(B, S, N, dh), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, Kh, dh), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, Kh, dh)


def attend(p, q, k, v, causal: bool = True, kv_chunk: int = KV_CHUNK):
    """Self-attention of q over k, v at positions 0..S−1 (a prefill or a
    training step), projected by ``wo``: the reference's ``attention``
    after :func:`attention_qkv`, through the flash_attention kernel.  With
    gradients on and an input that wants one, the attention carries the
    backward (over kv blocks of ``kv_chunk`` keys)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return attention_train(q, k, v, causal, kv_chunk) @ p["wo"]
    return flash_attention_gqa(q, k, v, causal) @ p["wo"]


def decode_attention(p, cfg: ModelConfig, x, cache_k, cache_v, kpos, pos):
    """Single-token decode against a (B, S_max, Kh, dh) KV cache.

    kpos: (B, S_max) the absolute position in each cache slot (−1 =
    empty); pos: (B,) the current position.  Returns (out, new k entry,
    new v entry); the caller updates the cache.

    The scores, the probabilities and P·V are float32 whatever the cache's
    dtype.  The reference rounds the scores, the probabilities and the
    unnormalised P·V to a bf16 cache's dtype here, three roundings that
    the prefill's kernel does not make at all or makes elsewhere, and
    which moved a bf16 decode step further from the prefill of the same
    tokens (PERF.md §6)."""
    B, S, _ = x.shape
    assert S == 1
    N, Kh, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q, k, v = attention_qkv(p, cfg, x, pos[:, None])
    valid = (kpos >= 0) & (kpos < pos[:, None])
    G = N // Kh
    qg = q.reshape(B, Kh, G, dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, cache_k.float()) / math.sqrt(dh)
    s_self = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(dh)   # the token itself
    s = torch.where(valid[:, None, None], s, torch.tensor(-1e30, device=s.device))
    m = torch.maximum(s.amax(-1), s_self[..., 0])
    p_cache = torch.exp(s - m[..., None])
    p_self = torch.exp(s_self[..., 0] - m)
    denom = p_cache.sum(-1) + p_self
    out = torch.einsum("bhgs,bshd->bhgd", p_cache, cache_v.float())
    out = out + p_self[..., None] * v[:, 0, :, None].float()
    out = (out / denom[..., None]).reshape(B, 1, N * dh)
    return out.to(x.dtype) @ p["wo"], k, v


# ------------------------------------------------------------------- mlp --

def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, device=None,
             d_ff=None):
    d_ff = d_ff or cfg.d_ff
    dense = lambda shape, scale=1.0: _dense_init(gen, shape, dtype, scale, device=device)
    p = {"w_up": dense((cfg.d_model, d_ff)),
         "w_down": dense((d_ff, cfg.d_model), 1.0 / math.sqrt(2 * cfg.n_layers))}
    if cfg.act == "swiglu":
        p["w_gate"] = dense((cfg.d_model, d_ff))
    return p


def mlp(p, cfg: ModelConfig, x):
    """SwiGLU, or GELU in the reference's (tanh) form."""
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# ------------------------------------------------------------ embeddings --

def init_embed(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, device=None):
    V = cfg.padded_vocab
    tok = torch.randn((V, cfg.d_model), generator=gen, device=gen.device) * 0.02
    p = {"tok": tok.to(device=device or gen.device, dtype=dtype)}
    if not cfg.tie_embeddings:
        p["head"] = _dense_init(gen, (cfg.d_model, V), dtype, device=device)
    return p


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding: the plain gather of the reference's single-device branch."""
    return p["tok"][tokens]


def unembed(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits over the *padded* vocab; callers mask ids ≥ cfg.vocab."""
    if cfg.tie_embeddings:
        return x @ p["tok"].T
    return x @ p["head"]


def mask_pad_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab, logits, torch.full((), -1e30, dtype=logits.dtype,
                                                           device=logits.device))
