"""Building blocks of the LM that the ported configs use: dense init,
RMS norm, RoPE, GQA attention (prefill and decode), the MLPs, token
embedding, logits and the padded-vocab mask.

The port of the reference's ``models/layers.py``.  Weights are plain tensors in
dicts, laid out as the reference's (a (d_in, d_out) matrix is applied as
``x @ w``), and the casts follow the reference (RoPE in float32 cast
back, the prefill's attention scores in float32 and its probabilities
rounded to v's dtype before P·V) except in the decode step's attention,
which runs in float32 throughout (see :func:`decode_attention`).

The prefill's attention (causal self-attention at positions 0..S−1, with
or without a sliding window; an encoder's non-causal self-attention; a
decoder's cross-attention over the encoder's output) goes to
``kernels/flash_attention``: the hand-written CUDA kernel for a CUDA
tensor, its plain version (the port of the reference's blockwise
``_block_attn``) for a CPU tensor.  Where a gradient is wanted
(training), the attention is the kernel's ``attention_train``, with the
layer's window, whose backward is the port of the reference's custom
VJP.  Cross-attention (the reference's ``attention(..., kv=enc_out)``)
takes q from the decoder's stream and k, v from the encoder's output,
neither rotated, every query over every one of the encoder's Sk
positions: a non-causal kernel call with Sk ≠ S.  A decode step's
cross-attention (:func:`cross_decode_attention`) is plain float32, as
its self-attention is.  Everything here is differentiable and updates
nothing in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import attention_train, flash_attention_gqa
from ..kernels.flash_attention.ref import KV_CHUNK
from ..distributed.tp import gather as tp_gather
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
    ``positions`` (B, S); N and Kh the heads of ``wq`` and ``wk`` (a tp
    rank's shards hold its own)."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    N, Kh = p["wq"].shape[-1] // dh, p["wk"].shape[-1] // dh
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(B, S, N, dh), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, Kh, dh), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, Kh, dh)


def cross_q(p, cfg: ModelConfig, x):
    """The cross-attention's queries (B, S, N, dh) of the decoder's x,
    not rotated; N the heads of ``wq`` (a tp rank's shard holds its own)."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    return q.reshape(B, S, -1, cfg.head_dim)


def cross_kv(p, cfg: ModelConfig, enc):
    """The cross-attention's k, v (B, Sk, Kh, dh) of the encoder's output
    ``enc`` (B, Sk, D), not rotated (a prefill computes them once a layer
    and the decode steps read them from the cache); Kh the K/V heads of
    ``wk`` (a tp rank's shard holds its own)."""
    B, Sk, _ = enc.shape
    k, v = enc @ p["wk"], enc @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k.reshape(B, Sk, -1, cfg.head_dim), v.reshape(B, Sk, -1, cfg.head_dim)


def attend(p, q, k, v, causal: bool = True, kv_chunk: int = KV_CHUNK, window=None):
    """Attention of q (B, S, N, dh) over k, v (B, Sk, Kh, dh) (a prefill
    or a training step), projected by ``wo``: the reference's
    ``attention`` after :func:`attention_qkv` (self-attention, positions
    0..S−1, causal or not) or after :func:`cross_q` and :func:`cross_kv`
    (cross-attention, non-causal, Sk the encoder's length), through the
    flash_attention kernel, with the layer's sliding ``window`` (None or ≥
    2²⁹: full).  With gradients on and an input that wants one, the
    attention carries the backward (over kv blocks of ``kv_chunk`` keys,
    each over its window's band)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return attention_train(q, k, v, causal, kv_chunk, window) @ p["wo"]
    return flash_attention_gqa(q, k, v, causal, window=window) @ p["wo"]


def decode_attention(p, cfg: ModelConfig, x, cache_k, cache_v, kpos, pos, layer_window=None):
    """Single-token decode against a (B, S_max, Kh, dh) KV cache.

    kpos: (B, S_max) the absolute position in each cache slot (−1 =
    empty); pos: (B,) the current position; ``layer_window``: the layer's
    sliding window (None: full), which leaves the keys at pos − w + 1 ..
    pos, as the reference's.  Returns (out, new k entry, new v entry); the
    caller updates the cache.

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
    if layer_window is not None:
        valid &= (pos[:, None] - kpos) < layer_window
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


def local_kv(k: torch.Tensor, v: torch.Tensor, head0: int, n: int, G: int):
    """The K/V heads (B, S, ·, dh) that the query heads head0..head0+n−1
    read in GQA groups of G (a tp rank's own query heads): the groups they
    cover where G divides n, their one K/V head where n divides G, else one
    K/V head a query head (the kernel then runs with G 1)."""
    if n % G == 0:
        lo = head0 // G
        return k[:, :, lo:lo + n // G], v[:, :, lo:lo + n // G]
    if G % n == 0:
        h = head0 // G
        return k[:, :, h:h + 1], v[:, :, h:h + 1]
    idx = torch.arange(head0, head0 + n, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def decode_attention_tp(p, cfg: ModelConfig, x, cache_k, cache_v, kpos, pos, tp, own: bool,
                        layer_window=None):
    """:func:`decode_attention` on a tp rank's block of the cache's slots
    (``distributed/tp.py``): the rank's query heads' q (``wq`` its shard
    where it holds one) all-gathered over tp, every head's partial
    attention over the rank's own slots (m, l, o: the row max, Σexp and
    the unnormalised P·V, float32), the partials all-gathered and merged
    by log-sum-exp in rank order, the new token's own term added once;
    then the rank's heads' output through its ``wo`` shard (a partial sum
    over tp, which the caller reduces) or every head's through a whole
    ``wo``.  ``own``: False where the cache is whole on every rank (tp does
    not divide its span): only rank 0's slots count.  Returns (out, new k
    entry, new v entry), k and v whole over tp."""
    B = x.shape[0]
    N, Kh, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q, k, v = attention_qkv(p, cfg, x, pos[:, None])
    if q.shape[2] != N:
        q = tp_gather(q, tp, 2)
    valid = (kpos >= 0) & (kpos < pos[:, None]) & own
    if layer_window is not None:
        valid &= (pos[:, None] - kpos) < layer_window
    G = N // Kh
    qg = q.reshape(B, Kh, G, dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, cache_k.float()) / math.sqrt(dh)
    s = torch.where(valid[:, None, None], s, torch.tensor(-1e30, device=s.device))
    m = s.amax(-1)
    pc = torch.exp(s - m[..., None]) * valid[:, None, None]
    o = torch.einsum("bhgs,bshd->bhgd", pc, cache_v.float())
    parts = tp_gather(torch.cat([m[..., None], pc.sum(-1)[..., None], o], -1)[None], tp, 0)
    s_self = torch.einsum("bhgd,bhd->bhg", qg, k[:, 0].float()) / math.sqrt(dh)
    M = torch.maximum(parts[..., 0].amax(0), s_self)
    L = torch.exp(s_self - M)
    O = L[..., None] * v[:, 0, :, None].float()
    for r in range(tp.size):                          # rank order
        w = torch.exp(parts[r, ..., 0] - M)
        L = L + parts[r, ..., 1] * w
        O = O + parts[r, ..., 2:] * w[..., None]
    out = (O / L[..., None]).reshape(B, 1, N * dh)
    n = p["wo"].shape[0] // dh
    if n != N:                                        # the rank's heads, its wo shard
        out = out[..., tp.rank * n * dh:(tp.rank + 1) * n * dh]
    return out.to(x.dtype) @ p["wo"], k, v


def cross_decode_attention(p, cfg: ModelConfig, x, k, v):
    """One decode step's cross-attention: q of x (B, 1, D) over the
    cached k, v (B, Sk, Kh, dh) of the encoder's output, every position
    seen, in float32 as :func:`decode_attention` (no kernel: one query a
    sequence), projected by ``wo``.  The queries are ``wq``'s heads, read
    in groups of k's heads (a tp rank's query heads over the K/V heads they
    read: its own shard's, or :func:`local_kv`'s selection)."""
    B, Kh, dh = x.shape[0], k.shape[2], cfg.head_dim
    q = cross_q(p, cfg, x)
    N = q.shape[2]
    qg = q.reshape(B, Kh, N // Kh, dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(dh)
    out = torch.einsum("bhgs,bshd->bhgd", torch.softmax(s, -1), v.float())
    return out.reshape(B, 1, N * dh).to(x.dtype) @ p["wo"]


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


def mask_pad_logits(cfg: ModelConfig, logits: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Ids ≥ cfg.vocab at −1e30; ``offset``: the id of the logits' first
    column (a tp rank's vocab slice)."""
    ids = offset + torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab, logits, torch.full((), -1e30, dtype=logits.dtype,
                                                           device=logits.device))
