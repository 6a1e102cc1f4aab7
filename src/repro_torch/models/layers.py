"""Building blocks of the LM that the ported configs use: dense init,
RMS norm, token embedding, logits and the padded-vocab mask.

A subset of the reference's ``models/layers.py``.  Weights are plain
tensors in dicts, laid out as the reference's (a (d_in, d_out) matrix is
applied as ``x @ w``).  Attention, RoPE and the MLPs wait for the slice
that serves an attention model (ROADMAP §1 item 11).
"""
from __future__ import annotations

import math

import torch

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
