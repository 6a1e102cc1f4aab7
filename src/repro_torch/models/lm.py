"""LM facade of the port: init / prefill / decode, for ``kind="rwkv"``.

The port of the reference's ``models/lm.py`` for the RWKV-6 block.  The
reference stacks each parameter over the layers and scans them; the port
keeps a list of per-layer dicts and loops over it (``convert.lm_params``
unstacks the reference's).  The other block kinds (dense, moe, hybrid,
encdec) wait for later slices (ROADMAP §1 item 11) and raise.

Parameters: ``{"embed": {"tok", "head"}, "layers": [{"ln1", "ln2",
"mix"}, ...], "ln_f"}``.  Decode cache: ``{"layers": [{"S" (B, H, hs, hs)
float32, "x_last_tm", "x_last_cm" (B, D) in the model dtype}, ...],
"pos" (B,) int32}``, where the two ``x_last`` are the *normed* inputs of
the time mix and the channel mix at the last position.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.schema import resolve_device
from . import layers as L
from . import rwkv6 as RWKV
from .config import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_kind(cfg: ModelConfig) -> None:
    if cfg.kind != "rwkv":
        raise NotImplementedError(
            f"{cfg.name}: block kind {cfg.kind!r} is not ported yet; the port runs "
            "kind='rwkv' (ROADMAP §1 item 11)")


def init_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, device=None):
    _check_kind(cfg)
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, dtype, device),
        "ln2": L.init_rmsnorm(cfg.d_model, dtype, device),
        "mix": RWKV.init_rwkv_block(gen, cfg, dtype, device),
    }


def _rwkv_final_state(r, k, v, logw):
    """Terminal WKV state after a full sequence (B,S,H,hs)→(B,H,hs,hs)."""
    cum = torch.cumsum(logw, dim=1)
    total = cum[:, -1:]
    kW = k * torch.exp(torch.clamp(total - cum, -60.0, 0.0))
    return torch.einsum("bshk,bshd->bhkd", kW, v)


class Model:
    """One LM config on one device (``"cuda"`` unless the caller asks for
    the CPU; a CUDA device on a host without one raises)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        _check_kind(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------- init --
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random weights drawn from ``gen`` (on its own device), placed
        on the model's device."""
        cfg, dt, dev = self.cfg, _dtype(self.cfg), self.device
        return {
            "embed": L.init_embed(gen, cfg, dt, dev),
            "layers": [init_block(gen, cfg, dt, dev) for _ in range(cfg.n_layers)],
            "ln_f": L.init_rmsnorm(cfg.d_model, dt, dev),
        }

    # ----------------------------------------------------------- prefill --
    def prefill(self, params, batch):
        """Full-sequence forward building the decode cache.  batch:
        ``{"tokens": (B, S) int}``.  Returns (last_logits (B, padded
        vocab) float32, ids ≥ vocab at −1e30, cache)."""
        cfg = self.cfg
        h = L.embed(params["embed"], batch["tokens"].to(self.device))
        B, S = h.shape[:2]
        layers = []
        for p in params["layers"]:
            h, lc = self._prefill_block(p, h)
            layers.append(lc)
        cache = {"layers": layers,
                 "pos": torch.full((B,), S, dtype=torch.int32, device=self.device)}
        h = L.rmsnorm(h, params["ln_f"]["scale"], cfg.norm_eps)
        logits = L.unembed(params["embed"], cfg, h[:, -1]).float()
        return L.mask_pad_logits(cfg, logits), cache

    def _prefill_block(self, p, x):
        """One block: the WKV heads are computed once, for the kernel and
        for the terminal state (the reference reruns the projections)."""
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
        heads, g = RWKV.wkv_inputs(p["mix"], cfg, h)
        x = x + RWKV.time_mix_out(p["mix"], cfg, h, heads, g)
        S_fin = _rwkv_final_state(*heads)
        h2 = L.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
        x = x + RWKV.channel_mix(p["mix"], cfg, h2)
        return x, {"S": S_fin, "x_last_tm": h[:, -1], "x_last_cm": h2[:, -1]}

    # ------------------------------------------------------------ decode --
    def decode_step(self, params, cache, tokens):
        """One token for every sequence.  tokens: (B,) → (logits, cache);
        the cache passed in is left as it was."""
        cfg = self.cfg
        h = L.embed(params["embed"], tokens.to(self.device)[:, None])
        layers = []
        for p, lc in zip(params["layers"], cache["layers"]):
            h, new_lc = self._decode_block(p, h, lc)
            layers.append(new_lc)
        h = L.rmsnorm(h, params["ln_f"]["scale"], cfg.norm_eps)
        logits = L.mask_pad_logits(cfg, L.unembed(params["embed"], cfg, h).float()[:, 0])
        return logits, {"layers": layers, "pos": cache["pos"] + 1}

    def _decode_block(self, p, x, lc):
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
        out, st = RWKV.time_mix_step(p["mix"], cfg, h, {"S": lc["S"], "x_last": lc["x_last_tm"]})
        x = x + out
        h2 = L.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
        x = x + RWKV.channel_mix(p["mix"], cfg, h2, x_last=lc["x_last_cm"])
        return x, {"S": st["S"], "x_last_tm": h[:, 0], "x_last_cm": h2[:, 0]}

    # ------------------------------------------------------- cache specs --
    def init_cache(self, batch_size: int, max_len: int):
        """Zero-filled decode cache at position ``max_len``."""
        cfg, dt, dev = self.cfg, _dtype(self.cfg), self.device
        H, hs = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
        return {
            "layers": [{"S": torch.zeros(batch_size, H, hs, hs, dtype=torch.float32, device=dev),
                        "x_last_tm": torch.zeros(batch_size, cfg.d_model, dtype=dt, device=dev),
                        "x_last_cm": torch.zeros(batch_size, cfg.d_model, dtype=dt, device=dev)}
                       for _ in range(cfg.n_layers)],
            "pos": torch.full((batch_size,), max_len, dtype=torch.int32, device=dev),
        }
