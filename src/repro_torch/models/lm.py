"""LM facade of the port: init / training loss / prefill / decode, for
``kind="rwkv"`` and ``kind="dense"``.

The port of the reference's ``models/lm.py`` for the RWKV-6 block and
the dense (GQA transformer) block.  The reference stacks each parameter
over the layers and scans them; the port keeps a list of per-layer dicts
and loops over it (``convert.lm_params`` unstacks the reference's).  The
other block kinds (moe, hybrid, encdec), sliding-window attention and
the modality front ends wait for later slices (ROADMAP §1 item 7) and
raise.

Parameters: ``{"embed": {"tok", "head"}, "layers": [...], "ln_f"}``, a
layer ``{"ln1", "ln2", "mix"}`` (rwkv) or ``{"ln1", "ln2", "attn",
"mlp"}`` (dense).  :func:`stack_layers` gives the reference's layout, the
layers as one dict of tensors stacked over a leading layer axis (the
trainer's and the checkpoint's), and :func:`layer_views` the list of
per-layer views of such stacked tensors.  Decode cache: ``{"layers":
[...], "pos" (B,) int32}``, a layer
- rwkv: ``{"S" (B, H, hs, hs) float32, "x_last_tm", "x_last_cm" (B, D)
  in the model dtype}``, the two ``x_last`` the *normed* inputs of the
  time mix and the channel mix at the last position;
- dense: ``{"k", "v" (B, span, Kh, dh) in the model dtype, "kpos" (B,
  span) int32}``, the absolute position held in each slot (−1: empty).
  Decode writes position p at slot p mod span, as the reference does,
  and a step at position p reads positions 0..p−1: a step at p > span,
  whose context the cache no longer holds, raises.  (The reference's
  prefill cache has span = S, and its second decode step runs without
  position 0, which its first overwrote: ROADMAP §3.)
  ``prefill(..., max_len)`` gives the cache room for the decode tokens
  (span = max(max_len, S)).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from ..core.schema import resolve_device
from . import layers as L
from . import rwkv6 as RWKV
from .config import ModelConfig

KINDS = ("rwkv", "dense")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_kind(cfg: ModelConfig) -> None:
    if cfg.kind not in KINDS or cfg.frontend or cfg.meta_tokens or cfg.window:
        raise NotImplementedError(
            f"{cfg.name}: block kind {cfg.kind!r} (frontend {cfg.frontend!r}, "
            f"{cfg.meta_tokens} meta tokens, window {cfg.window}) is not ported yet; the "
            f"port runs kinds {KINDS} with full attention on token ids alone (ROADMAP §1 "
            f"item 7)")


def init_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, device=None):
    _check_kind(cfg)
    p = {"ln1": L.init_rmsnorm(cfg.d_model, dtype, device),
         "ln2": L.init_rmsnorm(cfg.d_model, dtype, device)}
    if cfg.kind == "rwkv":
        p["mix"] = RWKV.init_rwkv_block(gen, cfg, dtype, device)
    else:
        p["attn"] = L.init_attention(gen, cfg, dtype, device)
        p["mlp"] = L.init_mlp(gen, cfg, dtype, device)
    return p


def stack_layers(params) -> Dict[str, Any]:
    """``params`` with its per-layer list stacked into one dict of
    tensors of a leading layer axis (new tensors)."""
    def stack(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: stack([it[k] for it in items]) for k in first}
        return torch.stack(items)
    return {**params, "layers": stack(params["layers"])}


def layer_views(params) -> Dict[str, Any]:
    """``params`` in the stacked layout with its layers as a list of
    per-layer dicts of views (``t[i]``): writing the stacked tensors
    updates the views."""
    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} if isinstance(t, dict) else t[i]
    n = params["layers"]["ln1"]["scale"].shape[0]          # every block kind has ln1
    return {**params, "layers": [pick(params["layers"], i) for i in range(n)]}


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

    # -------------------------------------------------------------- loss --
    def loss(self, params, batch):
        """Next-token cross-entropy, the reference's ``Model.loss``: (ce +
        1e-4 · z-loss + aux, {"ce", "aux", "tokens"}), over
        ``batch["tokens"]`` (B, S) with an optional ``loss_mask``; other
        entries of the batch (a weighted pipeline's ``doc_ids``) are not
        read.  Each block runs under activation checkpointing when
        ``cfg.remat`` (the reference's ``jax.checkpoint``), so its
        attention's or its WKV's forward runs twice a backward pass."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"]).to(self.device).long()
        h = L.embed(params["embed"], tokens)
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32, device=self.device).repeat(B, 1)
        block = self._block_train if cfg.kind == "dense" else self._block_train_rwkv
        for p in params["layers"]:
            if cfg.remat:
                h = torch.utils.checkpoint.checkpoint(block, p, h, positions,
                                                      use_reentrant=False)
            else:
                h = block(p, h, positions)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        h = L.rmsnorm(h, params["ln_f"]["scale"], cfg.norm_eps)
        logits = L.mask_pad_logits(cfg, L.unembed(params["embed"], cfg, h[:, :-1]).float())
        targets = tokens[:, 1:]
        mask = batch.get("loss_mask")
        mask = (torch.ones(targets.shape, dtype=torch.float32, device=self.device) if mask is None
                else torch.as_tensor(mask).to(self.device)[:, :targets.shape[1]].float())
        lse = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = ((lse - gold) * mask).sum() / denom
        zloss = 1e-4 * torch.square(lse * mask).sum() / denom
        return loss + zloss + aux, {"ce": loss, "aux": aux, "tokens": denom}

    def _block_train(self, p, x, positions):
        """One dense block of the training forward (no cache)."""
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
        q, k, v = L.attention_qkv(p["attn"], cfg, h, positions)
        x = x + L.attend(p["attn"], q, k, v, kv_chunk=cfg.kv_chunk)
        h2 = L.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], cfg, h2)

    def _block_train_rwkv(self, p, x, positions=None):
        """One RWKV-6 block of the training forward, the reference's
        ``block_train``: its WKV carries a gradient through the
        rwkv6_chunk kernels' ``autograd.Function``, from a zero state."""
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
        x = x + RWKV.time_mix(p["mix"], cfg, h)
        h2 = L.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
        return x + RWKV.channel_mix(p["mix"], cfg, h2)

    # ----------------------------------------------------------- prefill --
    def prefill(self, params, batch, max_len: Optional[int] = None):
        """Full-sequence forward building the decode cache.  batch:
        ``{"tokens": (B, S) int}``; ``max_len``: the positions the dense
        cache holds (S + the decode tokens to come; None: S, the
        reference's layout, which has room for one decode step).  Returns (last_logits (B, padded vocab)
        float32, ids ≥ vocab at −1e30, cache)."""
        cfg = self.cfg
        h = L.embed(params["embed"], batch["tokens"].to(self.device))
        B, S = h.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=self.device).repeat(B, 1)
        layers = []
        for p in params["layers"]:
            if cfg.kind == "rwkv":
                h, lc = self._prefill_rwkv(p, h)
            else:
                h, lc = self._prefill_dense(p, h, positions, max_len)
            layers.append(lc)
        cache = {"layers": layers,
                 "pos": torch.full((B,), S, dtype=torch.int32, device=self.device)}
        h = L.rmsnorm(h, params["ln_f"]["scale"], cfg.norm_eps)
        logits = L.unembed(params["embed"], cfg, h[:, -1]).float()
        return L.mask_pad_logits(cfg, logits), cache

    def _prefill_rwkv(self, p, x):
        """One block: the WKV call gives the output and the terminal state
        (the reference reruns the projections and takes the state in a
        second pass over the sequence)."""
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
        heads, g = RWKV.wkv_inputs(p["mix"], cfg, h)
        tm, S_fin = RWKV.time_mix_out(p["mix"], cfg, h, heads, g, return_state=True)
        x = x + tm
        h2 = L.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
        x = x + RWKV.channel_mix(p["mix"], cfg, h2)
        return x, {"S": S_fin, "x_last_tm": h[:, -1], "x_last_cm": h2[:, -1]}

    def _prefill_dense(self, p, x, positions, max_len):
        """One block: K and V are computed once, for the attention and for
        the cache (the reference computes them twice)."""
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
        q, k, v = L.attention_qkv(p["attn"], cfg, h, positions)
        x = x + L.attend(p["attn"], q, k, v)
        h2 = L.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], cfg, h2)
        B, S = positions.shape
        room = max(max_len or S, S) - S
        if not room:
            return x, {"k": k, "v": v, "kpos": positions}
        pad = lambda t: torch.cat([t, t.new_zeros((B, room) + t.shape[2:])], 1)
        return x, {"k": pad(k), "v": pad(v),
                   "kpos": torch.cat([positions, positions.new_full((B, room), -1)], 1)}

    # ------------------------------------------------------------ decode --
    def decode_step(self, params, cache, tokens):
        """One token for every sequence.  tokens: (B,) → (logits, cache);
        the cache passed in is left as it was.  A dense model raises where
        the cache lacks room for the position (see the module docstring)."""
        cfg = self.cfg
        pos = cache["pos"]
        if cfg.kind == "dense":
            span = cache["layers"][0]["k"].shape[1]
            if int(pos.max()) > span:
                raise ValueError(
                    f"decode at position {int(pos.max())} needs the {int(pos.max())} positions "
                    f"before it, but the KV cache holds {span}: give prefill a max_len of the "
                    f"prompt plus every decode token")
        h = L.embed(params["embed"], tokens.to(self.device)[:, None])
        layers = []
        for p, lc in zip(params["layers"], cache["layers"]):
            if cfg.kind == "rwkv":
                h, new_lc = self._decode_rwkv(p, h, lc)
            else:
                h, new_lc = self._decode_dense(p, h, lc, pos)
            layers.append(new_lc)
        h = L.rmsnorm(h, params["ln_f"]["scale"], cfg.norm_eps)
        logits = L.mask_pad_logits(cfg, L.unembed(params["embed"], cfg, h).float()[:, 0])
        return logits, {"layers": layers, "pos": pos + 1}

    def _decode_rwkv(self, p, x, lc):
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
        out, st = RWKV.time_mix_step(p["mix"], cfg, h, {"S": lc["S"], "x_last": lc["x_last_tm"]})
        x = x + out
        h2 = L.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
        x = x + RWKV.channel_mix(p["mix"], cfg, h2, x_last=lc["x_last_cm"])
        return x, {"S": st["S"], "x_last_tm": h[:, 0], "x_last_cm": h2[:, 0]}

    def _decode_dense(self, p, x, lc, pos):
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
        out, k_new, v_new = L.decode_attention(p["attn"], cfg, h, lc["k"], lc["v"], lc["kpos"],
                                               pos)
        slot = pos[:1].long() % lc["k"].shape[1]    # every row at pos[0]'s slot, as the reference
        new_lc = {"k": lc["k"].index_copy(1, slot, k_new),
                  "v": lc["v"].index_copy(1, slot, v_new),
                  "kpos": lc["kpos"].index_copy(1, slot, pos[:, None])}
        x = x + out
        h2 = L.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], cfg, h2), new_lc

    # ------------------------------------------------------- cache specs --
    def init_cache(self, batch_size: int, max_len: int):
        """Zero-filled decode cache at position ``max_len``."""
        cfg, dt, dev = self.cfg, _dtype(self.cfg), self.device
        B = batch_size
        layers = []
        for _ in range(cfg.n_layers):
            if cfg.kind == "rwkv":
                H, hs = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
                layers.append({"S": torch.zeros(B, H, hs, hs, dtype=torch.float32, device=dev),
                               "x_last_tm": torch.zeros(B, cfg.d_model, dtype=dt, device=dev),
                               "x_last_cm": torch.zeros(B, cfg.d_model, dtype=dt, device=dev)})
                continue
            kv = lambda: torch.zeros(B, max_len, cfg.kv_heads, cfg.head_dim, dtype=dt, device=dev)
            kpos = torch.arange(max_len, dtype=torch.int32, device=dev)
            layers.append({"k": kv(), "v": kv(), "kpos": kpos.repeat(B, 1)})
        return {"layers": layers,
                "pos": torch.full((B,), max_len, dtype=torch.int32, device=dev)}
