"""LM facade of the port: init / training loss / prefill / decode, for
the five block kinds of the reference: ``kind="rwkv"``, ``"dense"``,
``"hybrid"`` (Hymba), ``"moe"`` (DBRX, Llama-4-Scout) and ``"encdec"``
(seamless-M4T), and the two modality front ends, ``frontend="patches"``
(LLaVA-NeXT: precomputed patch embeddings before the tokens) and
``"frames"`` (the encdec's precomputed speech frames, the encoder's input).

The port of the reference's ``models/lm.py`` for the RWKV-6 block, the
dense (GQA transformer) block, the hybrid block, whose attention and
SSM branch (``models/ssm.py``) read the same normed input and are
averaged after a norm each, 0.5·(rmsnorm(attn, bn_a) + rmsnorm(ssm,
bn_s)), the MoE block, the dense block with its MLP replaced by
``models/moe.py``'s FFN (capacity factor 4.0 in prefill and decode, as
the reference's; the config's own in the training loss, where pairs past
the capacity drop and the Switch aux loss of every layer joins the
loss), and the encdec pair: an encoder of ``cfg.enc_layers`` dense blocks,
non-causal over the frames (RoPE at 0..Se−1), then ``enc_ln_f``, and a
decoder of dense blocks that each add a cross-attention (``ln_x``,
``xattn``: q from the decoder, k and v from the encoder's output, no
RoPE, every frame seen) after their self-attention.  The reference
stacks each parameter over the layers and scans them; the port keeps a
list of per-layer dicts and loops over it (``convert.lm_params``
unstacks the reference's).

Sliding windows: layer i attends over a window of ``cfg.window`` keys
unless i is one of ``cfg.global_layers`` (``Model.windows[i]``, None for
full attention; global layers past the model's depth, as in a config cut
to fewer layers, are ignored).  Prefixes, as the reference's
``_embed_inputs`` puts them: ``batch["patches"]`` (B, P, D) (with
``frontend="patches"``) go before the tokens, cast to the model dtype,
and ``cfg.meta_tokens`` learned embeddings before those: positions
0..M−1 the meta tokens, M..M+P−1 the patches, the tokens from M + P on.
The loss drops the M + P prefix positions after ``ln_f``, before the
logits.  Meta tokens fall out of a query's window like any other
position, as in the reference; the Hymba paper keeps them visible to
every query (ROADMAP §3).  An encdec batch holds ``src_frames`` (B, Se,
D), the encoder's input, cast to the model dtype.

Parameters: ``{"embed": {"tok", "head"}, "layers": [...], "ln_f"}`` (and
``"meta"`` (M, D) with meta tokens; ``"enc_layers": [...]`` and
``"enc_ln_f"`` for encdec), a layer ``{"ln1", "ln2", "mix"}`` (rwkv),
``{"ln1", "ln2", "attn", "mlp"}`` (dense, and an encoder layer), that with
``"ssm", "bn_a", "bn_s"`` (hybrid) or ``"ln_x", "xattn"`` (a decoder
layer of encdec), or with ``"moe"`` in place of ``"mlp"`` (moe).
:func:`stack_layers` gives the reference's layout, the layers (and the
encoder's) as one dict of tensors stacked over a leading layer axis (the
trainer's and the checkpoint's), and :func:`layer_views` the lists of
per-layer views of such stacked tensors.  Decode cache:
``{"layers": [...], "pos" (B,) int32}`` (and for encdec ``"enc_out"``
(B, Se, D), the encoder's normed output, and ``"enc_pos"`` (B, Se) int32,
as the reference's), a layer
- rwkv: ``{"S" (B, H, hs, hs) float32, "x_last_tm", "x_last_cm" (B, D)
  in the model dtype}``, the two ``x_last`` the *normed* inputs of the
  time mix and the channel mix at the last position;
- dense, hybrid, moe and encdec: ``{"k", "v" (B, span, Kh, dh) in the
  model dtype, "kpos" (B, span) int32}``, the absolute position held in
  each slot (−1: empty), for hybrid ``"ssm": {"h" (B, H, N, P) float32,
  "conv" (B, 4, d_inner)}``, and for encdec the layer's cross-attention
  ``"xk", "xv"`` (B, Se, Kh, dh) of ``enc_out``, computed once at prefill
  (the reference projects ``enc_out`` again every step: the same
  numbers).  Position p sits at slot p mod span, in prefill and in
  decode.  A global layer's span is every position the model will see,
  a windowed layer's min(w, that): the window needs no more.  A step at
  position p reads positions p − w + 1..p − 1 (0..p − 1 for a global
  layer); a step whose context the cache no longer holds raises.  (The
  reference's prefill cache has span = S, and its second decode step runs
  without position 0, which its first overwrote; its windowed layers
  keep the prompt's last min(w, S) positions and shift, which drops
  in-window positions when S < w: ROADMAP §3.)  ``prefill(...,
  max_len)`` gives the cache room for the decode tokens: ``max_len``
  counts the caller's token positions (prompt and decode tokens); the
  model adds its M meta and P patch positions itself, here and in
  :meth:`Model.init_cache`.

On a mesh (``distributed/sharding.py``) the parameters (and a decode
cache's layers) may hold :class:`~repro_torch.distributed.sharding.Placed`
leaves: each block takes its own leaves whole (``sharding.take``) before
it computes, inside its activation checkpoint, so a recompute gathers
again and the peak holds one block's weights; the embedding, the final
norm and the head are taken where they are read.  On plain tensors
``take`` is the identity.  ``sharding.constrain`` marks the reference's
ten activation constraints (its ``models/lm.py``), no-ops outside a mesh.

Tensor and sequence parallelism (any config given a tp context ``tpc``,
``distributed/tp.py``, which the placed steps pass on a mesh whose
"model" axis has more than one rank): the blocks' leaves arrive as the
rank's shards of ``wq``, ``wo`` and the MLP's (its heads and d_ff) and of
the embedding (its vocab rows), ``wk``/``wv`` whole; an MoE block's as its
E/tp experts and its shared expert's d_ff slice (the FFN expert-parallel:
``moe.moe_ffn_tp``), an RWKV block's as its heads' columns of the time
mix and its d_ff slice of the channel mix (``rwkv6.local_view``,
``channel_mix``), a hybrid block's SSM as its heads' columns of ``wx``,
``wB``, ``wC`` and ``conv`` and their rows of ``wo`` (``ssm.local_view``),
a decoder block's cross-attention as its heads' ``wq`` and ``wo`` and its
K/V heads' ``wk`` and ``wv``, an encoder block's self-attention as its
heads' and its K/V heads' (no decode cache holds the encoder's k, v).  A
shard never cuts a head: where tp does not divide a branch's heads every
rank computes all of them.  The
embedding is vocab-parallel; the meta tokens and the patches join it as
rank 0's part of its sum over tp, which is scattered to the rank's
sequence slice: the residual stream between blocks is (B, (M + P + S)/tp,
D) where tp divides M + P + S (else whole).  A block norms its slice,
gathers the sequence, computes its heads (each reading its GQA group's
K/V head) and its d_ff columns, and scatters the partial sum back to its
slice.  The hybrid block sums each branch's partial output over tp before
its norm (one reduce-scatter of the two stacked, :func:`_mix`), the
norms and the mix on the rank's slice.  The encoder runs its dense
blocks, non-causal, on the rank's slice of the frames (no collective to
split them), ``enc_ln_f`` on the slice, and its output is gathered over
the sequence once a pass; each decoder block norms its slice with
``ln_x``, gathers it, and attends from its heads' queries over its K/V
heads' k, v of the whole encoder output.  The loss gathers the final
normed stream, takes the rank's vocab columns of the logits and a
vocab-parallel cross-entropy and z-loss.  A prefill keeps the rank's
block of span/tp cache slots; a decode step attends over them
(``layers.decode_attention_tp``), and only the rank owning slot pos mod
span writes the new k, v; an RWKV layer's state holds the rank's heads
and its ``x_last`` pair the rank's slice of D, gathered in a decode step;
a hybrid layer's SSM state its heads and its conv tail their columns (the
rank's slice of d_inner where tp divides it but not the heads, gathered in
a decode step); an encdec cache its K/V heads' cross k, v (all of them
where tp does not divide the K/V heads) and its slice of ``enc_out`` and
``enc_pos`` where tp divides the frames.  The logits a prefill or decode
step returns are the rank's vocab columns.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from ..core.schema import resolve_device
from ..distributed import tp as TP
from ..distributed.sharding import constrain, take
from . import layers as L
from . import moe as MOE
from . import rwkv6 as RWKV
from . import ssm as SSM
from .config import ModelConfig

KINDS = ("rwkv", "dense", "hybrid", "moe", "encdec")
FRONTENDS = (None, "patches", "frames")
STACKS = ("layers", "enc_layers")  # the parameter entries that hold a list of layers
SERVE_CAPACITY = 4.0               # the MoE capacity factor of prefill and decode


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_kind(cfg: ModelConfig) -> None:
    if cfg.kind not in KINDS or cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: unknown block kind {cfg.kind!r} or frontend "
                         f"{cfg.frontend!r}; the port runs kinds {KINDS} and front ends "
                         f"{FRONTENDS}")


def init_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, device=None,
               cross: bool = False):
    """One block's weights; ``cross``: a decoder block of encdec, which adds
    the cross-attention's ``ln_x`` and ``xattn`` (the reference's
    ``init_cross_block``)."""
    _check_kind(cfg)
    p = {"ln1": L.init_rmsnorm(cfg.d_model, dtype, device),
         "ln2": L.init_rmsnorm(cfg.d_model, dtype, device)}
    if cfg.kind == "rwkv":
        p["mix"] = RWKV.init_rwkv_block(gen, cfg, dtype, device)
        return p
    p["attn"] = L.init_attention(gen, cfg, dtype, device)
    if cfg.kind == "moe":
        p["moe"] = MOE.init_moe(gen, cfg, dtype, device)
        return p
    p["mlp"] = L.init_mlp(gen, cfg, dtype, device)
    if cfg.kind == "hybrid":
        p["ssm"] = SSM.init_ssm(gen, cfg, dtype, cfg.n_heads * cfg.head_dim, device)
        p["bn_a"] = L.init_rmsnorm(cfg.d_model, dtype, device)
        p["bn_s"] = L.init_rmsnorm(cfg.d_model, dtype, device)
    if cross:
        p["ln_x"] = L.init_rmsnorm(cfg.d_model, dtype, device)
        p["xattn"] = L.init_attention(gen, cfg, dtype, device)
    return p


def stack_layers(params) -> Dict[str, Any]:
    """``params`` with each per-layer list (``layers``, and ``enc_layers``
    where there is one) stacked into one dict of tensors of a leading
    layer axis (new tensors)."""
    def stack(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: stack([it[k] for it in items]) for k in first}
        return torch.stack(items)
    return {**params, **{k: stack(params[k]) for k in STACKS if k in params}}


def layer_views(params) -> Dict[str, Any]:
    """``params`` in the stacked layout with its layers (and the encoder's)
    as lists of per-layer dicts of views (``t[i]``): writing the stacked
    tensors updates the views."""
    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} if isinstance(t, dict) else t[i]

    def views(stacked):
        n = stacked["ln1"]["scale"].shape[0]               # every block kind has ln1
        return [pick(stacked, i) for i in range(n)]
    return {**params, **{k: views(params[k]) for k in STACKS if k in params}}


def _pick(p, name: str):
    """``{name: p[name]}`` taken whole (the one leaf of ``p`` that is read)."""
    return {name: take(p[name])}


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).repeat(B, 1)


class Model:
    """One LM config on one device (``"cuda"`` unless the caller asks for
    the CPU; a CUDA device on a host without one raises)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        _check_kind(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.windows = [None if not cfg.window or i in cfg.global_layers else cfg.window
                        for i in range(cfg.n_layers)]

    # ------------------------------------------------------------- init --
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random weights drawn from ``gen`` (on its own device), placed
        on the model's device."""
        cfg, dt, dev = self.cfg, _dtype(self.cfg), self.device
        encdec = cfg.kind == "encdec"
        params = {
            "embed": L.init_embed(gen, cfg, dt, dev),
            "layers": [init_block(gen, cfg, dt, dev, cross=encdec) for _ in range(cfg.n_layers)],
            "ln_f": L.init_rmsnorm(cfg.d_model, dt, dev),
        }
        if encdec:
            params["enc_layers"] = [init_block(gen, cfg, dt, dev) for _ in range(cfg.enc_layers)]
            params["enc_ln_f"] = L.init_rmsnorm(cfg.d_model, dt, dev)
        if cfg.meta_tokens:
            meta = torch.randn((cfg.meta_tokens, cfg.d_model), generator=gen, device=gen.device)
            params["meta"] = (meta * 0.02).to(device=dev, dtype=dt)
        return params

    def _embed_inputs(self, params, batch, tpc=None):
        """The decoder's input (B, M + P + S, D): the meta tokens, the
        patches (``frontend="patches"``, where the batch holds them) and
        the token embeddings, and the prefix length M + P; with a tp context
        ``tpc``, the vocab-parallel embedding in the residual's layout."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"]).to(self.device).long()
        h = (L.embed(_pick(params["embed"], "tok"), tokens) if tpc is None
             else TP.embed_partial(take(params["embed"]["tok"]), tokens, tpc))
        n_prefix, rest = 0, tpc is not None and tpc.rank > 0   # rank 0's part of the sum over tp
        if cfg.frontend == "patches" and "patches" in batch:
            patches = torch.as_tensor(batch["patches"]).to(device=self.device, dtype=h.dtype)
            if rest:
                patches = torch.zeros_like(patches)
            h, n_prefix = torch.cat([patches, h], 1), patches.shape[1]
        if cfg.meta_tokens:
            meta = take(params["meta"])[None].expand(h.shape[0], -1, -1)
            if rest:               # kept in the graph: every rank's gather sums its gradient
                meta = meta * 0
            h, n_prefix = torch.cat([meta, h], 1), n_prefix + cfg.meta_tokens
        if tpc is not None:                        # the sum over tp, to the residual's layout
            h = TP.leave(h, tpc, TP.seq_parallel(tpc, h.shape[1]), partial=True)
        return constrain(h, "dp", None, None), n_prefix

    def _encode(self, params, batch, remat: bool = False, tpc=None):
        """The encoder's output (B, Se, D) after ``enc_ln_f``, its positions
        0..Se−1 and its blocks' aux (zero: its blocks are dense).  Each
        block non-causal, under activation checkpointing with ``remat``.
        With a tp context the stream is the rank's slice of the frames where
        tp divides Se (cut without a collective), the blocks and
        ``enc_ln_f`` run on it, and the output is gathered over the
        sequence once (its backward reduce-scatters the decoder layers'
        summed gradient)."""
        cfg = self.cfg
        x = torch.as_tensor(batch["src_frames"]).to(device=self.device, dtype=_dtype(cfg))
        pos = _positions(x.shape[0], x.shape[1], self.device)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        sp = TP.seq_parallel(tpc, x.shape[1])
        if sp:
            x = TP.split_seq(x, tpc)
        kw = {} if tpc is None else {"tpc": tpc}
        x = constrain(x, "dp", "tp", None)
        for p in params["enc_layers"]:
            args = (p, x, pos, None, None, False)
            x, a = (torch.utils.checkpoint.checkpoint(self._block_train, *args, use_reentrant=False,
                                                      **kw)
                    if remat else self._block_train(*args, **kw))
            x = constrain(x, "dp", "tp", None)
            aux = aux + a
        x = L.rmsnorm(x, take(params["enc_ln_f"]["scale"]), cfg.norm_eps)
        return TP.enter(x, tpc, sp), pos, aux

    # -------------------------------------------------------------- loss --
    def loss(self, params, batch, tpc=None):
        """Next-token cross-entropy, the reference's ``Model.loss``: (ce +
        1e-4 · z-loss + aux, {"ce", "aux", "tokens"}), over
        ``batch["tokens"]`` (B, S) with an optional ``loss_mask`` (and
        ``patches`` or ``src_frames`` for a front end); other entries of
        the batch (a weighted pipeline's ``doc_ids``) are not read.  The
        prefixes go before the tokens (see the module docstring), each
        layer attends over its own window, and the prefix positions are
        dropped after ``ln_f``, before the logits.  An encdec model runs
        its encoder over ``src_frames`` first and each decoder block
        cross-attends to its output.  ``aux`` adds up every layer's MoE
        load-balance loss (the MoE FFN at the config's capacity factor).
        Each block runs under activation checkpointing when ``cfg.remat``
        (the reference's ``jax.checkpoint``), so its attention's or its
        WKV's forward, and an MoE block's routing, run twice a backward
        pass.  Under a tp context ``tpc`` (module docstring) the logits
        are the rank's vocab columns and the cross-entropy is
        vocab-parallel."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        enc = None
        if cfg.kind == "encdec":
            enc, _, aux = self._encode(params, batch, cfg.remat, tpc)
        tokens = torch.as_tensor(batch["tokens"]).to(self.device).long()
        h, n_prefix = self._embed_inputs(params, batch, tpc)
        S = n_prefix + tokens.shape[1]                 # prefixes counted
        sp = TP.seq_parallel(tpc, S)
        positions = _positions(h.shape[0], S, self.device)
        block = self._block_train_rwkv if cfg.kind == "rwkv" else self._block_train
        kw = {} if tpc is None else {"tpc": tpc}
        h = constrain(h, "dp", "tp", None)
        for p, w in zip(params["layers"], self.windows):
            args = (p, h, positions, w, enc)
            h, a = (torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False, **kw)
                    if cfg.remat else block(*args, **kw))
            h = constrain(h, "dp", "tp", None)
            aux = aux + a
        h = L.rmsnorm(h, take(params["ln_f"]["scale"]), cfg.norm_eps)
        h = TP.enter(h, tpc, sp)[:, n_prefix:]
        logits = constrain(L.unembed(self._head(params), cfg, h[:, :-1]).float(), "dp", None, "tp")
        logits = L.mask_pad_logits(cfg, logits, _vocab_offset(tpc, logits))
        targets = tokens[:, 1:]
        mask = batch.get("loss_mask")
        mask = (torch.ones(targets.shape, dtype=torch.float32, device=self.device) if mask is None
                else torch.as_tensor(mask).to(self.device)[:, :targets.shape[1]].float())
        if tpc is None:
            lse = torch.logsumexp(logits, -1)
            gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        else:
            lse, gold = TP.cross_entropy_parts(logits, targets, tpc)
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = ((lse - gold) * mask).sum() / denom
        zloss = 1e-4 * torch.square(lse * mask).sum() / denom
        return loss + zloss + aux, {"ce": loss, "aux": aux, "tokens": denom}

    def _head(self, params):
        """The embedding leaf the logits read, taken whole."""
        return _pick(params["embed"], "tok" if self.cfg.tie_embeddings else "head")

    def _block_train(self, p, x, positions, window: Optional[int] = None, enc=None,
                     causal: bool = True, tpc=None):
        """One dense, hybrid, moe or encdec block of the training forward
        (no cache), its attention over ``window``, then (a decoder block of
        encdec) its cross-attention over the encoder's output ``enc``;
        ``causal=False`` for an encoder block.  Returns (x, the block's MoE
        aux loss, zero for other kinds).  With a tp context ``tpc`` ``x``
        is the rank's sequence slice where tp divides the sequence, and the
        block computes on the rank's heads and d_ff columns, or its experts
        (module docstring)."""
        cfg = self.cfg
        p = take(p)
        sp = TP.seq_parallel(tpc, positions.shape[1])
        h = constrain(L.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps), "dp", None, None)
        h = TP.enter(h, tpc, sp)
        q, k, v = _local_heads(cfg, *L.attention_qkv(p["attn"], cfg, h, positions), tpc)
        out = L.attend(p["attn"], q, k, v, causal, kv_chunk=cfg.kv_chunk, window=window)
        partial = _sharded(p["attn"]["wo"], cfg.n_heads * cfg.head_dim)
        if cfg.kind == "hybrid":
            ssm, ssm_partial = SSM.local_view(p["ssm"], cfg, tpc)
            out = _mix(p, cfg, out, SSM.ssm_branch(ssm, cfg, h), tpc, sp, (partial, ssm_partial))
        else:
            out = TP.leave(out, tpc, sp, partial)
        x = x + constrain(out, "dp", None, None)
        if enc is not None:
            x = x + constrain(self._cross(p, x, *L.cross_kv(p["xattn"], cfg, enc), tpc, sp),
                              "dp", None, None)
        h2 = constrain(L.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps), "dp", None, None)
        if cfg.kind == "moe" and tpc is None:
            out, aux = MOE.moe_ffn(p["moe"], cfg, h2)
            return x + constrain(out, "dp", None, None), aux
        h2 = TP.enter(h2, tpc, sp)
        if cfg.kind == "moe":
            out, aux = MOE.moe_ffn_tp(p["moe"], cfg, h2, tpc)
            partial = MOE.is_partial(p["moe"], cfg)
        else:
            out, partial = L.mlp(p["mlp"], cfg, h2), _sharded(p["mlp"]["w_down"], cfg.d_ff)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + constrain(TP.leave(out, tpc, sp, partial), "dp", None, None), aux

    def _cross(self, p, x, xk, xv, tpc=None, sp: bool = False):
        """A decoder block's cross-attention output over the encoder's
        k, v (non-causal, through the kernel).  With a tp context ``x`` is
        the residual's layout: normed there, gathered, its heads' queries
        over their K/V heads, the output (a partial sum where ``wo`` is the
        rank's shard) brought back to the residual's layout."""
        cfg = self.cfg
        h = TP.enter(L.rmsnorm(x, p["ln_x"]["scale"], cfg.norm_eps), tpc, sp)
        q, xk, xv = _local_heads(cfg, L.cross_q(p["xattn"], cfg, h), xk, xv, tpc)
        out = L.attend(p["xattn"], q, xk, xv, causal=False, kv_chunk=cfg.kv_chunk)
        return TP.leave(out, tpc, sp, _sharded(p["xattn"]["wo"], cfg.n_heads * cfg.head_dim))

    def _block_train_rwkv(self, p, x, positions, window=None, enc=None, tpc=None):
        """One RWKV-6 block of the training forward, the reference's
        ``block_train``: its WKV carries a gradient through the
        rwkv6_chunk kernels' ``autograd.Function``, from a zero state.
        With a tp context the time mix runs on the rank's heads and the
        channel mix on its d_ff slice (``models/rwkv6.py``)."""
        cfg = self.cfg
        p = take(p)
        sp = TP.seq_parallel(tpc, positions.shape[1])
        h = TP.enter(L.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps), tpc, sp)
        mix, heads_tp = RWKV.local_view(p["mix"], cfg, tpc)
        x = x + TP.leave(RWKV.time_mix(mix, cfg, h, heads_tp), tpc, sp, heads_tp is not None)
        h2 = TP.enter(L.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps), tpc, sp)
        return (x + RWKV.channel_mix(p["mix"], cfg, h2, tpc=tpc, sp=sp),
                torch.zeros((), dtype=torch.float32, device=x.device))

    # ----------------------------------------------------------- prefill --
    def prefill(self, params, batch, max_len: Optional[int] = None, tpc=None):
        """Full-sequence forward building the decode cache.  batch:
        ``{"tokens": (B, S) int}`` (with ``patches`` or ``src_frames`` for
        a front end); ``max_len``: the token positions the cache makes room
        for (S + the decode tokens to come; None: S, the reference's
        layout, which has room for one decode step), the meta and patch
        positions not counted; ``tpc``: a tp context (module docstring).
        Returns (last_logits (B, padded vocab) float32, ids ≥ vocab at
        −1e30, cache)."""
        cfg = self.cfg
        cache: Dict[str, Any] = {}
        enc = None
        if cfg.kind == "encdec":
            enc, enc_pos, _ = self._encode(params, batch, tpc=tpc)
            cache["enc_out"], cache["enc_pos"] = enc, enc_pos
            if TP.seq_parallel(tpc, enc.shape[1]):   # the rank's slice of the frames, as the rules
                cache["enc_out"], cache["enc_pos"] = (TP.local_slice(t, tpc, 1).contiguous()
                                                      for t in (enc, enc_pos))
        h, n_prefix = self._embed_inputs(params, batch, tpc)
        B = h.shape[0]
        S = n_prefix + torch.as_tensor(batch["tokens"]).shape[1]   # S counts the prefixes
        total = S if max_len is None else max(n_prefix + max_len, S)
        positions = _positions(B, S, self.device)
        layers = []
        for i, p in enumerate(params["layers"]):
            if cfg.kind == "rwkv":
                h, lc = self._prefill_rwkv(p, h, tpc, TP.seq_parallel(tpc, S))
            else:
                w = self.windows[i]
                h, lc = self._prefill_attn(p, h, positions, total if w is None else min(w, total),
                                           w, enc, tpc)
            layers.append(lc)
        cache.update(layers=layers, pos=torch.full((B,), S, dtype=torch.int32, device=self.device))
        h = L.rmsnorm(h, take(params["ln_f"]["scale"]), cfg.norm_eps)
        logits = L.unembed(self._head(params), cfg,
                           TP.last_position(h, tpc, TP.seq_parallel(tpc, S))).float()
        return L.mask_pad_logits(cfg, logits, _vocab_offset(tpc, logits)), cache

    def _prefill_rwkv(self, p, x, tpc=None, sp: bool = False):
        """One block: the WKV call gives the output and the terminal state
        (the reference reruns the projections and takes the state in a
        second pass over the sequence).  With a tp context the block
        computes as :meth:`_block_train_rwkv`'s, its state holds the rank's
        heads and its ``x_last`` the whole sequence's last position (B, D),
        kept as the rank's slice of D where the rules split it."""
        cfg = self.cfg
        p = take(p)
        h = TP.enter(L.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps), tpc, sp)
        mix, heads_tp = RWKV.local_view(p["mix"], cfg, tpc)
        heads, g = RWKV.wkv_inputs(mix, cfg, h)
        tm, S_fin = RWKV.time_mix_out(mix, cfg, h, heads, g, return_state=True, tpc=heads_tp)
        x = x + TP.leave(tm, tpc, sp, heads_tp is not None)
        h2 = TP.enter(L.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps), tpc, sp)
        x = x + RWKV.channel_mix(p["mix"], cfg, h2, tpc=tpc, sp=sp)
        last = [h[:, -1], h2[:, -1]]
        if tpc is not None and tpc.divides(cfg.d_model):
            last = [TP.local_slice(t, tpc, 1) for t in last]
        return x, {"S": S_fin, "x_last_tm": last[0], "x_last_cm": last[1]}

    def _prefill_attn(self, p, x, positions, span: int, window: Optional[int], enc=None,
                      tpc=None):
        """One dense, hybrid, moe or encdec decoder block with the layer's
        window; its cache holds the last min(span, S) positions.  K and V
        are computed once, for the attention and for the cache, and the
        hybrid block's SSM branch gives its terminal state as it runs (the
        reference computes both twice); a decoder block of encdec keeps its
        cross-attention's k, v of ``enc``.  Under a tp context the block
        computes as :meth:`_block_train`'s and keeps the rank's block of
        span/tp slots where tp divides the span."""
        cfg = self.cfg
        p = take(p)
        sp = TP.seq_parallel(tpc, positions.shape[1])
        h = TP.enter(L.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps), tpc, sp)
        q, k, v = L.attention_qkv(p["attn"], cfg, h, positions)
        out = L.attend(p["attn"], *_local_heads(cfg, q, k, v, tpc), window=window)
        lc = _ring(k, v, positions, span)
        if tpc is not None and tpc.divides(span):
            lc = {n: TP.local_slice(t, tpc, 1) for n, t in lc.items()}
        partial = _sharded(p["attn"]["wo"], cfg.n_heads * cfg.head_dim)
        if cfg.kind == "hybrid":
            ssm, ssm_partial = SSM.local_view(p["ssm"], cfg, tpc)
            s, lc["ssm"] = SSM.ssm_branch(ssm, cfg, h, return_state=True)
            lc["ssm"]["conv"] = _conv_tail(cfg, lc["ssm"]["conv"], ssm_partial, tpc, out=True)
            out = _mix(p, cfg, out, s, tpc, sp, (partial, ssm_partial))
        else:
            out = TP.leave(out, tpc, sp, partial)
        x = x + out
        if enc is not None:
            lc["xk"], lc["xv"] = L.cross_kv(p["xattn"], cfg, enc)
            x = x + self._cross(p, x, lc["xk"], lc["xv"], tpc, sp)
        out, partial = _ffn(p, cfg, TP.enter(L.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps),
                                             tpc, sp), tpc)
        return x + TP.leave(out, tpc, sp, partial), lc

    # ------------------------------------------------------------ decode --
    def decode_step(self, params, cache, tokens, tpc=None):
        """One token for every sequence.  tokens: (B,) → (logits, cache);
        the cache passed in is left as it was.  A dense model raises where
        the cache lacks room for the position (see the module docstring).
        An encdec decoder block cross-attends to its cached k, v of the
        encoder's output, plain (one query a sequence: no kernel).
        ``tpc``: a tp context (module docstring)."""
        cfg = self.cfg
        pos = cache["pos"]
        spans = self._spans(cache, tpc)
        if cfg.kind != "rwkv" and pos.device.type != "meta":     # meta: no values to check
            self._check_room(spans, int(pos.max()))
        ids = tokens.to(self.device)[:, None]
        h = (L.embed(_pick(params["embed"], "tok"), ids) if tpc is None else
             TP.leave(TP.embed_partial(take(params["embed"]["tok"]), ids.long(), tpc), tpc,
                      False, True))
        layers = []
        for i, (p, lc) in enumerate(zip(params["layers"], cache["layers"])):
            if cfg.kind == "rwkv":
                h, new_lc = self._decode_rwkv(p, h, lc, tpc)
            else:
                h, new_lc = self._decode_attn(p, h, lc, pos, self.windows[i], spans[i], tpc)
            layers.append(new_lc)
        h = L.rmsnorm(h, take(params["ln_f"]["scale"]), cfg.norm_eps)
        logits = L.unembed(self._head(params), cfg, h).float()[:, 0]
        logits = L.mask_pad_logits(cfg, logits, _vocab_offset(tpc, logits))
        return logits, {**cache, "layers": layers, "pos": pos + 1}

    def _spans(self, cache, tpc):
        """Each attention layer's global cache span: a tp context's where
        the cache holds the rank's slots, else the layer's own."""
        if self.cfg.kind == "rwkv":
            return [None] * len(cache["layers"])
        if tpc is not None and tpc.spans is not None:
            return list(tpc.spans)
        return [lc["k"].shape[1] for lc in cache["layers"]]

    def _decode_rwkv(self, p, x, lc, tpc=None):
        """One block's step; with a tp context on the rank's heads (its
        cached state's), the cached ``x_last`` pair, where it holds the
        rank's slice of D, gathered over tp in one collective."""
        cfg = self.cfg
        p, lc = take(p), take(lc)
        x_tm, x_cm = lc["x_last_tm"], lc["x_last_cm"]
        split = x_tm.shape[-1] != cfg.d_model
        if split:
            x_tm, x_cm = TP.gather(torch.stack([x_tm, x_cm], 1), tpc, 2).unbind(1)
        h = L.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
        mix, heads_tp = RWKV.local_view(p["mix"], cfg, tpc)
        out, st = RWKV.time_mix_step(mix, cfg, h, {"S": lc["S"], "x_last": x_tm}, heads_tp)
        x = x + TP.leave(out, tpc, False, heads_tp is not None)
        h2 = L.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
        x = x + RWKV.channel_mix(p["mix"], cfg, h2, x_last=x_cm, tpc=tpc)
        last = [h[:, 0], h2[:, 0]]
        if split:
            last = [TP.local_slice(t, tpc, 1) for t in last]
        return x, {"S": st["S"], "x_last_tm": last[0], "x_last_cm": last[1]}

    def _check_room(self, spans, pos: int) -> None:
        """Raises where a layer's cache no longer holds the positions that a
        step at ``pos`` reads: min(pos, w − 1) of them (pos for a global
        layer) against the layer's (global) span."""
        for span, w in zip(spans, self.windows):
            need = pos if w is None else min(pos, w - 1)
            if need > span:
                raise ValueError(
                    f"decode at position {pos} needs the {need} positions before it, but the KV "
                    f"cache holds {span}: give prefill a max_len of the prompt plus every decode "
                    f"token")

    def _decode_attn(self, p, x, lc, pos, window: Optional[int], span: int, tpc=None):
        cfg = self.cfg
        p, lc = take(p), take(lc)
        h = L.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
        slot = pos[:1].long() % span                # every row at pos[0]'s slot, as the reference
        partial = _sharded(p["attn"]["wo"], cfg.n_heads * cfg.head_dim)
        if tpc is None:
            out, k_new, v_new = L.decode_attention(p["attn"], cfg, h, lc["k"], lc["v"],
                                                   lc["kpos"], pos, layer_window=window)
            new_lc = {**lc, "k": lc["k"].index_copy(1, slot, k_new),
                      "v": lc["v"].index_copy(1, slot, v_new),
                      "kpos": lc["kpos"].index_copy(1, slot, pos[:, None])}
        else:                                       # the rank's slots: its block, or all of them
            n = lc["k"].shape[1]
            split = n != span
            out, k_new, v_new = L.decode_attention_tp(p["attn"], cfg, h, lc["k"], lc["v"],
                                                      lc["kpos"], pos, tpc,
                                                      own=split or tpc.rank == 0,
                                                      layer_window=window)
            hit = torch.arange(n, device=slot.device) == slot - (tpc.rank * n if split else 0)
            new_lc = {**lc, "k": torch.where(hit[None, :, None, None], k_new, lc["k"]),
                      "v": torch.where(hit[None, :, None, None], v_new, lc["v"]),
                      "kpos": torch.where(hit[None], pos[:, None], lc["kpos"])}
        if cfg.kind == "hybrid":
            ssm, ssm_partial = SSM.local_view(p["ssm"], cfg, tpc)
            state = {**lc["ssm"], "conv": _conv_tail(cfg, lc["ssm"]["conv"], ssm_partial, tpc)}
            s, new_lc["ssm"] = SSM.ssm_step(ssm, cfg, h, state)
            new_lc["ssm"]["conv"] = _conv_tail(cfg, new_lc["ssm"]["conv"], ssm_partial, tpc,
                                                out=True)
            out = _mix(p, cfg, out, s, tpc, False, (partial, ssm_partial))
        else:
            out = TP.leave(out, tpc, False, partial)
        x = x + out
        if "xk" in lc:
            hx = L.rmsnorm(x, p["ln_x"]["scale"], cfg.norm_eps)
            xk, xv = _local_kv(cfg, p["xattn"]["wq"].shape[-1] // cfg.head_dim, lc["xk"],
                               lc["xv"], tpc)
            x = x + TP.leave(L.cross_decode_attention(p["xattn"], cfg, hx, xk, xv), tpc, False,
                             _sharded(p["xattn"]["wo"], cfg.n_heads * cfg.head_dim))
        out, partial = _ffn(p, cfg, L.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps), tpc)
        return x + TP.leave(out, tpc, False, partial), new_lc

    # ------------------------------------------------------- cache specs --
    def init_cache(self, batch_size: int, max_len: int, src_len: int = 0, patches: int = 0):
        """Zero-filled decode cache at position ``max_len`` + M + ``patches``
        (``max_len`` token positions after the M meta tokens and the
        patches), a layer of span s holding the positions before it at
        their slots p mod s (the reference's ``init_cache``); for encdec,
        a zero ``enc_out`` of ``src_len`` frames at positions 0 (the
        reference's) and zero cross-attention k, v."""
        cfg, dt, dev = self.cfg, _dtype(self.cfg), self.device
        B, total = batch_size, max_len + cfg.meta_tokens + patches
        layers = []
        for w in self.windows:
            if cfg.kind == "rwkv":
                H, hs = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
                layers.append({"S": torch.zeros(B, H, hs, hs, dtype=torch.float32, device=dev),
                               "x_last_tm": torch.zeros(B, cfg.d_model, dtype=dt, device=dev),
                               "x_last_cm": torch.zeros(B, cfg.d_model, dtype=dt, device=dev)})
                continue
            span = total if w is None else min(w, total)
            kv = lambda n: torch.zeros(B, n, cfg.kv_heads, cfg.head_dim, dtype=dt, device=dev)
            held = torch.arange(total - span, total, dtype=torch.int32, device=dev)
            kpos = torch.empty_like(held).index_copy_(0, held.long() % span, held)
            lc = {"k": kv(span), "v": kv(span), "kpos": kpos.repeat(B, 1)}
            if cfg.kind == "hybrid":
                H, d_inner = SSM._heads(cfg), cfg.n_heads * cfg.head_dim
                lc["ssm"] = {"h": torch.zeros(B, H, cfg.ssm_state, d_inner // H,
                                              dtype=torch.float32, device=dev),
                             "conv": torch.zeros(B, SSM.CONV, d_inner, dtype=dt, device=dev)}
            if cfg.kind == "encdec":
                lc["xk"], lc["xv"] = kv(src_len), kv(src_len)
            layers.append(lc)
        cache = {"layers": layers, "pos": torch.full((B,), total, dtype=torch.int32, device=dev)}
        if cfg.kind == "encdec":
            cache["enc_out"] = torch.zeros(B, src_len, cfg.d_model, dtype=dt, device=dev)
            cache["enc_pos"] = torch.zeros(B, src_len, dtype=torch.int32, device=dev)
        return cache


def _ffn(p, cfg: ModelConfig, h: torch.Tensor, tpc=None):
    """A serving block's FFN: the MLP, or the MoE FFN at capacity factor
    4.0 (the reference's ``_prefill_block`` and ``_decode_block``; expert
    parallel with a tp context).  Returns (out, whether it is a partial
    sum over tp)."""
    if cfg.kind == "moe":
        if tpc is None:
            return MOE.moe_ffn(p["moe"], cfg, h, capacity_factor=SERVE_CAPACITY)[0], False
        return (MOE.moe_ffn_tp(p["moe"], cfg, h, tpc, capacity_factor=SERVE_CAPACITY)[0],
                MOE.is_partial(p["moe"], cfg))
    return L.mlp(p["mlp"], cfg, h), _sharded(p["mlp"]["w_down"], cfg.d_ff)


def _sharded(w: torch.Tensor, whole: int) -> bool:
    """Whether a row-parallel ``w`` is a tp rank's shard of its ``whole``
    rows (its product then a partial sum over tp)."""
    return w.shape[0] != whole


def _local_heads(cfg: ModelConfig, q, k, v, tpc):
    """q of a tp rank's own heads and the K/V heads they read
    (:func:`_local_kv`)."""
    return (q, *_local_kv(cfg, q.shape[2], k, v, tpc))


def _local_kv(cfg: ModelConfig, n: int, k, v, tpc):
    """The K/V heads that a tp rank's ``n`` query heads read: k, v as they
    are outside a tp context, where the rank computes every head, or where
    they hold the rank's own K/V heads already (a cross-attention's ``wk``,
    ``wv`` kept as the rank's shards)."""
    if tpc is None or n == cfg.n_heads or k.shape[2] != cfg.kv_heads:
        return k, v
    return L.local_kv(k, v, tpc.rank * n, n, cfg.n_heads // cfg.kv_heads)


def _vocab_offset(tpc, logits: torch.Tensor) -> int:
    """The id of the first of a tp rank's vocab columns (0 outside tp)."""
    return 0 if tpc is None else tpc.rank * logits.shape[-1]


def _mix(p, cfg: ModelConfig, attn: torch.Tensor, ssm: torch.Tensor, tpc=None,
         sp: bool = False, partial=(False, False)) -> torch.Tensor:
    """The hybrid block's branch output, 0.5·(rmsnorm(attn, bn_a) +
    rmsnorm(ssm, bn_s)), each norm over all of D.  With a tp context the
    branches' outputs (over the whole sequence; each a partial sum over tp
    where ``partial`` says its heads are split) are first brought to the
    residual's layout (``TP.leave``): two partial sums in one collective,
    stacked along the last dimension; the norms and the mix then run on
    the rank's slice."""
    if tpc is not None:
        if all(partial):
            attn, ssm = TP.leave(torch.cat([attn, ssm], -1), tpc, sp, True).chunk(2, -1)
        else:
            attn, ssm = (TP.leave(t, tpc, sp, part) for t, part in zip((attn, ssm), partial))
    return 0.5 * (L.rmsnorm(attn, p["bn_a"]["scale"], cfg.norm_eps)
                  + L.rmsnorm(ssm, p["bn_s"]["scale"], cfg.norm_eps))


def _conv_tail(cfg: ModelConfig, conv: torch.Tensor, heads_split: bool, tpc,
               out: bool = False) -> torch.Tensor:
    """A hybrid layer's cached conv tail (B, 4, d_inner) where tp divides
    d_inner but not the SSM heads (every rank runs every head, and the
    rules keep the rank's slice of d_inner): gathered over tp for a step,
    or (``out``) cut to the rank's slice; as it is elsewhere."""
    if tpc is None or heads_split or not tpc.divides(cfg.n_heads * cfg.head_dim):
        return conv
    return TP.local_slice(conv, tpc, 2) if out else TP.gather(conv, tpc, 2)


def _ring(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor, span: int):
    """A prefill's cache of ``span`` slots: its last min(span, S) positions
    at slots p mod span, the other slots empty (zero k and v, kpos −1)."""
    B, S = positions.shape
    if span == S:                      # every position at its own slot
        return {"k": k, "v": v, "kpos": positions}
    n = min(span, S)
    slots = torch.arange(S - n, S, device=k.device) % span
    place = lambda t, fill: t.new_full((B, span) + t.shape[2:], fill).index_copy_(
        1, slots, t[:, S - n:])
    return {"k": place(k, 0), "v": place(v, 0), "kpos": place(positions, -1)}
