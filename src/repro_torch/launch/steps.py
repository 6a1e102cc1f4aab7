"""The LM trainer's step: microbatched gradient accumulation in float32,
optional count-sketch gradient compression, global-norm clip and AdamW,
and the dry run's input specs (the reference's ``launch/steps.py``).

Parameters and optimizer state are in the reference's stacked layout
(``models.stack_layers``): one tensor per reference leaf, the layers (and
an encoder's layers) stacked.  A step takes per-layer views of them for the model
(``models.layer_views``), takes each microbatch's gradients with
``torch.autograd.grad`` (PyTorch would sum ``.grad`` in the parameters'
bf16) and adds them to float32 accumulators of the stacked layout, one
buffer per reference leaf, so the compressor sketches a whole stacked
leaf in one launch and the optimizer updates it in one pass.  The
accumulators are allocated once, at the first step.

Placed (``distributed/sharding.py``): where the parameters are DTensors,
so are AdamW's moments and the batch (rows over dp), and the step runs on
each rank's local tensors.  Each dp rank computes on its own rows, which
``sharding.place_batch`` chooses (``sharding.dp_rows``): its slice of each
of the reference's microbatches (microbatch j is rows [j·G/n, (j+1)·G/n)
of the global batch), so ``split_micro`` of its rows gives its slice of
microbatch j as its j-th and the dp group's slices of it, in dp-rank
order, are the reference's microbatch j, for every kind.  An MoE config
routes each microbatch whole: its dp ranks exchange their per-expert
counts and probability sums in every route call (``moe.route`` with the
mesh's ``tp.DataGroup``), in the train step, its remat recomputes, the
prefill and decode, so C, the ranks, the drops and the aux loss are the
reference's.  A block gathers its own weights
(``sharding.take``: every kernel sees plain tensors).  Over tp, every
config on a mesh whose "model" axis has more than one rank computes
tensor- and sequence-parallel (``distributed/tp.py``): its blocks keep
their tp shards (``tp.keeps``: ``wq``, ``wo``, the MLP, an MoE block's
experts and shared expert, an RWKV block's time-mix and channel-mix
projections, a hybrid block's SSM projections, a decoder block's
cross-attention, the embedding; gathered over the fsdp axes only) and
run on the rank's heads, d_ff, experts and vocab columns, the residual
stream the rank's sequence slice between blocks, the loss
vocab-parallel; on a mesh of one over tp each block gathers its weights
whole, the ranks of one tp group computing the same rows.  The gradient
is reduced explicitly: the
gather's backward sums it over the dp ranks (and, tensor-parallel, over
the tp ranks where the block read the leaf whole over tp) and
reduce-scatters it to the leaf's placement, each rank's loss weighted by
its share of the microbatch's tokens, t_r / Σ t, so the sum is the mean
over every rank's tokens (with tokens of equal count, the reference's
mean); an MoE's aux loss, the group's on every rank, is not weighted: its
gradient reaches each rank's own probabilities alone.  The compressor
sketches each leaf whole, gathered (its hashes and error feedback one
process's), and gives back the rank's slice; the clip takes the norm of
the whole gradient (each shard's squares summed over the mesh dimensions
that split it) and AdamW updates the local shards.  On plain tensors the
step is the one process's.  :func:`placed_prefill` and
:func:`placed_decode` serve the same way; tensor-parallel, each rank keeps
its block of span/tp cache slots (an RWKV layer its heads' state and its
slice of D of ``x_last``, a hybrid layer its SSM heads' state and their
conv columns, an encdec layer its K/V heads' cross k, v, and the cache
its slice of ``enc_out``) and its vocab columns of the logits, else each
cache layer is gathered over tp (the rows stay the rank's own).
With the gloo backend every collective runs on the host
(``distributed/tp.py``'s transport).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from .. import configs
from ..distributed import sharding
from ..distributed import tp as TP
from ..models.config import ModelConfig
from ..models.lm import STACKS, Model, layer_views
from ..optim import adamw
from ..tree import leaves, map_tree, paths, unflatten

# per-arch microbatch count for train_4k (global batch 256), the reference's
N_MICRO = {
    "qwen2_5_32b": 16,
    "tinyllama_1_1b": 8,
    "llama3_405b": 16,
    "granite_3_8b": 16,
    "dbrx_132b": 16,
    "llama4_scout_17b_a16e": 16,
    "seamless_m4t_medium": 8,
    "llava_next_34b": 16,
    "rwkv6_1_6b": 8,
    "hymba_1_5b": 8,
}


def n_micro(arch: str, global_batch: int, dp_size: int) -> int:
    """Accumulation steps such that microbatch size ≥ dp (stays sharded)."""
    return max(1, min(N_MICRO.get(arch, 8), global_batch // max(dp_size, 1)))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: configs.ShapeSpec) -> Dict[str, torch.Tensor]:
    """Meta tensors of one global batch of this arch × shape (the
    reference's ``ShapeDtypeStruct``s): B × S int32 tokens; an encoder's
    ``src_frames`` (B, S/2, D) beside S/2 tokens; LLaVA's ``patches`` (B,
    S/2, D) before S − S/2 tokens, both in the model dtype."""
    B, S = shape.global_batch, shape.seq_len
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if cfg.is_encdec:
        return {"src_frames": _meta((B, S // 2, cfg.d_model), dt),
                "tokens": _meta((B, S // 2), torch.int32)}
    if cfg.frontend == "patches":
        return {"patches": _meta((B, S // 2, cfg.d_model), dt),
                "tokens": _meta((B, S - S // 2), torch.int32)}
    return {"tokens": _meta((B, S), torch.int32)}


def input_specs(arch: str, shape_name: str, cfg: Optional[ModelConfig] = None):
    """(mode, specs) for the dry run: ``{"batch"}`` for train and prefill,
    ``{"cache", "tokens"}`` for decode, the cache ``Model.init_cache`` of
    seq_len positions (and S/2 frames for an encoder) built on ``meta``;
    ``cfg`` in place of the arch's full config (a smoke run)."""
    cfg = configs.get(arch) if cfg is None else cfg
    shape = configs.SHAPES[shape_name]
    if shape.mode in ("train", "prefill"):
        return shape.mode, {"batch": batch_specs(cfg, shape)}
    B, S = shape.global_batch, shape.seq_len
    cache = Model(cfg, device="meta").init_cache(B, S, src_len=S // 2 if cfg.is_encdec else 0)
    return "decode", {"cache": cache, "tokens": _meta((B,), torch.int32)}


def split_micro(batch: Dict[str, Any], n_micro: int) -> List[Dict[str, Any]]:
    """(G, ...) → n_micro microbatches of G / n_micro rows each."""
    G = len(next(iter(batch.values())))
    if G % n_micro:
        raise ValueError(f"global batch {G} is not a multiple of n_micro {n_micro}")
    m = G // n_micro
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()} for i in range(n_micro)]


def _slots(params) -> List[Tuple[int, Optional[int]]]:
    """For each leaf of ``layer_views(params)``, in ``leaves`` order, the
    index of the stacked leaf it is a view of and its layer (None for a
    leaf outside the layers and the encoder's layers)."""
    index = {name: i for i, name in enumerate(paths(params))}
    out = []
    for name in paths(layer_views(params)):
        head, _, rest = name.partition(".")
        if head in STACKS:
            layer, _, leaf = rest.partition(".")
            out.append((index[f"{head}.{leaf}"], int(layer)))
        else:
            out.append((index[name], None))
    return out


def _mesh(tree):
    return next(t.device_mesh for t in leaves(tree) if isinstance(t, DTensor))


def _dp_dims(mesh) -> List[int]:
    """The mesh dimensions of the dp axes that hold more than one rank."""
    dp = sharding.mesh_axes(mesh)["dp"]
    return [i for i, n in enumerate(mesh.mesh_dim_names) if n in dp and mesh.size(i) > 1]


def _all_reduce(t: torch.Tensor, mesh, dims) -> torch.Tensor:
    for d in dims:
        t = TP.reduce(t, TP.axis(mesh, d))
    return t


def _like(local: torch.Tensor, d: DTensor) -> DTensor:
    """``local`` as a DTensor of ``d``'s mesh, placements and global shape."""
    return DTensor.from_local(local, d.device_mesh, d.placements, run_check=False,
                              shape=d.shape, stride=d.stride())


def global_norm(grads) -> torch.Tensor:
    """‖grads‖₂ of DTensor leaves: each shard's sum of squares, summed over
    the mesh dimensions that split its leaf (one all-reduce a set of them),
    then over the leaves in ``adamw.global_norm``'s order."""
    flat = leaves(grads)
    sq = [torch.sum(torch.square(g.to_local().float())) for g in flat]
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for i, g in enumerate(flat):
        dims = tuple(d for d, p in enumerate(g.placements)
                     if p.is_shard() and g.device_mesh.size(d) > 1)
        if dims:
            groups.setdefault(dims, []).append(i)
    for dims, idx in groups.items():
        total = _all_reduce(torch.stack([sq[i] for i in idx]), flat[idx[0]].device_mesh, dims)
        for j, i in enumerate(idx):
            sq[i] = total[j]
    return torch.sqrt(sum(sq))


def _view_shardings(params, held):
    """The rules' placement of the per-layer views of ``held`` (``params``'
    local tensors): a stacked leaf's spec less its layer axis.  The rules
    read ``params``' global shapes (a local shape may not divide)."""
    mesh = _mesh(params)
    stacked = leaves(sharding.param_shardings(mesh, params))
    specs = [stacked[i].spec if layer is None else stacked[i].spec[1:]
             for i, layer in _slots(held)]
    return unflatten(layer_views(held), [sharding.NamedSharding(mesh, s) for s in specs])


def make_train_step(model, ocfg: adamw.AdamWConfig, n_micro: int, compressor=None):
    """Returns train_step(params, opt_state, batch) → (params, opt_state,
    metrics), ``params`` and ``opt_state`` in the stacked layout and updated
    in place, plain tensors or DTensors (module docstring).  ``compressor``:
    an optional ``CountSketchCompressor`` applied to the averaged gradient
    before the optimizer.

    The step's two stages can also be called alone.
    ``train_step.grads(params, batch)`` → (grads, loss) fills the float32
    accumulators and changes no state, so a failed call can be run again.
    ``train_step.update(params, opt_state, grads, loss)`` compresses and
    applies AdamW in place: a failure there leaves the parameters, the
    moments and the error-feedback state half updated."""
    acc: List[torch.Tensor] = []

    def grads(params, batch):
        placed = sharding.is_placed(params)
        mesh = _mesh(params) if placed else None
        held = sharding.local(params)                   # the rank's tensors
        flat = leaves(held)
        if not acc:
            acc.extend(torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat)
        for a in acc:
            a.zero_()
        slots = _slots(held)
        dp = _dp_dims(mesh) if placed else []
        shard = _view_shardings(params, held) if placed else None
        tpc = TP.context(mesh, model.cfg) if placed else None
        keep = TP.keeps(model.cfg, tpc) if tpc is not None else None
        dpg = _data_group(model, mesh, batch) if placed else None
        kw = {"tpc": tpc, "dpg": dpg} if placed else {}     # one process: the loss alone
        loss_sum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        with sharding.use_mesh(mesh):                   # constrain's mesh, as the reference's
            for mb in split_micro(sharding.local(batch), n_micro):
                views = layer_views(map_tree(torch.Tensor.detach, held))
                wrt = [t.requires_grad_() for t in leaves(views)]
                loss, metrics = model.loss(
                    views if shard is None else sharding.wrap(views, shard, tp=keep), mb, **kw)
                ce = metrics["ce"].detach()
                if dp:                                  # this rank's share of the tokens
                    w = metrics["tokens"] / _all_reduce(metrics["tokens"].detach(), mesh, dp)
                    # routed over dp, the aux is the group's, its gradient the rank's own
                    # probabilities' share (moe.route): weighted, it would count 1/dp
                    aux = metrics["aux"] if dpg is not None else 0.0
                    loss, ce = (loss - aux) * w + aux, ce * w
                for (i, layer), g in zip(slots, torch.autograd.grad(loss, wrt)):
                    (acc[i] if layer is None else acc[i][layer]).add_(g)
                loss_sum += ce
                del views, wrt, loss, metrics
        for a in acc:
            a.div_(n_micro)
        if dp:
            loss_sum = _all_reduce(loss_sum, mesh, dp)
        if placed:
            return unflatten(params, [_like(a, p) for a, p in zip(acc, leaves(params))]), \
                loss_sum / n_micro
        return unflatten(params, acc), loss_sum / n_micro

    def update(params, opt_state, grads, loss):
        if not sharding.is_placed(params):
            if compressor is not None:
                compressor(grads)
            params, opt_state, stats = adamw.apply(ocfg, params, grads, opt_state)
            return params, opt_state, {"loss": loss, **stats}
        if compressor is not None:
            whole = sharding.gathered(grads)            # each leaf whole, on every rank
            compressor(whole)
            for g, w in zip(leaves(grads), leaves(whole)):
                if not sharding.is_whole(g):            # else compressed in place already
                    g.to_local().copy_(w[sharding.shard_slices(w.shape, g.device_mesh,
                                                               g.placements)])
            del whole
        held = adamw.OptState(opt_state.step, sharding.local(opt_state.m),
                              sharding.local(opt_state.v), sharding.local(opt_state.master))
        _, held, stats = adamw.apply(ocfg, sharding.local(params), sharding.local(grads), held,
                                     gn=global_norm(grads))
        return params, opt_state._replace(step=held.step), {"loss": loss, **stats}

    def train_step(params, opt_state, batch):
        return update(params, opt_state, *grads(params, batch))

    train_step.grads, train_step.update, train_step.n_micro = grads, update, n_micro
    return train_step


def _data_group(model, mesh, batch) -> Optional[TP.DataGroup]:
    """The dp group an MoE config routes over: where the batch's rows
    split over dp (each rank's rows a slice of the microbatch), every route
    sees the group's whole microbatch (``moe.route``); None for the other
    kinds, which route nothing, and where the rows are replicated."""
    if model.cfg.kind != "moe" or _rows(batch) == 1:
        return None
    return TP.data_group(mesh)


def make_eval_loss(model):
    def eval_loss(params, batch):
        with torch.no_grad():
            _, metrics = model.loss(layer_views(params), batch)
        return metrics["ce"]

    return eval_loss


def _rows_placed(tree, mesh, shardings_fn, rows: int):
    """Rank-row tensors (this rank's rows, whole over tp) as DTensors of
    ``shardings_fn(mesh, global)``: the global leading dim is ``rows`` times
    the rank's, and each rank keeps its slice over the other axes."""
    dp = set(sharding.mesh_axes(mesh)["dp"])
    glob = map_tree(lambda t: SimpleNamespace(shape=torch.Size((t.shape[0] * rows,
                                                                *t.shape[1:]))), tree)
    out = []
    for t, g, sh in zip(leaves(tree), leaves(glob), leaves(shardings_fn(mesh, glob))):
        pl = sh.placements
        over = tuple(p if n not in dp else sharding.Replicate()
                     for p, n in zip(pl, mesh.mesh_dim_names))
        part = t[sharding.shard_slices(t.shape, mesh, over)].contiguous()
        out.append(DTensor.from_local(part, mesh, pl, run_check=False, shape=g.shape,
                                      stride=sharding.contiguous_stride(g.shape)))
    return unflatten(tree, out)


def _rows(batch) -> int:
    """How many dp ranks split the batch's rows (1 where it is replicated)."""
    t = leaves(batch)[0]
    return t.shape[0] // t.to_local().shape[0]


def _logit_shardings(mesh, logits):
    return sharding.NamedSharding(mesh, sharding.logical_to_spec(mesh, ("dp", "tp"),
                                                                  logits.shape))


def _served(model, params, tpc=None):
    held = sharding.local(params)
    return sharding.wrap(layer_views(held), _view_shardings(params, held),
                         tp=None if tpc is None else TP.keeps(model.cfg, tpc))


def _local_placed(tree, glob, mesh, shardings_fn):
    """A rank's tensors, each already its slice of the global leaf in
    ``glob`` (a tree of its global shapes) under ``shardings_fn(mesh,
    glob)``, as DTensors; raises where a slice disagrees with the rules."""
    out = []
    for t, g, sh in zip(leaves(tree), leaves(glob), leaves(shardings_fn(mesh, glob))):
        want = tuple(s.stop - s.start for s in sharding.shard_slices(g.shape, mesh,
                                                                     sh.placements))
        if tuple(t.shape) != want:
            raise ValueError(f"a rank's {tuple(t.shape)} is not its slice {want} of "
                             f"{tuple(g.shape)} under {sh.placements}")
        out.append(DTensor.from_local(t, mesh, sh.placements, run_check=False,
                                      shape=torch.Size(g.shape),
                                      stride=sharding.contiguous_stride(g.shape)))
    return unflatten(tree, out)


def _global(t, rows: int, span: Optional[int] = None):
    """The global shape of a rank's cache leaf: ``rows`` times its rows and,
    for a layer's k, v and kpos, the layer's whole ``span`` (a plain
    record: a meta tensor made under the dry run's census would count as
    live)."""
    shape = (t.shape[0] * rows,) + (() if span is None else (span,)) + tuple(
        t.shape[1 if span is None else 2:])
    return SimpleNamespace(shape=torch.Size(shape))


def _global_layers(model, local, max_len: Optional[int], layers, rows: int) -> list:
    """The global shapes of a tp-local prefill cache's layers: an attention
    layer's k, v and kpos over its whole span, a hybrid layer's SSM state
    over every head and its conv tail over all of d_inner, an encdec
    layer's cross k, v over every K/V head; an RWKV layer's state over
    every head and its ``x_last`` over all of D."""
    cfg = model.cfg
    whole = lambda t, rest: SimpleNamespace(shape=torch.Size((t.shape[0] * rows,) + rest))
    if cfg.kind == "rwkv":
        hs = cfg.rwkv_head_size
        rest = {"S": (cfg.d_model // hs, hs, hs), "x_last_tm": (cfg.d_model,),
                "x_last_cm": (cfg.d_model,)}
        return [{k: whole(t, rest[k]) for k, t in lc.items()} for lc in layers]
    n_tok = local["tokens"].shape[1]
    total = cfg.meta_tokens + (local["patches"].shape[1] if "patches" in local else 0) + (
        n_tok if max_len is None else max(max_len, n_tok))      # the model's cache positions
    H, d_inner = cfg.ssm_heads or cfg.n_heads, cfg.n_heads * cfg.head_dim
    out = []
    for lc, w in zip(layers, model.windows):
        g = {k: _global(lc[k], rows, total if w is None else min(w, total))
             for k in ("k", "v", "kpos")}
        if "ssm" in lc:
            g["ssm"] = {"h": whole(lc["ssm"]["h"], (H, cfg.ssm_state, d_inner // H)),
                        "conv": whole(lc["ssm"]["conv"], (lc["ssm"]["conv"].shape[1], d_inner))}
        for k in ("xk", "xv"):
            if k in lc:
                g[k] = whole(lc[k], (lc[k].shape[1], cfg.kv_heads, cfg.head_dim))
        out.append(g)
    return out


def _global_logits(logits, rows: int, cfg: ModelConfig):
    return SimpleNamespace(shape=torch.Size((logits.shape[0] * rows, cfg.padded_vocab)))


def placed_prefill(model, params, batch, max_len: Optional[int] = None):
    """``model.prefill`` on placed parameters and a placed batch (module
    docstring): (logits, cache) as DTensors, the logits (dp, tp) and the
    cache under ``sharding.cache_shardings``."""
    mesh = _mesh(params)
    tpc = TP.context(mesh, model.cfg)
    local = sharding.local(batch)
    with sharding.use_mesh(mesh), torch.no_grad():
        logits, cache = model.prefill(_served(model, params, tpc), local, max_len,
                                      tpc=tpc, dpg=_data_group(model, mesh, batch))
    rows = _rows(batch)
    if tpc is None:
        return (_rows_placed(logits, mesh, _logit_shardings, rows),
                _rows_placed(cache, mesh, sharding.cache_shardings, rows))
    glob = {"pos": _global(cache["pos"], rows), "layers": _global_layers(
        model, local, max_len, cache["layers"], rows)}
    if "enc_out" in cache:
        Se = local["src_frames"].shape[1]
        glob.update(enc_out=_global(cache["enc_out"], rows, Se),
                    enc_pos=_global(cache["enc_pos"], rows, Se))
    return (_local_placed(logits, _global_logits(logits, rows, model.cfg), mesh,
                          _logit_shardings),
            _local_placed(cache, glob, mesh, sharding.cache_shardings))


def placed_decode(model, params, cache, tokens):
    """``model.decode_step`` on placed parameters, cache and tokens, the
    rows the rank's own: tensor-parallel on the rank's block of each
    layer's slots, else each cache layer gathered over tp in its block;
    (logits, cache) placed as :func:`placed_prefill`'s."""
    mesh = _mesh(params)
    tpc = TP.context(mesh, model.cfg)
    rows = _rows(tokens)
    dpg = _data_group(model, mesh, tokens)
    if tpc is not None:
        if model.cfg.kind != "rwkv":
            tpc = tpc.with_spans(lc["k"].shape[1] for lc in cache["layers"])
        with sharding.use_mesh(mesh), torch.no_grad():
            logits, new = model.decode_step(_served(model, params, tpc), sharding.local(cache),
                                            sharding.local(tokens), tpc=tpc, dpg=dpg)
        return (_local_placed(logits, _global_logits(logits, rows, model.cfg), mesh,
                              _logit_shardings),
                unflatten(new, [_like(t, d) for t, d in zip(leaves(new), leaves(cache))]))
    held = sharding.wrap(sharding.local(cache), sharding.cache_shardings(mesh, cache),
                         keep_rows=True)
    held = {k: v if k == "layers" else sharding.take(v) for k, v in held.items()}
    with sharding.use_mesh(mesh), torch.no_grad():
        logits, new = model.decode_step(_served(model, params), held, sharding.local(tokens),
                                        dpg=dpg)
    return (_rows_placed(logits, mesh, _logit_shardings, rows),
            _rows_placed(new, mesh, sharding.cache_shardings, rows))
