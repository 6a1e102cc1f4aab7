"""The LM trainer's step: microbatched gradient accumulation in float32,
optional count-sketch gradient compression, global-norm clip and AdamW
(the reference's ``launch/steps.py``; its ``input_specs`` and
``batch_specs`` belong to the dry run, which is not ported yet).

Parameters and optimizer state are in the reference's stacked layout
(``models.stack_layers``): one tensor per reference leaf, the layers (and
an encoder's layers) stacked.  A step takes per-layer views of them for the model
(``models.layer_views``), takes each microbatch's gradients with
``torch.autograd.grad`` (PyTorch would sum ``.grad`` in the parameters'
bf16) and adds them to float32 accumulators of the stacked layout, one
buffer per reference leaf, so the compressor sketches a whole stacked
leaf in one launch and the optimizer updates it in one pass.  The
accumulators are allocated once, at the first step.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models.lm import STACKS, layer_views
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


def make_train_step(model, ocfg: adamw.AdamWConfig, n_micro: int, compressor=None):
    """Returns train_step(params, opt_state, batch) → (params, opt_state,
    metrics), ``params`` and ``opt_state`` in the stacked layout and updated
    in place.  ``compressor``: an optional ``CountSketchCompressor`` applied
    to the averaged gradient before the optimizer.

    The step's two stages can also be called alone.
    ``train_step.grads(params, batch)`` → (grads, loss) fills the float32
    accumulators and changes no state, so a failed call can be run again.
    ``train_step.update(params, opt_state, grads, loss)`` compresses and
    applies AdamW in place: a failure there leaves the parameters, the
    moments and the error-feedback state half updated."""
    acc: List[torch.Tensor] = []

    def grads(params, batch):
        flat = leaves(params)
        if not acc:
            acc.extend(torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat)
        for a in acc:
            a.zero_()
        slots = _slots(params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        for mb in split_micro(batch, n_micro):
            views = layer_views(map_tree(torch.Tensor.detach, params))
            wrt = [t.requires_grad_() for t in leaves(views)]
            loss, metrics = model.loss(views, mb)
            for (i, layer), g in zip(slots, torch.autograd.grad(loss, wrt)):
                (acc[i] if layer is None else acc[i][layer]).add_(g)
            loss_sum += metrics["ce"].detach()
            del views, wrt, loss, metrics
        for a in acc:
            a.div_(n_micro)
        return unflatten(params, acc), loss_sum / n_micro

    def update(params, opt_state, grads, loss):
        if compressor is not None:
            compressor(grads)
        params, opt_state, stats = adamw.apply(ocfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **stats}

    def train_step(params, opt_state, batch):
        return update(params, opt_state, *grads(params, batch))

    train_step.grads, train_step.update = grads, update
    return train_step


def make_eval_loss(model):
    def eval_loss(params, batch):
        with torch.no_grad():
            _, metrics = model.loss(layer_views(params), batch)
        return metrics["ce"]

    return eval_loss
