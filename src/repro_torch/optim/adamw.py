"""AdamW with the reference's warm-up/cosine schedule, global-norm clip and
decoupled weight decay (``src/repro/optim/adamw.py``), as plain functions
on trees of tensors (``repro_torch.tree`` order).

The moments live in float32.  :func:`apply` updates the parameters and
the moments in place (the reference returns new arrays; at 1.1 B
parameters a second copy of the state is 13 GB), and returns them with
the new step count.  A leaf is updated in slices of at most ``CHUNK``
elements (every operation is elementwise, so the result is the same),
which bounds the update's float32 temporaries: DBRX's stacked expert
leaf of one layer holds 1.06 · 10⁹ elements, 4.2 GB a float32 copy.  The update is formed in float32 and rounded to each
parameter's dtype, as the reference does.  The step count is an int32
scalar on the host, and the schedule's scalars are float32, computed on
the host in the reference's order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..tree import leaves, map_tree

F32 = np.float32
CHUNK = 1 << 26                    # elements an update pass: float32 temporaries of 256 MiB


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    master_fp32: bool = False


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar on the host
    m: Any
    v: Any
    master: Any             # float32 params, or () when disabled


def schedule(cfg: AdamWConfig, step) -> float:
    """Learning rate at ``step``: linear warm-up, then cosine to
    ``min_lr_ratio`` · lr, in float32."""
    s = F32(int(step))
    warm = min(s / F32(max(cfg.warmup_steps, 1)), F32(1.0))
    prog = np.clip(F32(int(step) - cfg.warmup_steps)
                   / F32(max(cfg.total_steps - cfg.warmup_steps, 1)), F32(0.0), F32(1.0))
    cos = F32(0.5) * (F32(1) + np.cos(F32(np.pi) * prog))
    return float(F32(cfg.lr) * warm * (F32(cfg.min_lr_ratio) + F32(1 - cfg.min_lr_ratio) * cos))


def init(cfg: AdamWConfig, params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    master = map_tree(lambda p: p.float().clone(), params) if cfg.master_fp32 else ()
    return OptState(step=torch.zeros((), dtype=torch.int32), m=map_tree(zeros, params),
                    v=map_tree(zeros, params), master=master)


def global_norm(tree) -> torch.Tensor:
    """‖tree‖₂ over every leaf, in float32 (a device scalar)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(tree)))


def apply(cfg: AdamWConfig, params, grads, state: OptState, gn=None):
    """One AdamW step with averaged ``grads``; updates ``params`` and the
    moments in place.  Returns (params, state, {"grad_norm", "lr"}).
    ``gn``: the gradient's global norm where the caller has it (a placed
    step's leaves are the rank's shards: their norm is not the whole's)."""
    gn = global_norm(grads) if gn is None else gn
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    step = int(state.step) + 1
    lr = schedule(cfg, step)
    b1c = float(F32(1) - F32(cfg.b1) ** F32(step))
    b2c = float(F32(1) - F32(cfg.b2) ** F32(step))
    masters = leaves(state.master) if cfg.master_fp32 else [None] * len(leaves(params))
    for leaf in zip(leaves(params), leaves(grads), leaves(state.m), leaves(state.v), masters):
        for p, g, m, v, mp in _slices(leaf):
            g = g.float() * scale
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
            del g
            base = mp if mp is not None else p.float()
            upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
            upd.add_(base * cfg.weight_decay).mul_(lr)
            new = base - upd
            del upd
            p.copy_(new)                               # rounded to p's dtype
            if mp is not None:
                mp.copy_(new)
    new_state = OptState(torch.tensor(step, dtype=torch.int32), state.m, state.v, state.master)
    return params, new_state, {"grad_norm": gn, "lr": lr}


def _slices(leaf):
    """The (param, grad, m, v, master) of one leaf as flat views of at most
    ``CHUNK`` elements each, or whole where a tensor is not contiguous."""
    if leaf[0].numel() <= CHUNK or not all(t is None or t.is_contiguous() for t in leaf):
        return [leaf]
    flat = [None if t is None else t.view(-1) for t in leaf]
    return [tuple(None if t is None else t[lo:lo + CHUNK] for t in flat)
            for lo in range(0, leaf[0].numel(), CHUNK)]
