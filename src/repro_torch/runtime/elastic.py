"""Elastic scaling: rebuild the mesh after the set of ranks changed and
restore the state from the last checkpoint onto it (the reference's
``runtime/elastic.py``).

A checkpoint knows no mesh (``checkpoint/checkpointer.py``: rank 0 writes
every leaf whole), and ``Checkpointer.restore`` places each leaf onto a
target mesh, each rank reading its own slice, so going from 512 ranks to
256, or reshaping (data, model), is a restore, not a conversion.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def plan_mesh(n_devices: int, model_parallel: int) -> Tuple[int, int]:
    """The largest (data, model) grid for the surviving ranks: model
    parallelism stays the checkpointed layout's preference, halved until
    it divides the ranks; data parallelism absorbs the loss."""
    model = model_parallel
    while model > 1 and n_devices % model:
        model //= 2
    return n_devices // model, model


def rebuild_mesh(model_parallel: int, device="cuda") -> DeviceMesh:
    """A (data, model) mesh of :func:`plan_mesh` over the process group's
    ranks (the caller has joined one: ``launch.mesh.join_world``)."""
    n = dist.get_world_size()
    data, model = plan_mesh(n, model_parallel)
    return init_device_mesh(torch.device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))


def restore_elastic(ckpt, step: int, like, mesh, sharding_fn):
    """Restore ``like``-shaped state onto ``mesh`` (any size):
    ``sharding_fn(mesh, like)`` gives the tree of ``NamedSharding``
    (e.g. ``sharding.param_shardings``)."""
    return ckpt.restore(step, like, sharding_fn(mesh, like))
