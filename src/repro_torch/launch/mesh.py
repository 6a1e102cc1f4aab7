"""Meshes: the data mesh the relational engine shards over, and the LM's
(data, model) meshes, the host mesh and the production meshes
(the reference's ``launch/mesh.py``).

FUNCTIONS, not module-level constants: importing this module starts no
process group.  The LM meshes are ``torch.distributed.device_mesh``
meshes over the default process group, whose world size they take (a
world of one when there is none: :func:`join_world`); their device type
follows the caller's device, ``cuda`` on the card and ``cpu`` in the
tests.  A production mesh needs a world of 256 or 512 ranks, real or
fake (the dry run's, ``launch/dryrun.py``).
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..distributed.spmd import DataMesh


def make_data_mesh(n: Optional[int] = None, device="cuda",
                   backend: Optional[str] = None) -> DataMesh:
    """1-D ("data",) mesh over the ranks of the process group.

    Joins the default group from the environment ``torchrun`` sets
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``) unless
    the caller already initialized one.  The backend follows the device:
    NCCL for CUDA, one card a rank (this process takes card
    ``LOCAL_RANK``), gloo for the CPU; ``backend="gloo"`` on CUDA runs
    every collective through the host, which lets several ranks share
    one card.  Raises when ``n`` is not the world size, and when NCCL is
    asked for with more ranks than visible cards.  Install the mesh with
    ``spmd.use_data_mesh(make_data_mesh())``.
    """
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
        if backend is None:
            backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if n is not None and n != world:
        raise ValueError(f"a data mesh of {n} ranks needs a world of {n} processes, "
                         f"this one has {world} (launch with torchrun --nproc-per-node {n})")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"NCCL puts one card under each rank: {world} ranks but "
                         f"{torch.cuda.device_count()} visible cards (use backend='gloo')")
    if world == 1 and not dist.is_initialized():
        return DataMesh(size=1)
    if not dist.is_initialized():
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    return DataMesh(size=world, rank=rank, backend=backend)


def join_world(device="cuda") -> bool:
    """Join a process group unless this process is in one: the ``torchrun``
    world from the environment when it has more than one rank (NCCL on
    CUDA, one card a rank, card ``LOCAL_RANK``; gloo on the CPU), else a
    group of this process alone.  Returns True when it joined one, which
    the caller leaves with ``dist.destroy_process_group()``."""
    if dist.is_initialized():
        return False
    cuda = torch.device(device).type == "cuda"
    backend = "nccl" if cuda else "gloo"
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        rank = int(os.environ["RANK"])
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    return True


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(multi_pod: bool = False, device="cuda") -> DeviceMesh:
    """16 × 16 ("data", "model") = 256 ranks, or 2 × 16 × 16 ("pod", "data",
    "model") = 512 ranks multi-pod; raises unless the process group has
    that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    if _world() != math.prod(shape):
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh needs a world of "
                         f"{math.prod(shape)} ranks, this one has {_world()} (the dry run "
                         f"runs it over a fake process group)")
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=names)


def make_host_mesh(device="cuda") -> DeviceMesh:
    """Every rank of the world as a (data, model) mesh, model the first of
    4, 2, 1 that divides the world size: (1, 1) on one card.  Joins a
    process group first where there is none (:func:`join_world`)."""
    join_world(device)
    n = _world()
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return init_device_mesh(torch.device(device).type, (n // model, model),
                            mesh_dim_names=("data", "model"))
