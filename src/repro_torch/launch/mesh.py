"""The data mesh the relational engine shards over.

A FUNCTION, not a module-level constant: importing this module starts no
process group.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

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
