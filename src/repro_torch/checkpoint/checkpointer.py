"""Async checkpoints in the reference's on-disk format.

Layout (the reference's ``checkpoint/checkpointer.py``)::

    <dir>/step_<N>/
        manifest.json        step, tree description, leaf count, shapes, dtypes
        leaf_<i>.npy         one file per leaf, bfloat16 stored as its uint16 bits
    <dir>/LATEST             the newest step, written last

Leaves are numbered in the reference's pytree order (``repro_torch.tree``)
and saved in the layout they are given: the trainer saves (params,
OptState) with the layers stacked, as the reference does, so a
checkpoint written by either package restores in the other.

``save`` copies every leaf to the host at once (a consistent snapshot)
and writes the files on a background thread unless ``blocking``;
``wait`` joins it.

Placed trees (DTensor leaves, ``distributed/sharding.py``): ``save``
gathers each DTensor leaf whole (``full_tensor()``, a collective) in the
calling thread on every rank, never in the writer thread, and rank 0
alone writes, in the same format: a checkpoint knows no mesh.
``restore(step, like, placements)`` places each leaf onto a target mesh
and placements (:class:`~repro_torch.distributed.sharding.NamedSharding`
leaves; ``sharding.UNPLACED`` keeps a leaf plain), each rank reading only
its own slice from the memory-mapped file, so a checkpoint written on one
mesh restores onto any other (``runtime/elastic.py``).  Under a process
group of more than one rank, a placed ``save`` and ``restore`` are
collective (every rank calls them); a blocking save ends with a barrier,
so the step is on disk for every rank when it returns.

A step is written into a temporary directory and renamed, and LATEST is
replaced atomically after it, so a crash mid-write never leaves LATEST
pointing at a torn step.  ``keep`` newest steps stay.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..distributed.sharding import contiguous_stride, gathered, shard_slices
from ..tree import leaves, paths, unflatten


def _to_storable(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)     # a copy on the CPU too: the trainer updates in place
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _multi_rank() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _from_storable(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.dtype(dtype_name)))


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---------------------------------------------------------------- save --
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot ``tree`` now; write it now (``blocking``) or on a thread.
        DTensor leaves are gathered here, on every rank; rank 0 writes."""
        self.wait()
        flat = leaves(gathered(tree))
        placed = any(isinstance(t, DTensor) for t in leaves(tree))
        if placed and _multi_rank() and dist.get_rank() != 0:
            if blocking:
                dist.barrier()                          # rank 0's write is done
            return
        host = [_to_storable(t) for t in flat]              # device → host now
        manifest = {"step": int(step), "treedef": "repro_torch: " + ", ".join(paths(tree)),
                    "n_leaves": len(host), "shapes": [list(a.shape) for a in host],
                    "dtypes": [_dtype_name(t) for t in flat]}

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for i, a in enumerate(host):
                np.save(os.path.join(tmp, f"leaf_{i}.npy"), a)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            with open(os.path.join(self.dir, ".LATEST_tmp"), "w") as f:
                f.write(str(step))
            os.replace(os.path.join(self.dir, ".LATEST_tmp"), os.path.join(self.dir, "LATEST"))
            self._gc()

        if blocking:
            write()
            if placed and _multi_rank():
                dist.barrier()
            return

        def run():
            try:
                write()
            except BaseException as e:      # reported by the next wait()
                self._error = e
                raise

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join a pending write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _gc(self) -> None:
        for s in sorted(self.all_steps())[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ------------------------------------------------------------- restore --
    def all_steps(self) -> List[int]:
        return [int(d.split("_", 1)[1]) for d in os.listdir(self.dir) if d.startswith("step_")]

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, step: int, like: Any, placements: Any = None) -> Any:
        """Load ``step`` into the structure of ``like``: each leaf in the
        dtype and on the device of ``like``'s leaf (a DTensor's: its local
        tensor's), placed as ``placements``' leaf says (a tree like
        ``like`` of ``NamedSharding``; by default a DTensor of ``like``
        keeps its own mesh and placements), from this rank's slice alone."""
        self.wait()
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        want = leaves(like)
        if manifest["n_leaves"] != len(want):
            raise ValueError(f"checkpoint step {step} holds {manifest['n_leaves']} leaves, the "
                             f"tree {len(want)}: the tree structure changed")
        targets = ([(w.device_mesh, w.placements) if isinstance(w, DTensor) else None
                    for w in want] if placements is None else
                   [None if p.mesh is None else (p.mesh, p.placements)
                    for p in leaves(placements)])
        if len(targets) != len(want):
            raise ValueError(f"restore: {len(targets)} placements for a tree of {len(want)} "
                             f"leaves")
        out = []
        for i, (w, target) in enumerate(zip(want, targets)):
            a = np.load(os.path.join(d, f"leaf_{i}.npy"), mmap_mode="r")
            if tuple(a.shape) != tuple(w.shape):
                raise ValueError(f"checkpoint leaf {i} has shape {tuple(a.shape)}, the tree "
                                 f"{tuple(w.shape)}")
            device = w.to_local().device if isinstance(w, DTensor) else w.device
            if target is None:
                out.append(_from_storable(a, manifest["dtypes"][i]).to(device=device,
                                                                        dtype=w.dtype))
                continue
            mesh, pl = target
            part = _from_storable(a[shard_slices(a.shape, mesh, pl)], manifest["dtypes"][i])
            out.append(DTensor.from_local(part.to(device=device, dtype=w.dtype), mesh, pl,
                                          run_check=False, shape=torch.Size(a.shape),
                                          stride=contiguous_stride(a.shape)))
        return unflatten(like, out)
