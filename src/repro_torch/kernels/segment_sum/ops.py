"""Wrapper of the segment-⊕ kernel (``csrc/segment_sum.cu``).

:func:`segment_sum` takes values (K, n, C) and a :class:`Segments` CSR
and returns (K, n_keys, C) in float32.  CUDA tensors go to the kernel,
which is compiled with ``nvcc`` for sm_90a at first use into
``src/repro_torch/_build/`` and bound through ``ctypes``; CPU tensors
go to the plain version in ``ref.py``.  A tensor on any other device,
or one the kernel does not take, raises.

The kernel walks the CSR's :class:`WorkPlan`, built with it on the host:
runs of at most ``ITEM_ROWS`` entries of one key, so a key that holds
most rows is cut into many walks, whose partials a second launch of the
same call sums in item order.

``launches`` counts calls that launched the kernel since the last
:func:`reset_launches`, one a call whether or not its plan needed the
second launch; a run reads it to show that its segment-⊕ work went
through the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from .ref import segment_sum_ref

# L, the most CSR entries one warp walks.  The serve path's uniform keys
# (about 1,024 entries at 4M rows and 4,096 keys, 2,048 with half of them
# empty) stay one item each.
ITEM_ROWS = 4096

launches = 0
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    global launches
    launches = 0


@dataclasses.dataclass(frozen=True)
class WorkPlan:
    """The kernel's work items over a CSR.  Item i covers the entries
    ``item_offsets[i]:item_offsets[i+1]``, all of key ``item_key[i]`` and
    at most ``rows`` of them; the items run in CSR order and every key
    has at least one (an empty key one empty item).  The items of a
    split key (one of more than ``rows`` entries) write partial sums to
    the slots ``item_slot[i]`` (−1 for every other item, which writes
    the output); split key j is ``split_key[j]`` and owns the slots
    ``split_offsets[j]:split_offsets[j+1]``, in item order."""

    item_offsets: torch.Tensor   # (n_items+1,) int32
    item_key: torch.Tensor       # (n_items,) int32
    item_slot: torch.Tensor      # (n_items,) int32
    split_key: torch.Tensor      # (n_split,) int32
    split_offsets: torch.Tensor  # (n_split+1,) int32
    rows: int
    n_slots: int
    # the five tensors' data pointers as the kernel's C interface takes
    # them, made once: a message emission pays no host time for them
    ptrs: ctypes.Array = dataclasses.field(repr=False, compare=False)

    @property
    def n_items(self) -> int:
        return self.item_key.shape[0]

    @property
    def n_split(self) -> int:
        return self.split_key.shape[0]

    @staticmethod
    def from_offsets(offsets: np.ndarray, rows: int, device) -> "WorkPlan":
        if rows < 1:
            raise ValueError(f"a work item holds at least one entry, got {rows}")
        offsets = np.asarray(offsets, np.int64)
        per_key = np.maximum(1, -(-np.diff(offsets) // rows))
        item_key = np.repeat(np.arange(len(per_key)), per_key)
        first = np.cumsum(per_key) - per_key
        begin = offsets[:-1][item_key] + (np.arange(len(item_key)) - first[item_key]) * rows
        split = per_key > 1
        in_split = split[item_key]
        slots = np.concatenate([[0], np.cumsum(per_key[split])])
        tensors = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)
                   for x in (np.append(begin, offsets[-1]), item_key,
                             np.where(in_split, np.cumsum(in_split) - 1, -1),
                             np.flatnonzero(split), slots)]
        return WorkPlan(*tensors, rows=int(rows), n_slots=int(slots[-1]),
                        ptrs=(ctypes.c_void_p * 5)(*(t.data_ptr() for t in tensors)))


@dataclasses.dataclass(frozen=True)
class Segments:
    """CSR of a static key column: rows ``order[offsets[key]:offsets[key+1]]``
    are the rows whose key is ``key``, in ascending entry order, and
    ``plan`` its kernel's work items.

    ``n_rows`` is the row count of the values the CSR reduces.  It is
    the key column's length, unless the column covers several tiled
    copies of the rows (``from_ids(..., row_period=n)``): entry e then
    names row ``e mod n``, and the tiled values are never built."""

    ids: torch.Tensor      # (entries,) int64 key per entry
    order: torch.Tensor    # (entries,) int32 rows sorted by key, stable
    offsets: torch.Tensor  # (n_keys+1,) int32 run starts
    n_keys: int
    n_rows: int
    plan: WorkPlan

    @staticmethod
    def from_ids(ids: np.ndarray, n_keys: int, device,
                 row_period: Optional[int] = None) -> "Segments":
        ids = np.asarray(ids, np.int64).reshape(-1)
        if len(ids) >= 2 ** 31:
            raise ValueError(f"segment_sum takes < 2^31 rows, got {len(ids)}")
        order = np.argsort(ids, kind="stable")
        n_rows = len(ids) if row_period is None else int(row_period)
        if row_period is not None:
            order %= n_rows
        offsets = np.zeros(n_keys + 1, np.int64)
        np.cumsum(np.bincount(ids, minlength=n_keys), out=offsets[1:])
        return Segments(
            ids=torch.from_numpy(ids).to(device),
            order=torch.from_numpy(order.astype(np.int32)).to(device),
            offsets=torch.from_numpy(offsets.astype(np.int32)).to(device),
            n_keys=int(n_keys),
            n_rows=n_rows,
            plan=WorkPlan.from_offsets(offsets, ITEM_ROWS, device),
        )


# ------------------------------------------------------------------ build --
def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile ``csrc/segment_sum.cu`` (see ``kernels/_build.py``);
    returns the library's path and the compiler's messages."""
    return _build.build("segment_sum", verbose=verbose)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("segment_sum")
        for name in ("segment_sum_f32", "segment_sum_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                           + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.segment_sum_error_string.argtypes = [ctypes.c_int]
        lib.segment_sum_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ---------------------------------------------------------------- wrapper --
def _check_cuda(vals: torch.Tensor, seg: Segments) -> None:
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segment_sum kernel takes float32 or bfloat16, got {vals.dtype}")
    if not vals.is_contiguous():
        raise ValueError("segment_sum kernel takes contiguous values")
    # the plan's tensors are made together, int32 and contiguous, on one device
    for name, t in (("order", seg.order), ("offsets", seg.offsets),
                    ("plan", seg.plan.item_offsets)):
        if t.device != vals.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"segment_sum: {name} must be contiguous int32 on {vals.device}, "
                             f"got {t.dtype} on {t.device}")


def segment_sum(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    """out[k, key, c] = Σ_{r : ids[r] = key} vals[k, r, c], in float32."""
    if vals.dim() != 3:
        raise ValueError(f"segment_sum takes (K, n, C) values, got shape {tuple(vals.shape)}")
    K, n, C = vals.shape
    if seg.n_rows != n or seg.offsets.shape != (seg.n_keys + 1,):
        raise ValueError(f"segment_sum: CSR of {seg.n_rows} rows / "
                         f"{seg.offsets.shape[0] - 1} keys does not fit values of {n} rows")
    if vals.device.type == "cpu":
        return segment_sum_ref(vals, seg.order, seg.offsets)
    if vals.device.type != "cuda":
        raise RuntimeError(f"segment_sum: no route for device {vals.device}")
    _check_cuda(vals, seg)
    out = torch.empty((K, seg.n_keys, C), dtype=torch.float32, device=vals.device)
    if out.numel() == 0:
        return out
    plan = seg.plan
    part = (torch.empty((K, plan.n_slots, C), dtype=torch.float32, device=vals.device)
            if plan.n_slots else None)                  # the split keys' partials
    lib = _load()
    fn = lib.segment_sum_f32 if vals.dtype == torch.float32 else lib.segment_sum_bf16
    with torch.cuda.device(vals.device):
        rc = fn(vals.data_ptr(), seg.order.data_ptr(), plan.ptrs, plan.n_items, plan.n_split,
                plan.n_slots, None if part is None else part.data_ptr(), out.data_ptr(), K, n,
                seg.n_keys, C, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("segment_sum kernel launch failed: "
                           + lib.segment_sum_error_string(rc).decode())
    global launches
    launches += 1
    return out
