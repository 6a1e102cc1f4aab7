"""Carry state from the JAX package into the port.

The inputs are duck-typed objects of the reference package, read only
through their attributes and ``np.asarray`` (this module imports
nothing of it):

- tables: ``schema.tables`` with ``name``/``columns``/``feature_columns``
  and ``schema.label_table``/``label_column`` — the same numpy columns
  build the port's :class:`~repro_torch.core.Schema`;
- trained trees: ``TreeArrays.feat/thr/leaf``;
- sketch hash constants: ``TableHashes.hashes[name].a/b/a2/b2`` and ``k``
  (uint32 words, carried as Python ints).

Histogram split mode carries nothing new: its cuts, bins and row lists
are numpy functions of the same tables (``core/hist.py``), and a
histogram fit takes the reference's hashes like any other.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .core.schema import Schema, Table
from .core.sketch import Hash2, TableHashes
from .core.tree import TreeArrays


def schema(ref_schema, device="cuda") -> Schema:
    """The port's Schema over the same numpy columns as ``ref_schema``."""
    tables = [Table(name=t.name, columns={c: np.asarray(v) for c, v in t.columns.items()},
                    feature_columns=tuple(t.feature_columns))
              for t in ref_schema.tables]
    return Schema(tables, label=(ref_schema.label_table, ref_schema.label_column),
                  device=device)


def trees(ref_trees, device="cuda") -> List[TreeArrays]:
    """Trained trees as the port's TreeArrays (int32 feat, float32 thr/leaf)."""
    conv = lambda a, dt: torch.from_numpy(np.array(a, dtype=dt)).to(device)
    return [TreeArrays(feat=conv(t.feat, np.int32), thr=conv(t.thr, np.float32),
                       leaf=conv(t.leaf, np.float32)) for t in ref_trees]


def table_hashes(ref_hashes) -> TableHashes:
    """Per-table sketch hashes with the reference's constants."""
    word = lambda x: int(np.asarray(x, np.uint32))
    return TableHashes(
        hashes={name: Hash2(a=word(h.a), b=word(h.b), a2=word(h.a2), b2=word(h.b2),
                            k=int(h.k))
                for name, h in ref_hashes.hashes.items()},
        k=int(ref_hashes.k),
    )
