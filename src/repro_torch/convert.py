"""Carry state from the JAX package into the port.

The inputs are duck-typed objects of the reference package, read only
through their attributes and ``np.asarray`` (this module imports
nothing of it):

- tables: ``schema.tables`` with ``name``/``columns``/``feature_columns``
  and ``schema.label_table``/``label_column`` — the same numpy columns
  build the port's :class:`~repro_torch.core.Schema`;
- trained trees: ``TreeArrays.feat/thr/leaf``;
- sketch hash constants: a ``Hash2``'s ``a/b/a2/b2`` and ``k`` (uint32
  words, carried as Python ints), alone or per table of ``TableHashes``;
- LM parameters: the ``Model.init`` pytree of nested dicts, whose
  ``layers`` entry is stacked over a leading layer axis; each leaf is
  read with ``np.asarray`` and keeps its dtype (bfloat16 bit for bit).
  :func:`lm_stacked` keeps the reference's stacked layout (the trainer's
  and the checkpoint's), :func:`lm_params` gives the model's per-layer
  views of it; :func:`opt_state` carries an AdamW ``OptState``.

The other way, :func:`to_numpy` turns any tree of the port's tensors
(stacked parameters, an ``OptState``) into numpy arrays of the same
structure, bfloat16 as ``ml_dtypes.bfloat16`` (imported there, for the
tests: the port itself does not need it), which the reference's
functions take.

Histogram split mode carries nothing new: its cuts, bins and row lists
are numpy functions of the same tables (``core/hist.py``), and a
histogram fit takes the reference's hashes like any other.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .core.schema import Schema, Table
from .core.sketch import Hash2, TableHashes
from .core.tree import TreeArrays
from .models.lm import layer_views
from .optim.adamw import OptState
from .tree import map_tree


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


def hash2(ref_hash) -> Hash2:
    """A sketch hash with the reference ``Hash2``'s constants."""
    word = lambda x: int(np.asarray(x, np.uint32))
    return Hash2(a=word(ref_hash.a), b=word(ref_hash.b), a2=word(ref_hash.a2),
                 b2=word(ref_hash.b2), k=int(ref_hash.k))


def table_hashes(ref_hashes) -> TableHashes:
    """Per-table sketch hashes with the reference's constants."""
    return TableHashes(hashes={name: hash2(h) for name, h in ref_hashes.hashes.items()},
                       k=int(ref_hashes.k))


def _tensor(x, device) -> torch.Tensor:
    """A reference array as a tensor of the same dtype.  numpy has no
    bfloat16 of its own: the reference's arrays come out with the
    ``ml_dtypes`` bfloat16, which ``torch.from_numpy`` refuses, so their
    bits go through an int16 view."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def lm_stacked(ref_params, device="cuda") -> Dict[str, Any]:
    """The reference's LM parameter pytree as tensors, layers stacked."""
    return {k: _map(lambda x: _tensor(x, device), v) for k, v in ref_params.items()}


def lm_params(ref_params, device="cuda") -> Dict[str, Any]:
    """The port's LM parameters from the reference's ``Model.init`` pytree:
    the same nested dict, with ``layers`` a list of per-layer dicts of
    views of the stacked tensors (``models/lm.py``)."""
    return layer_views(lm_stacked(ref_params, device))


def opt_state(ref_state, device="cuda") -> OptState:
    """An AdamW state of the reference (``step``, ``m``, ``v``, ``master``)
    as the port's: float32 moments in the stacked layout, the step an
    int32 scalar on the host."""
    master = ref_state.master
    return OptState(step=torch.tensor(int(np.asarray(ref_state.step)), dtype=torch.int32),
                    m=lm_stacked(ref_state.m, device), v=lm_stacked(ref_state.v, device),
                    master=lm_stacked(master, device) if len(master) else ())


def to_numpy(tree) -> Any:
    """A tree of the port's tensors as numpy arrays of the same dtypes
    (bfloat16 as ``ml_dtypes.bfloat16``), structure kept."""
    import ml_dtypes

    def conv(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy().copy()
    return map_tree(conv, tree)
