"""Batched scoring entry points over a :class:`CompiledEnsemble`.

- :func:`score_grouped`  — bulk: (Σŷ, count) for EVERY row of a table in
  one SumProd pass.
- :func:`score_rows`     — interactive: a batch of row ids of a table;
  tables are static per model version, so this is a gather into the
  memoized bulk pass (the micro-batching service's hot path).
- :func:`score_fresh`    — rows that never touched the database: raw
  feature dicts routed through the materialized-path ``predict_rows``.

:func:`score_grouped_reference` keeps the per-leaf-per-tree loop (with
analytic query accounting) as the test baseline.

Every entry re-enters the model's data mesh (``mesh``; none for a model
without one), so a sharded model is scored as it was compiled whatever
mesh the calling thread has active.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.schema import Schema
from ..core.semiring import Arithmetic
from ..core.sumprod import QueryCounter, SumProd
from ..core.tree import TreeArrays, all_tables_leaf_masks, predict_rows
from ..distributed import spmd
from .compile import CompiledEnsemble


def _mesh_of(ens):
    """The data mesh a model was built under (None: one process)."""
    return getattr(ens, "mesh", None)


def score_grouped(ens: CompiledEnsemble, group_by: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row-of-``group_by`` (Σ ŷ(x), count) over x ∈ ρ⋈J — one pass."""
    with spmd.use_data_mesh(_mesh_of(ens)):
        return ens.score_grouped(group_by)


def score_rows(ens: CompiledEnsemble, group_by: str, row_ids
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σŷ, count) for a batch of row ids of ``group_by``.

    Ids are validated on the host, so a lookup for a nonexistent row is
    rejected with ``IndexError`` naming the ids, before any gather."""
    ids = np.asarray(row_ids, np.int64).reshape(-1)
    n = ens.n_rows(group_by)
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        bad = ids[(ids < 0) | (ids >= n)][:5]
        raise IndexError(
            f"row ids out of range for table {group_by!r} (n_rows={n}): {bad.tolist()}")
    with spmd.use_data_mesh(_mesh_of(ens)):
        tot, cnt = ens.grouped_cached(group_by)
    idx = torch.from_numpy(ids).to(tot.device)
    return tot[idx], cnt[idx]


def score_mean_rows(ens: CompiledEnsemble, group_by: str, row_ids) -> torch.Tensor:
    """Mean prediction per row id (Σŷ / count, 0 for rows outside the join)."""
    tot, cnt = score_rows(ens, group_by, row_ids)
    return tot / torch.clamp(cnt, min=1.0)


def score_fresh(ens: CompiledEnsemble, features: Dict[str, np.ndarray]) -> torch.Tensor:
    """Score rows arriving with raw feature dicts (never stored in tables).

    ``features`` maps feature-column name → (batch,) values; every feature
    the schema exposes must be present (global feature order is taken from
    the schema)."""
    sch = ens.schema
    cols = []
    for (_, c) in sch.features:
        if c not in features:
            raise KeyError(f"score_fresh: missing feature column {c!r}")
        cols.append(np.asarray(features[c], np.float32))
    X = torch.from_numpy(np.stack(cols, axis=1)).to(sch.device)
    return predict_rows(ens.trees, X)


def score_grouped_reference(schema: Schema, trees: List[TreeArrays], group_by: str,
                            counter: Optional[QueryCounter] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-leaf scoring loop: one Arithmetic SumProd pass per leaf per
    tree + one count pass (n_trees·L + 1 queries, accounted analytically),
    in one process whatever mesh is active."""
    ar = Arithmetic()
    sp = SumProd(schema)
    dev = schema.device
    tot = torch.zeros((schema.table(group_by).n_rows,), dtype=torch.float32, device=dev)
    with spmd.use_data_mesh(None):
        for t in trees:
            lm = all_tables_leaf_masks(schema, t)
            for a in range(int(t.leaf.shape[0])):
                f = {tn: lm[tn][a].to(torch.float32) for tn in lm}
                tot = tot + t.leaf[a] * sp(ar, f, group_by=group_by)
        cnt = sp(ar, sp.ones_factors(ar), group_by=group_by)
    if counter is not None:
        counter.bump(sum(int(t.leaf.shape[0]) for t in trees) + 1)
    return tot, cnt
