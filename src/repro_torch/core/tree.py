"""Array-encoded regression trees + relational masks.

A tree of depth D is complete-binary in heap layout: internal node k at
level ℓ has within-level index k ∈ [0, 2^ℓ); its children are 2k (left)
and 2k+1 (right).  Splits are the paper's ``J_feat ≥ thr → right``.
Dead nodes (no valid split / empty) carry thr = +inf so every point
routes left; the left descendant leaf holds the node's mean.

The relational core never materializes J; node/leaf membership lives as
*per-table row masks*: a row r of table T_t passes node v iff it
satisfies every constraint on the root→v path whose feature is owned by
T_t (constraints on other tables' features don't constrain T_t's rows —
the ⊗ of factors conjoins them across tables inside the SumProd query).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from .schema import Schema


@dataclasses.dataclass
class TreeArrays:
    """One regression tree.  Leaves: L = 2^depth.

    feat:  (L-1,) int32   global feature id per internal node (-1 = dead)
    thr:   (L-1,) float32 threshold (+inf on dead nodes → route left)
    leaf:  (L,)   float32 leaf predictions
    """

    feat: torch.Tensor
    thr: torch.Tensor
    leaf: torch.Tensor

    @property
    def depth(self) -> int:
        return int(self.leaf.shape[0]).bit_length() - 1

    @staticmethod
    def empty(depth: int, device) -> "TreeArrays":
        L = 2 ** depth
        return TreeArrays(
            feat=torch.full((L - 1,), -1, dtype=torch.int32, device=device),
            thr=torch.full((L - 1,), float("inf"), dtype=torch.float32, device=device),
            leaf=torch.zeros((L,), dtype=torch.float32, device=device),
        )

    def level_slice(self, level: int):
        """Within-level views of feat/thr for nodes at ``level``."""
        start, size = 2 ** level - 1, 2 ** level
        return self.feat[start:start + size], self.thr[start:start + size]


def predict_rows(trees: List[TreeArrays], X: torch.Tensor, lr: float = 1.0) -> torch.Tensor:
    """Boosted prediction on a materialized feature matrix (tests/oracle).

    X: (n, d_global) in *global feature id* order.
    """
    out = torch.zeros((X.shape[0],), dtype=torch.float32, device=X.device)
    for t in trees:
        idx = torch.zeros((X.shape[0],), dtype=torch.int64, device=X.device)
        for level in range(t.depth):
            feat, thr = t.level_slice(level)
            f = feat[idx]
            th = thr[idx]
            v = torch.gather(X, 1, f.clamp(min=0).long()[:, None])[:, 0]
            go_right = (v >= th) & (f >= 0)
            idx = 2 * idx + go_right.long()
        out = out + lr * t.leaf[idx]
    return out


# ---------------------------------------------------------------------------
# Relational masks
# ---------------------------------------------------------------------------

def _local_feature_view(schema: Schema, table: str, featmat=None):
    """(g2l, featmat): map global feature id → local column, -1 if foreign."""
    g2l = [-1] * max(schema.n_features, 1)
    for g, (ti, li) in enumerate(schema.feat_global):
        if schema.tables[ti].name == table:
            g2l[g] = li
    fm = schema.featmat[table] if featmat is None else featmat
    return torch.tensor(g2l, dtype=torch.int64, device=fm.device), fm


def descend_masks_level(schema: Schema, table: str, feat: torch.Tensor, thr: torch.Tensor,
                        masks: torch.Tensor, featmat=None) -> torch.Tensor:
    """One level of mask refinement for ``table``.

    feat/thr: (K,) this level's chosen splits; masks: (K, n_rows) →
    (2K, n_rows).  Constraints on foreign features pass both children
    through.  Dead nodes (feat = -1, thr = +inf) route everything left,
    as :func:`predict_rows` does: their right child is empty in every
    table.  (The JAX package passes a dead node's rows to BOTH children,
    which counts them twice in training statistics and grouped scores.)
    """
    g2l, fm = _local_feature_view(schema, table, featmat)
    # torch indexing raises out of range where jnp.take clamps: clamp first
    local = torch.where(feat >= 0, g2l[feat.clamp(min=0).long()], -1)
    mine = local >= 0
    vals = fm[:, local.clamp(min=0)].T if fm.shape[1] else fm.new_zeros(
        (feat.shape[0], fm.shape[0]))                             # (K, n)
    cond = vals >= thr[:, None]
    live = (feat >= 0)[:, None]
    left = masks & (~mine[:, None] | ~cond)
    right = masks & (~mine[:, None] | cond) & live
    return torch.stack([left, right], dim=1).reshape(-1, masks.shape[-1])


def root_masks(schema: Schema, table: str, n_rows: int = None) -> torch.Tensor:
    n = schema.table(table).n_rows if n_rows is None else n_rows
    return torch.ones((1, n), dtype=torch.bool, device=schema.device)


def leaf_masks(schema: Schema, table: str, tree: TreeArrays, featmat=None) -> torch.Tensor:
    """(L, n_rows) bool: per-table projection of every leaf's J^{(ℓ)}.

    With ``featmat`` (k, d_t), masks are evaluated for those k feature
    rows instead of the whole stored table."""
    m = root_masks(schema, table, None if featmat is None else int(featmat.shape[0]))
    for level in range(tree.depth):
        feat, thr = tree.level_slice(level)
        m = descend_masks_level(schema, table, feat, thr, m, featmat)
    return m


def all_tables_leaf_masks(schema: Schema, tree: TreeArrays) -> Dict[str, torch.Tensor]:
    return {t.name: leaf_masks(schema, t.name, tree) for t in schema.tables}
