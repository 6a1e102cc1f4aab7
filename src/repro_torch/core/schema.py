"""Relational schema: tables, join hypergraph, GYO acyclicity, join trees.

A dataset with d features is stored in τ tables; the design matrix
``J = T_1 ⋈ … ⋈ T_τ`` (natural join, bag semantics) is *never*
materialized outside tests.  Schema construction runs once on the host
in numpy: it decides acyclicity by the GYO ear decomposition (paper
Def. A.4; the ear-witness edges *are* the join tree), roots a join tree
at every table, and builds each edge's dense key dictionary.  The
results then move to ``schema.device`` once, and every query follows
that device.

Each join-tree edge also carries the CSR of its child key ids (a stable
argsort plus key offsets, :class:`~repro_torch.kernels.segment_sum.Segments`).
The ids never change for a schema, so the CSR is built here and never
per query; it is the input of the segment-⊕ kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..kernels.segment_sum import Segments


class NotAcyclicError(ValueError):
    """Raised when the join hypergraph has no GYO ear decomposition."""


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device on a host without
    one raises instead of silently running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the host")
    return dev


@dataclasses.dataclass
class Table:
    """A named relation.  All columns are 1-D numpy arrays of equal length.

    ``feature_columns``: the columns on which tree splits may be proposed.
    Join keys are inferred by natural-join semantics: any column name
    appearing in more than one table.  Key columns must be integer-typed.
    """

    name: str
    columns: Dict[str, np.ndarray]
    feature_columns: Tuple[str, ...] = ()

    def __post_init__(self):
        lens = {len(v) for v in self.columns.values()}
        if len(lens) != 1:
            raise ValueError(f"table {self.name}: ragged columns {lens}")
        if not self.feature_columns:
            self.feature_columns = tuple(self.columns.keys())
        for c in self.feature_columns:
            if c not in self.columns:
                raise ValueError(f"table {self.name}: unknown feature column {c}")

    @property
    def n_rows(self) -> int:
        return len(next(iter(self.columns.values())))

    def col(self, name: str) -> np.ndarray:
        return np.asarray(self.columns[name])


@dataclasses.dataclass(frozen=True)
class TreeEdge:
    """Directed join-tree edge child → parent with a dense key dictionary."""

    child: int                 # table index
    parent: int                # table index
    key_cols: Tuple[str, ...]  # shared columns (the join key of this edge)
    child_seg: Segments        # child key id per row + its CSR
    parent_ids: torch.Tensor   # (n_parent,) int64 dense key id per parent row

    @property
    def n_keys(self) -> int:
        return self.child_seg.n_keys

    @property
    def child_ids(self) -> torch.Tensor:
        return self.child_seg.ids

    @property
    def child_order(self) -> torch.Tensor:
        return self.child_seg.order

    @property
    def child_offsets(self) -> torch.Tensor:
        return self.child_seg.offsets


@dataclasses.dataclass(frozen=True)
class JoinTree:
    """Leaf→root elimination order for one root table."""

    root: int
    edges: Tuple[TreeEdge, ...]   # in elimination (leaf-first) order


def dense_ids(cols: Sequence[np.ndarray]) -> np.ndarray:
    """Dense ids of the distinct key tuples, numbered in lexicographic
    tuple order — the ids ``np.unique(np.stack(cols, 1), axis=0,
    return_inverse=True)`` gives, computed with 1-D ``np.unique`` for a
    single column and ``np.lexsort`` otherwise (the row-wise unique
    sorts structured records and takes many seconds at millions of
    rows)."""
    if len(cols) == 1:
        _, inv = np.unique(cols[0], return_inverse=True)
        return inv.reshape(-1).astype(np.int64)
    mat = np.stack(cols, axis=1)               # the common dtype, as the row-wise unique
    order = np.lexsort(mat.T[::-1])            # first column primary
    srt = mat[order]
    new = np.ones(len(mat), bool)
    np.any(srt[1:] != srt[:-1], axis=1, out=new[1:])
    ids = np.empty(len(mat), np.int64)
    ids[order] = np.cumsum(new) - 1
    return ids


def _key_dict(ta: Table, tb: Table, cols: Sequence[str]):
    """Dense dictionary over the union of both tables' key tuples."""
    both = [np.concatenate([ta.col(c), tb.col(c)]) for c in cols]
    inv = dense_ids(both)
    n = int(inv.max()) + 1 if len(inv) else 0
    return inv[: ta.n_rows], inv[ta.n_rows:], n


class Schema:
    """An acyclic relational schema plus all static query-plan artifacts,
    resident on ``device``."""

    def __init__(self, tables: Sequence[Table], label: Tuple[str, str],
                 device="cuda"):
        self.device = resolve_device(device)
        self.tables: List[Table] = list(tables)
        self.names = [t.name for t in self.tables]
        if len(set(self.names)) != len(self.names):
            raise ValueError("duplicate table names")
        self.index = {n: i for i, n in enumerate(self.names)}
        self.label_table, self.label_column = label
        if self.label_table not in self.index:
            raise ValueError(f"label table {self.label_table} not in schema")

        # feature ownership: first table containing a column owns it
        self.owner: Dict[str, str] = {}
        for t in self.tables:
            for c in t.columns:
                self.owner.setdefault(c, t.name)
        # global feature list: every ownable column except the label
        self.features: List[Tuple[str, str]] = []
        for t in self.tables:
            for c in t.feature_columns:
                if self.owner[c] == t.name and not (
                    t.name == self.label_table and c == self.label_column
                ):
                    self.features.append((t.name, c))

        self._undirected_edges = self._gyo()
        self._tree_cache: Dict[int, JoinTree] = {}
        for n in self.names:
            self._build_join_tree(n)

        # per-table feature matrices (n_rows, d_t) float32
        self.feat_cols: Dict[str, List[str]] = {
            t.name: [c for (tn, c) in self.features if tn == t.name] for t in self.tables
        }
        self.featmat: Dict[str, torch.Tensor] = {}
        for t in self.tables:
            cols = self.feat_cols[t.name]
            fm = (np.stack([t.col(c).astype(np.float32) for c in cols], axis=1)
                  if cols else np.zeros((t.n_rows, 0), np.float32))
            self.featmat[t.name] = torch.from_numpy(fm).to(self.device)
        # global feature id → (table idx, local idx)
        self.feat_global: List[Tuple[int, int]] = []
        for ti, t in enumerate(self.tables):
            for li, _ in enumerate(self.feat_cols[t.name]):
                self.feat_global.append((ti, li))
        self.n_features = len(self.feat_global)

        self.labels = torch.from_numpy(
            self.tables[self.index[self.label_table]].col(self.label_column)
            .astype(np.float32)).to(self.device)

        # sketch projection dictionaries (paper §3: w_t(x), |D_t|):
        # D_t = distinct projections of T_t onto its *owned* columns
        self.w_ids: Dict[str, torch.Tensor] = {}
        self.domain_sizes: Dict[str, int] = {}
        for t in self.tables:
            owned = [c for c in t.columns if self.owner[c] == t.name]
            if owned:
                inv = dense_ids([t.col(c) for c in owned])
                self.w_ids[t.name] = torch.from_numpy(inv).to(self.device)
                self.domain_sizes[t.name] = int(inv.max()) + 1
            else:
                self.w_ids[t.name] = torch.zeros(t.n_rows, dtype=torch.int64,
                                                 device=self.device)
                self.domain_sizes[t.name] = 1

    # ------------------------------------------------------------------ GYO --
    def _gyo(self):
        """GYO ear decomposition.  Returns undirected join-tree edges;
        raises NotAcyclicError if the hypergraph is cyclic."""
        cols = {t.name: set(t.columns) for t in self.tables}
        alive = set(self.names)
        edges: List[Tuple[str, str, Tuple[str, ...]]] = []
        while len(alive) > 1:
            progress = False
            for a in sorted(alive):
                others = [b for b in alive if b != a]
                shared = {c for c in cols[a] if any(c in cols[b] for b in others)}
                witness = next((b for b in sorted(others) if shared <= cols[b]), None)
                if witness is not None:
                    edges.append((a, witness, tuple(sorted(shared))))
                    alive.remove(a)
                    progress = True
                    break
            if not progress:
                raise NotAcyclicError(
                    f"join hypergraph is cyclic (stuck with {sorted(alive)}); "
                    "fhtw > 1 is out of scope (paper handles acyclic joins)"
                )
        return edges

    # ------------------------------------------------------------- join tree --
    def join_tree(self, root: str) -> JoinTree:
        """Rooted join tree (built once in __init__)."""
        return self._tree_cache[self.index[root]]

    def _build_join_tree(self, root: str) -> JoinTree:
        ri = self.index[root]
        adj: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {n: [] for n in self.names}
        for a, b, key in self._undirected_edges:
            adj[a].append((b, key))
            adj[b].append((a, key))
        parent: Dict[str, Tuple[str, Tuple[str, ...]]] = {}
        seen = {root}
        frontier = [root]
        order = [root]
        while frontier:
            nxt = []
            for u in frontier:
                for v, key in adj[u]:
                    if v not in seen:
                        seen.add(v)
                        parent[v] = (u, key)
                        nxt.append(v)
                        order.append(v)
            frontier = nxt
        if len(seen) != len(self.names):
            raise ValueError("join graph is disconnected (cross join unsupported)")
        edges = []
        for v in reversed(order[1:]):          # elimination order: leaves first
            p, key = parent[v]
            cid, pid, n = _key_dict(self.tables[self.index[v]],
                                    self.tables[self.index[p]], key)
            edges.append(TreeEdge(
                child=self.index[v], parent=self.index[p], key_cols=key,
                child_seg=Segments.from_ids(cid, n, self.device),
                parent_ids=torch.from_numpy(pid).to(self.device),
            ))
        jt = JoinTree(root=ri, edges=tuple(edges))
        self._tree_cache[ri] = jt
        return jt

    # ----------------------------------------------------------------- misc --
    @property
    def n_tables(self) -> int:
        return len(self.tables)

    def table(self, name: str) -> Table:
        return self.tables[self.index[name]]

    def feature_name(self, gid: int) -> Tuple[str, str]:
        ti, li = self.feat_global[gid]
        t = self.tables[ti]
        return t.name, self.feat_cols[t.name][li]
