"""Typed table deltas + the dynamic (capacity-padded) relational state.

Incremental view maintenance (Kara et al.'s static/dynamic split) needs
three things the static :class:`~repro_torch.core.schema.Schema` does not
provide: a mutable row store, a stable row-id space under churn, and
join-key dictionaries that grow as unseen keys arrive.  This module
provides them host-side, in numpy, with the JAX package's semantics:

- :class:`TableDelta` — one batch of inserts / deletes / updates against
  one table (the unit ``MaintainedScorer.apply`` consumes).
- :class:`DynamicTable` — a capacity-padded column store with a liveness
  mask.  Deletes mark slots dead (their factor rows become the semiring
  ⊕-identity, so they drop out of every join); inserts fill the lowest
  free slots and double capacity when none remain.  Row ids ARE slots:
  they never shift, so memoized grouped scores stay aligned across
  deltas.
- :class:`DynamicEdge` — an insertion-ordered dense key dictionary for
  one undirected join-tree edge.  Existing key ids are never renumbered
  (messages stay cacheable); unseen key tuples append, and a key present
  on only one side simply ⊕-contributes to a segment nobody gathers —
  exactly natural-join semantics.

Key ids are assigned by :func:`assign_ids`: the ids a loop of
``dict.setdefault`` over the rows in order gives, with the Python loop
running over the distinct keys only (a fact table of millions of rows
holds a few thousand keys).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.schema import Table, dense_ids


def assign_ids(key_to_id: Dict[Tuple, int], cols: Sequence[np.ndarray]) -> np.ndarray:
    """Dense id per row of the key tuples ``zip(*cols)``: a known key keeps
    its id, and unseen keys take the next ids in the order of their first
    row, entering ``key_to_id`` — the result of ``key_to_id.setdefault(key,
    len(key_to_id))`` row by row.  Each key is a tuple of the columns'
    numpy scalars, so a key holding a NaN equals no stored key: every
    such row takes a new id (``dense_ids`` puts each in a group of its
    own)."""
    n = len(cols[0]) if cols else 0
    if n == 0:
        return np.zeros((0,), np.int64)
    inv = dense_ids(list(cols))                    # group of each row
    n_groups = int(inv.max()) + 1
    first = np.full(n_groups, n, np.int64)
    np.minimum.at(first, inv, np.arange(n))        # each group's first row
    seen = np.argsort(first, kind="stable")        # groups in first-row order
    gid = np.empty(n_groups, np.int64)
    rows = first[seen]
    for g, key in zip(seen, zip(*(np.asarray(c)[rows] for c in cols))):
        gid[g] = key_to_id.setdefault(key, len(key_to_id))
    return gid[inv]


@dataclasses.dataclass
class TableDelta:
    """One batch of row changes against one table.

    inserts: column → (k,) values; every column of the table required.
    deletes: (k,) slot ids (must be live).
    updates: (slots, {column → (k,) values}) — non-key columns only; a
    join-key change is semantically delete + insert and must be issued
    as such (it moves the row between join groups).
    """

    table: str
    inserts: Optional[Dict[str, np.ndarray]] = None
    deletes: Optional[np.ndarray] = None
    updates: Optional[Tuple[np.ndarray, Dict[str, np.ndarray]]] = None

    @property
    def n_ops(self) -> int:
        n = 0
        if self.inserts:
            n += len(next(iter(self.inserts.values())))
        if self.deletes is not None:
            n += len(self.deletes)
        if self.updates is not None:
            n += len(self.updates[0])
        return n


class DynamicTable:
    """Capacity-padded mutable mirror of one :class:`Table`."""

    def __init__(self, table: Table, slack: float = 0.25):
        n = table.n_rows
        self.name = table.name
        self.feature_columns = tuple(table.feature_columns)
        self.capacity = n + max(1, int(np.ceil(slack * n)))
        self.columns: Dict[str, np.ndarray] = {}
        for c, v in table.columns.items():
            v = np.asarray(v)
            pad = np.zeros((self.capacity - n,), v.dtype)
            self.columns[c] = np.concatenate([v, pad])
        self.live = np.zeros((self.capacity,), bool)
        self.live[:n] = True

    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    def live_slots(self) -> np.ndarray:
        return np.flatnonzero(self.live)

    def _grow(self, need: int):
        new_cap = max(2 * self.capacity, self.capacity + need)
        for c, v in self.columns.items():
            pad = np.zeros((new_cap - self.capacity,), v.dtype)
            self.columns[c] = np.concatenate([v, pad])
        self.live = np.concatenate(
            [self.live, np.zeros((new_cap - self.capacity,), bool)]
        )
        self.capacity = new_cap

    def apply(self, delta: TableDelta) -> Tuple[np.ndarray, bool]:
        """Apply one delta.  Returns (slots whose values changed — updates
        then inserts, in application order — and whether capacity grew).
        Deletes are reported via the (cleared) ``live`` mask."""
        if delta.table != self.name:
            raise ValueError(f"delta for {delta.table!r} applied to {self.name!r}")
        grew = False
        if delta.deletes is not None and len(delta.deletes):
            slots = np.unique(np.asarray(delta.deletes, np.int64))
            if slots.min() < 0 or slots.max() >= self.capacity or not self.live[slots].all():
                raise IndexError(f"delete of non-live slots in table {self.name!r}")
            self.live[slots] = False
        changed: List[np.ndarray] = []
        if delta.updates is not None:
            slots, cols = delta.updates
            slots = np.asarray(slots, np.int64)
            if len(slots):
                if slots.min() < 0 or slots.max() >= self.capacity or not self.live[slots].all():
                    raise IndexError(f"update of non-live slots in table {self.name!r}")
                for c, v in cols.items():
                    if c not in self.columns:
                        raise KeyError(f"table {self.name!r} has no column {c!r}")
                    self.columns[c][slots] = np.asarray(v, self.columns[c].dtype)
                changed.append(slots)
        if delta.inserts:
            missing = set(self.columns) - set(delta.inserts)
            if missing:
                raise KeyError(f"insert into {self.name!r} missing columns {sorted(missing)}")
            k = len(next(iter(delta.inserts.values())))
            free = np.flatnonzero(~self.live)
            if len(free) < k:
                self._grow(k - len(free))
                grew = True
                free = np.flatnonzero(~self.live)
            slots = free[:k]
            for c, v in delta.inserts.items():
                self.columns[c][slots] = np.asarray(v, self.columns[c].dtype)
            self.live[slots] = True
            changed.append(slots)
        out = (np.concatenate(changed) if changed
               else np.zeros((0,), np.int64))
        return out, grew

    def effective(self) -> Table:
        """The current logical table: live rows in slot order (the oracle
        a fresh compile is checked against, bit-for-bit)."""
        slots = self.live_slots()
        return Table(
            name=self.name,
            columns={c: v[slots].copy() for c, v in self.columns.items()},
            feature_columns=self.feature_columns,
        )


class DynamicEdge:
    """Maintained dense key dictionary for one undirected join edge.

    Ids are insertion-ordered and append-only: cached messages indexed by
    key id stay valid as the domain grows (new ids pad with ⊕-identity).
    Dead/never-filled slots carry id 0 — their factor rows are semiring
    zero, so they ⊕-contribute nothing to segment 0.

    ``versions[table]`` counts the writes to that table's id array (an
    assignment or a pad for capacity growth): a join tree built from the
    ids rebuilds an edge's device arrays only when its count moved.
    """

    def __init__(self, a: DynamicTable, b: DynamicTable, key_cols: Sequence[str]):
        self.key_cols = tuple(key_cols)
        self.tables = (a.name, b.name)
        self.key_to_id: Dict[Tuple, int] = {}
        self.ids: Dict[str, np.ndarray] = {
            t.name: np.zeros((t.capacity,), np.int32) for t in (a, b)
        }
        self.versions: Dict[str, int] = {t.name: 0 for t in (a, b)}
        for t in (a, b):
            self.assign(t, t.live_slots())

    @property
    def n_keys(self) -> int:
        return max(len(self.key_to_id), 1)

    def assign(self, table: DynamicTable, slots: np.ndarray) -> bool:
        """(Re)assign key ids for ``slots`` of ``table``; returns whether
        the key domain grew (cached messages then need ⊕-identity pads)."""
        if table.name not in self.ids:
            raise KeyError(f"table {table.name!r} not on edge {self.tables}")
        ids = self.ids[table.name]
        if len(ids) < table.capacity:                    # capacity grew
            pad = np.zeros((table.capacity - len(ids),), np.int32)
            self.ids[table.name] = ids = np.concatenate([ids, pad])
            self.versions[table.name] += 1
        before = len(self.key_to_id)
        if len(slots):
            # a multi-column key is one row of the stacked columns (their
            # common dtype), as the JAX package keys its dictionary
            mat = np.stack([table.columns[c][slots] for c in self.key_cols], axis=1)
            ids[slots] = assign_ids(self.key_to_id, list(mat.T))
            self.versions[table.name] += 1
        return len(self.key_to_id) > before
