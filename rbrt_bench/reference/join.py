"""The natural join of a generated database, materialized: for every row
of the join, the row of each table it came from.

Plain numpy, independent of the program: the join is grown from the
first table by adding, one at a time, a table that shares columns with
those joined so far, matched on all the columns it shares.  Each added
table must hold its key once a row (a dimension), which every schema of
this benchmark satisfies; a joined row without a match leaves the join.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from rbrt_bench.lib.data import Dataset


def dense_ids(cols: Sequence[np.ndarray]) -> np.ndarray:
    """Ids of the distinct key tuples, numbered in lexicographic order of
    the tuples (first column first), compared as float64."""
    mat = [np.asarray(c).astype(np.float64) for c in cols]
    order = np.lexsort(mat[::-1])
    new = np.zeros(len(order), bool)
    if len(order):
        new[0] = True
        for c in mat:
            srt = c[order]
            new[1:] |= srt[1:] != srt[:-1]
    ids = np.empty(len(order), np.int64)
    ids[order] = np.cumsum(new) - 1
    return ids


@dataclasses.dataclass
class Join:
    rows: Dict[str, np.ndarray]      # table → its row of each join row
    n: int

    def column(self, ds: Dataset, table: str, col: str) -> np.ndarray:
        return np.asarray(ds.table(table).columns[col])[self.rows[table]]


def materialize(ds: Dataset) -> Join:
    first = ds.tables[0]
    rows: Dict[str, np.ndarray] = {first.name: np.arange(first.n_rows)}
    have = {c: first.name for c in first.columns}
    left: List = list(ds.tables[1:])
    while left:
        t = next((t for t in left if any(c in have for c in t.columns)), None)
        if t is None:
            raise ValueError("the tables do not join into one (a cross join)")
        left.remove(t)
        shared = [c for c in t.columns if c in have]
        n = len(next(iter(rows.values())))
        joined = [np.asarray(ds.table(have[c]).columns[c])[rows[have[c]]] for c in shared]
        mine = [np.asarray(t.columns[c]) for c in shared]
        ids = dense_ids([np.concatenate([j, m]) for j, m in zip(joined, mine)])
        jid, tid = ids[:n], ids[n:]
        if len(np.unique(tid)) != len(tid):
            raise ValueError(f"table {t.name} holds a key of {shared} more than once")
        row_of = np.full(int(ids.max()) + 1 if len(ids) else 0, -1, np.int64)
        row_of[tid] = np.arange(t.n_rows)
        hit = row_of[jid]
        keep = hit >= 0
        rows = {name: r[keep] for name, r in rows.items()}
        rows[t.name] = hit[keep]
        for c in t.columns:
            have.setdefault(c, t.name)
    return Join(rows=rows, n=len(next(iter(rows.values()))))
