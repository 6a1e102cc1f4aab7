"""The tensor sketch of a join row, computed row by row (paper §3).

Each table t hashes its rows by w_t, the id of the row's projection onto
the columns the table owns (the columns it is the first to hold, its
keys and label included), numbered in lexicographic order.  With the
run's constants (a, b, a2, b2) per table and k = 2^M buckets:

    h_t(w) = ((a·w + b) mod 2^32) >> (32 − M),
    s_t(w) = 1 − 2·(((a2·w + b2) mod 2^32) >> 31),

and a join row x lands in bucket Σ_t h_t(w_t(x)) mod k with sign
Π_t s_t(w_t(x)).  A node's sketched SSR grouped by table g is
Σ over (row of g, bucket) of (Σ r(x)·sign(x))², over the node's rows x.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from rbrt_bench.lib.data import Dataset
from .join import Join, dense_ids

MASK32 = (1 << 32) - 1


def owned_ids(ds: Dataset) -> Dict[str, np.ndarray]:
    owner: Dict[str, str] = {}
    for t in ds.tables:
        for c in t.columns:
            owner.setdefault(c, t.name)
    out = {}
    for t in ds.tables:
        owned = [c for c in t.columns if owner[c] == t.name]
        out[t.name] = (dense_ids([t.columns[c] for c in owned]) if owned
                       else np.zeros(t.n_rows, np.int64))
    return out


def hash_rows(w: np.ndarray, const: Tuple[int, int, int, int], k: int):
    shift = 32 - (int(k).bit_length() - 1)
    a, b, a2, b2 = (np.uint64(c) for c in const)
    x = w.astype(np.uint64) & np.uint64(MASK32)
    bucket = ((a * x + b) & np.uint64(MASK32)) >> np.uint64(shift)
    top = ((a2 * x + b2) & np.uint64(MASK32)) >> np.uint64(31)
    return bucket.astype(np.int64), 1.0 - 2.0 * top.astype(np.float64)


def join_sketch(ds: Dataset, join: Join, consts: Dict[str, Tuple[int, int, int, int]],
                k: int):
    """(bucket, sign) of every join row."""
    ids = owned_ids(ds)
    bucket = np.zeros(join.n, np.int64)
    sign = np.ones(join.n, np.float64)
    for t in ds.tables:
        hb, hs = hash_rows(ids[t.name], consts[t.name], k)
        bucket += hb[join.rows[t.name]]
        sign *= hs[join.rows[t.name]]
    return bucket % k, sign
