"""What the benchmark hands the port, and what it takes back.

The port receives the generated numpy columns (as its ``Table`` and
``Schema``), sketch hash constants and, for scoring, ensembles; all of
these the benchmark makes from the seed, so the plain reference gets the
same.  Back come trees, SSRs and grouped scores, moved to numpy.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from .data import Dataset, seed_rng


def hash_constants(ds: Dataset, seed: int) -> Dict[str, Tuple[int, int, int, int]]:
    """Per table (a, b, a2, b2) of the multiply-add-shift hashes: a and a2
    odd, all below 2^32."""
    rng = seed_rng(seed, 9)
    draw = lambda: int(rng.integers(0, 2 ** 31 - 1))
    out = {}
    for t in ds.tables:
        out[t.name] = ((2 * draw() + 1) & 0xFFFFFFFF, draw(), (2 * draw() + 1) & 0xFFFFFFFF,
                       draw())
    return out


def table_hashes(consts, k: int):
    from repro_torch.core.sketch import Hash2, TableHashes

    return TableHashes(hashes={t: Hash2(a=a, b=b, a2=a2, b2=b2, k=k)
                               for t, (a, b, a2, b2) in consts.items()}, k=k)


def schema(ds: Dataset, device: str):
    """The port's schema of ``ds``, and the seconds its build took (ended
    by a synchronize)."""
    import torch
    from repro_torch.core import Schema, Table

    t0 = time.perf_counter()
    tables = [Table(t.name, dict(t.columns), tuple(t.features)) for t in ds.tables]
    sch = Schema(tables, label=tuple(ds.label), device=device)
    if sch.device.type == "cuda":
        torch.cuda.synchronize()
    return sch, time.perf_counter() - t0


def random_trees(ds: Dataset, seed: int, n_trees: int, depth: int, stream: int = 0):
    """An ensemble made from the seed: each split on a feature drawn
    uniformly, at the value of that feature in a random row of its table,
    leaves N(0, 1).  Returns (feat int32, thr float32, leaf float32) per
    tree, in the global feature order."""
    rng = seed_rng(seed, 5, stream)
    feats = ds.feature_order()
    trees = []
    for _ in range(n_trees):
        f = rng.integers(0, len(feats), 2 ** depth - 1)
        thr = np.empty(len(f), np.float32)
        for h, j in enumerate(f):
            tname, col = feats[j]
            vals = np.asarray(ds.table(tname).columns[col])
            thr[h] = np.float32(vals[rng.integers(0, len(vals))])
        trees.append((f.astype(np.int32), thr, rng.normal(0, 1, 2 ** depth).astype(np.float32)))
    return trees


def to_port_trees(trees, device):
    import torch
    from repro_torch.core import TreeArrays

    return [TreeArrays(feat=torch.as_tensor(f, device=device),
                       thr=torch.as_tensor(t, device=device),
                       leaf=torch.as_tensor(l, device=device)) for f, t, l in trees]


def from_port_trees(trees) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    return [(t.feat.cpu().numpy(), t.thr.cpu().numpy(), t.leaf.cpu().numpy()) for t in trees]
