"""Grouped scores of an ensemble on the materialized join, and their check.

A join row's prediction is the sum of its leaves' values, a tree sending
x right where x_j ≥ θ and every row left at a dead node (feature −1).
Grouped by a table, a row of that table gets the sum of the predictions
of the join rows it takes part in, and their count.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from rbrt_bench.lib.data import Dataset
from .join import Join


def predict(X: torch.Tensor, trees) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ leaf values, Σ |leaf values|) of every row, in X's dtype."""
    out = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
    mag = torch.zeros_like(out)
    for feat, thr, leaf in trees:
        depth = int(len(leaf)).bit_length() - 1
        feat_t = torch.as_tensor(np.asarray(feat, np.int64), device=X.device)
        thr_t = torch.as_tensor(np.asarray(thr, np.float64), device=X.device).to(X.dtype)
        leaf_t = torch.as_tensor(np.asarray(leaf, np.float64), device=X.device).to(X.dtype)
        idx = torch.zeros(X.shape[0], dtype=torch.int64, device=X.device)
        for level in range(depth):
            h = 2 ** level - 1 + idx
            f = feat_t[h]
            v = torch.gather(X, 1, f.clamp(min=0)[:, None])[:, 0]
            idx = 2 * idx + ((v >= thr_t[h]) & (f >= 0)).long()
        out += leaf_t[idx]
        mag += leaf_t[idx].abs()
    return out, mag


def design(ds: Dataset, join: Join, device, dtype=torch.float64) -> torch.Tensor:
    cols = [join.column(ds, t, c).astype(np.float32) for t, c in ds.feature_order()]
    return torch.from_numpy(np.stack(cols, 1)).to(device).to(dtype)


def grouped(ds: Dataset, join: Join, X: torch.Tensor, trees, group_by: str):
    """(Σŷ, count, Σ|ŷ|) per row of ``group_by``, in X's dtype and device
    (the reference: float64)."""
    pred, mag = predict(X, trees)
    g = torch.from_numpy(join.rows[group_by]).to(X.device)
    n = ds.table(group_by).n_rows
    tot = torch.zeros(n, dtype=X.dtype, device=X.device).index_add_(0, g, pred)
    absum = torch.zeros_like(tot).index_add_(0, g, mag)
    cnt = torch.zeros_like(tot).index_add_(0, g, torch.ones_like(pred))
    return tot, cnt, absum


def gaps(ref, tot_p: np.ndarray, cnt_p: np.ndarray) -> Dict[str, float]:
    """``count_gap``: the largest count off (exact, so its limit is 0);
    ``total_gap``: the largest total off, as a share of that group's
    Σ|ŷ| (1 for a group that the join does not reach, if its total is
    not 0).  Rows past the reference's (a maintained table's spare
    capacity) must read (0, 0)."""
    tot, cnt, absum = (x.double().cpu().numpy() for x in ref)
    n = len(tot)
    tot_p, cnt_p = np.asarray(tot_p, np.float64), np.asarray(cnt_p, np.float64)
    extra = np.abs(np.concatenate([tot_p[n:], cnt_p[n:]]))
    count_gap = float(max(np.abs(cnt_p[:n] - cnt).max(initial=0.0), extra.max(initial=0.0)))
    d = np.abs(tot_p[:n] - tot)
    total_gap = float(np.where(absum > 0, d / np.maximum(absum, 1e-300),
                               (d > 0).astype(np.float64)).max(initial=0.0))
    return {"count_gap": count_gap, "total_gap": total_gap}
