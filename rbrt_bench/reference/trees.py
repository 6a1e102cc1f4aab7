"""Greedy boosted regression trees on the materialized join (paper Alg. 1
and 3), in plain PyTorch, and the check of a fit against them.

A tree of depth D grows level by level; a node's split (feature j,
threshold θ) sends x right where x_j ≥ θ and scores S_L²/n_L + S_R²/n_R
over the node's residuals r; its gain is that score less S²/n.  A node
whose best gain is not above ``min_gain`` is dead: its rows all go left
and both children keep its mean.  Leaves hold lr times the mean
residual, the root's mean being 0.  A level's SSR per grouping table is
Σ y² over the node for the first tree, else the sketched norm
(``sketch.py``).

:func:`fit` is the reference put in the program's place (any dtype: the
control runs it in bfloat16).  :func:`check` follows a fit's own splits,
node by node, in float64, and returns three numbers: the worst shortfall
of a chosen split's gain below the best gain there (a share of the
best), the worst leaf gap (a share of the tree's largest leaf), and the
worst SSR gap (a share of the level's total SSR for that table).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from rbrt_bench.lib.data import Dataset
from .join import Join
from .sketch import join_sketch


class Design:
    """The join's features, label, groups and sketch on a device."""

    def __init__(self, ds: Dataset, join: Join, consts, k: int, device, dtype):
        self.feats = ds.feature_order()
        cols = [join.column(ds, t, c).astype(np.float32) for t, c in self.feats]
        X = torch.from_numpy(np.stack(cols, 1)).to(device)
        self.X = X.to(dtype)
        self.y = torch.from_numpy(join.column(ds, *ds.label).astype(np.float32)).to(device).to(dtype)
        self.order = [torch.argsort(self.X[:, j], stable=True) for j in range(len(self.feats))]
        self.ssr_tables = [t.name for t in ds.tables if any(ft == t.name for ft, _ in self.feats)]
        self.group = {t: torch.from_numpy(join.rows[t]).to(device) for t in self.ssr_tables}
        bucket, sign = join_sketch(ds, join, consts, k)
        self.bucket = torch.from_numpy(bucket).to(device)
        self.sign = torch.from_numpy(sign).to(device).to(dtype)
        self.k = k
        self.dtype = dtype


def _best(d: Design, node: torch.Tensor, r: torch.Tensor):
    """(gain, feature, threshold, (n_L, S_L, n_R, S_R)) of the best split
    of one node; ties go to the lower feature, then the lower threshold."""
    best = (-np.inf, -1, np.inf, None)
    m = int(node.sum())
    if m < 2:
        return best
    S = r[node].sum()
    base = float(S * S / m)
    for j, order in enumerate(d.order):
        sel = order[node[order]]
        vals, rr = d.X[sel, j], r[sel]
        cs = torch.cumsum(rr, 0)[:-1]
        nl = torch.arange(1, m, device=r.device, dtype=r.dtype)
        nr = m - nl
        score = cs * cs / nl + (S - cs) * (S - cs) / nr
        score = torch.where(vals[1:] > vals[:-1], score, torch.full_like(score, -np.inf))
        p = int(torch.argmax(score))
        g = float(score[p]) - base
        if g > best[0]:
            best = (g, j, float(vals[p + 1]), (float(nl[p]), float(cs[p]), float(nr[p]),
                                               float(S - cs[p])))
    return best


def _split_gain(d: Design, node, r, feat: int, thr: float):
    if feat < 0:
        return 0.0, None
    right = node & (d.X[:, feat] >= thr)
    left = node & ~right
    nl, nr = float(left.sum()), float(right.sum())
    if nl == 0 or nr == 0:
        return 0.0, None
    sl, sr = r[left].sum(), r[right].sum()
    S = sl + sr
    return float(sl * sl / nl + sr * sr / nr - S * S / (nl + nr)), (nl, float(sl), nr, float(sr))


def _ssr(d: Design, node, r, table: str, first_tree: bool) -> float:
    if first_tree:
        yy = d.y[node]
        return float((yy * yy).sum())
    key = d.group[table][node] * d.k + d.bucket[node]
    uniq, inv = torch.unique(key, return_inverse=True)
    acc = torch.zeros(len(uniq), dtype=r.dtype, device=r.device)
    acc.index_add_(0, inv, (r * d.sign)[node])
    return float((acc * acc).sum())


def _grow(d: Design, cfg: dict, r: torch.Tensor, first_tree: bool, follow=None):
    """One tree.  ``follow`` (feat, thr) makes it take those splits and
    report the gain shortfalls; else it chooses its own."""
    depth, min_gain = cfg["depth"], cfg.get("min_gain", 1e-7)
    n = r.shape[0]
    idx = torch.zeros(n, dtype=torch.int64, device=r.device)
    mean = [0.0]
    feat = np.full(2 ** depth - 1, -1, np.int32)
    thr = np.full(2 ** depth - 1, np.inf, np.float32)
    gaps, ssr = [], []
    for level in range(depth):
        K = 2 ** level
        nodes = [idx == v for v in range(K)]
        ssr.append({t: np.array([_ssr(d, nd, r, t, first_tree) for nd in nodes])
                    for t in d.ssr_tables})
        new_mean, go_right = [], torch.zeros(n, dtype=torch.bool, device=r.device)
        for v, nd in enumerate(nodes):
            h = 2 ** level - 1 + v
            g_best, f, th, parts = _best(d, nd, r)
            if follow is not None:
                f, th = int(follow[0][h]), float(follow[1][h])
                g, parts = _split_gain(d, nd, r, f, th)
                gaps.append(max(0.0, g_best - g) / g_best if g_best > min_gain and f >= 0
                            else (1.0 if g_best > min_gain else 0.0))
            elif not g_best > min_gain:
                f, th, parts = -1, np.inf, None
            if f >= 0 and parts is not None and parts[0] > 0 and parts[2] > 0:
                feat[h], thr[h] = f, th
                nl, sl, nr, sr = parts
                new_mean += [sl / nl, sr / nr]
                go_right |= nd & (d.X[:, f] >= th)
            else:
                new_mean += [mean[v], mean[v]]
        idx = 2 * idx + go_right.long()
        mean = new_mean
    leaf = np.asarray(mean, np.float64) * cfg.get("lr", 1.0)
    return feat, thr, leaf, idx, ssr, gaps


def fit(d: Design, cfg: dict) -> dict:
    """The reference's own fit, in ``d``'s dtype: trees and SSRs in the
    program's form."""
    r = d.y.clone()
    trees, ssrs = [], []
    for i in range(cfg["n_trees"]):
        feat, thr, leaf, idx, ssr, _ = _grow(d, cfg, r, i == 0)
        leaf_t = torch.from_numpy(leaf).to(r.device).to(r.dtype)
        r = r - leaf_t[idx]
        trees.append((feat, thr, leaf.astype(np.float32)))
        ssrs.append(ssr)
    return {"trees": trees, "ssr": ssrs}


def check(d: Design, cfg: dict, out: dict) -> Dict[str, float]:
    """The three gaps of a fit (``out``: its trees and SSRs) against the
    reference in float64 following its splits."""
    r = d.y.to(torch.float64).clone()
    split_gap = leaf_gap = ssr_gap = 0.0
    for i, ((feat, thr, leaf_p), ssr_p) in enumerate(zip(out["trees"], out["ssr"])):
        _, _, leaf, idx, ssr, gaps = _grow(d, cfg, r, i == 0, follow=(feat, thr))
        split_gap = max([split_gap] + gaps)
        scale = max(float(np.abs(leaf).max()), 1e-30)
        leaf_gap = max(leaf_gap, float(np.abs(np.asarray(leaf_p, np.float64) - leaf).max()) / scale)
        for lvl_p, lvl_r in zip(ssr_p, ssr):
            for t, ref in lvl_r.items():
                got = np.asarray(lvl_p[t], np.float64)
                ssr_gap = max(ssr_gap, float(np.abs(got - ref).max()) / max(ref.sum(), 1e-30))
        r = r - torch.from_numpy(leaf).to(r.device)[idx]
    return {"split_gap": split_gap, "leaf_gap": leaf_gap, "ssr_gap": ssr_gap}
