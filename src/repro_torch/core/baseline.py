"""Materialized-join greedy boosted trees — the paper's comparison baseline.

Standard in-memory gradient boosting on the design matrix X = cols(J):
the oracle the relational Algorithms 1/2 must match split-for-split.
Scoring is the identical argmax(S_L²/n_L + S_R²/n_R) form.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .trainer import BoostConfig
from .tree import TreeArrays


@dataclasses.dataclass
class MaterializedBooster:
    X: torch.Tensor            # (n, d) in global-feature-id order
    y: torch.Tensor            # (n,)
    cfg: BoostConfig

    def __post_init__(self):
        Xn = self.X.detach().cpu().numpy()
        order = np.argsort(Xn, axis=0, kind="stable").T              # (d, n)
        self._order = torch.from_numpy(np.ascontiguousarray(order)).to(self.X.device)
        self._svals = torch.from_numpy(np.ascontiguousarray(
            np.take_along_axis(Xn, order.T, 0).T)).to(self.X.device)

    def _best_split(self, idx, r, K):
        """idx: (n,) node assignment; r: residuals.  Returns per-node best."""
        d = self.X.shape[1]
        onehot = torch.nn.functional.one_hot(idx, K).to(torch.float32)   # (n, K)

        def one_feature(fi):
            o = self._order[fi]
            vals = self._svals[fi]
            oh = onehot[o]                                          # (n, K)
            rs = r[o]
            cn = torch.cumsum(oh, dim=0).T                          # (K, n)
            cs = torch.cumsum(oh * rs[:, None], dim=0).T
            tot_n, tot_s = cn[:, -1], cs[:, -1]
            nl, sl = cn[:, :-1], cs[:, :-1]
            nr, sr = tot_n[:, None] - nl, tot_s[:, None] - sl
            valid = (vals[1:] > vals[:-1])[None] & (nl > 0) & (nr > 0)
            score = torch.where(
                valid,
                torch.square(sl) / torch.clamp(nl, min=1e-9)
                + torch.square(sr) / torch.clamp(nr, min=1e-9),
                float("-inf"),
            )
            p = torch.argmax(score, dim=1, keepdim=True)
            take = lambda a: torch.gather(a, 1, p)[:, 0]
            base = torch.square(tot_s) / torch.clamp(tot_n, min=1e-9)
            return (take(score) - base, vals[1:][p[:, 0]],
                    take(sl), take(nl), take(sr), take(nr))

        res = [torch.stack(xs) for xs in zip(*(one_feature(fi) for fi in range(d)))]
        key = res[0] - 1e-9 * torch.arange(d, dtype=torch.float32,
                                           device=self.X.device)[:, None]
        f = torch.argmax(key, dim=0, keepdim=True)                   # (1, K)
        take = lambda a: torch.gather(a, 0, f)[0]
        return f[0].to(torch.int32), *(take(a) for a in res)

    def fit(self) -> List[TreeArrays]:
        cfg, dev = self.cfg, self.X.device
        trees: List[TreeArrays] = []
        pred = torch.zeros_like(self.y)
        for _ in range(cfg.n_trees):
            r = self.y - pred
            tree = TreeArrays.empty(cfg.depth, dev)
            idx = torch.zeros((self.X.shape[0],), dtype=torch.int64, device=dev)
            node_mean = torch.zeros((1,), dtype=torch.float32, device=dev)
            for level in range(cfg.depth):
                K = 2 ** level
                f, score, thr, sl, nl, sr, nr = self._best_split(idx, r, K)
                valid = torch.isfinite(score) & (score > cfg.min_gain)
                feat = torch.where(valid, f, -1).to(torch.int32)
                th = torch.where(valid, thr, float("inf"))
                tree.feat[K - 1:2 * K - 1] = feat
                tree.thr[K - 1:2 * K - 1] = th
                lm = torch.where(valid, sl / torch.clamp(nl, min=1e-9), node_mean)
                rm = torch.where(valid, sr / torch.clamp(nr, min=1e-9), node_mean)
                node_mean = torch.stack([lm, rm], 1).reshape(-1)
                fv = feat[idx]
                tv = th[idx]
                xv = torch.gather(self.X, 1, fv.clamp(min=0).long()[:, None])[:, 0]
                idx = 2 * idx + ((xv >= tv) & (fv >= 0)).long()
            tree = TreeArrays(feat=tree.feat, thr=tree.thr, leaf=cfg.lr * node_mean)
            trees.append(tree)
            pred = pred + tree.leaf[idx]
        return trees
