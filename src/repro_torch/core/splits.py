"""Split search: threshold sweep + MSE scoring (paper §2.1 / §2.2).

Given the grouped-by-``T_i`` per-row statistics at a batch of tree nodes
(counts n_ρ, residual sums r_ρ), score every candidate ``(feature j of
T_i, threshold α)`` with the paper's closed form

    MSE(v,j,α) ∝ −( S_L²/n_L + S_R²/n_R )          (lower is better)

where S = Σ residuals on a side.  Candidate thresholds are the distinct
values of the column (sort orders precomputed once per schema), or, in
histogram split mode, its quantile cuts (hist.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .schema import Schema

NEG = float("-inf")


def _argmax_band(scores: torch.Tensor, dim: int,
                 rtol: float = 1e-5, atol: float = 1e-8) -> torch.Tensor:
    """argmax that treats scores within an ulp-noise band of the max as
    TIED and picks the lowest index, so mathematically tied candidates
    (two joined features inducing the same partition) are chosen the same
    way whatever the evaluation route.  Applied at feature- and
    table-selection granularity; the boundary sweep keeps a plain argmax.
    torch's argmax rejects bool, so the mask is cast to uint8; it returns
    the first maximal index, as jnp's does."""
    m = torch.amax(scores, dim=dim, keepdim=True)
    band = torch.abs(m) * rtol + atol
    return torch.argmax((scores >= m - band).to(torch.uint8), dim=dim)


@dataclasses.dataclass(frozen=True)
class TableSplitPlan:
    """Static per-table artifacts for the sweep."""

    table: str
    order: torch.Tensor        # (d_t, n) argsort per local feature
    sorted_vals: torch.Tensor  # (d_t, n) column values in sorted order
    global_ids: torch.Tensor   # (d_t,) global feature ids


def build_split_plans(schema: Schema,
                      featmats: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, TableSplitPlan]:
    """Static per-table sweep artifacts (stable argsort on the host).
    ``featmats`` overrides the schema's feature matrices (same columns,
    arbitrary row domain)."""
    plans = {}
    for t in schema.tables:
        src = (featmats[t.name] if featmats is not None and t.name in featmats
               else schema.featmat[t.name])
        fm = src.detach().cpu().numpy()               # (n, d_t)
        if fm.shape[1] == 0:
            continue
        order = np.argsort(fm, axis=0, kind="stable").T
        sv = np.take_along_axis(fm, order.T, axis=0).T
        gids = [g for g, (ti, _li) in enumerate(schema.feat_global)
                if schema.tables[ti].name == t.name]
        dev = src.device
        plans[t.name] = TableSplitPlan(
            table=t.name,
            order=torch.from_numpy(np.ascontiguousarray(order)).to(dev),
            sorted_vals=torch.from_numpy(np.ascontiguousarray(sv)).to(dev),
            global_ids=torch.tensor(gids, dtype=torch.int64, device=dev),
        )
    return plans


@dataclasses.dataclass
class SplitResult:
    """Best split per node (all tensors (K,))."""

    score: torch.Tensor       # gain score (higher = better), -inf if none
    feature: torch.Tensor     # global feature id
    threshold: torch.Tensor
    left_sum: torch.Tensor    # Σ residual left
    left_cnt: torch.Tensor
    right_sum: torch.Tensor
    right_cnt: torch.Tensor


def _fields(r: SplitResult):
    return [getattr(r, f.name) for f in dataclasses.fields(SplitResult)]


def score_boundaries(nl, sl, nr, sr, valid, thr_vals):
    """Per-boundary left/right stats ((K, d_t, nb) tensors, ``thr_vals``
    broadcastable to them) → per-(node, feature) best-boundary parts,
    each (K, d_t)."""
    score = torch.where(
        valid,
        torch.square(sl) / torch.clamp(nl, min=1e-9)
        + torch.square(sr) / torch.clamp(nr, min=1e-9),
        NEG,
    )
    p = torch.argmax(score, dim=2, keepdim=True)          # (K, d_t, 1)
    take = lambda a: torch.gather(a, 2, p)[..., 0]
    thr = take(thr_vals.expand(score.shape))
    return take(score), thr, take(sl), take(nl), take(sr), take(nr)


# peak-memory budget for the exact sweep's (K, block, rows) intermediates
_EXACT_BLOCK_ELEMS = 1 << 25


def _exact_scores(plan: TableSplitPlan, n, s, tot_n, tot_s):
    """Exact sweep, batched over the feature axis: a (K, d_t, rows)
    gather + cumsum scores every boundary of every feature at once.
    Very wide×tall tables process the feature axis in blocks so peak
    memory stays bounded; per-feature results are independent, so
    blocking cannot change them."""
    d_t, rows = plan.order.shape
    K = n.shape[0]
    block = max(1, _EXACT_BLOCK_ELEMS // max(K * rows, 1))

    def sweep(order, vals):                          # (block, rows) each
        ns = n[:, order]                             # (K, block, rows)
        ss = s[:, order]
        cln = torch.cumsum(ns, dim=2)                # inclusive: left of boundary p+1
        cls = torch.cumsum(ss, dim=2)
        # boundary after position p: threshold = vals[p+1]; valid iff value changes
        nl, sl = cln[..., :-1], cls[..., :-1]
        nr = tot_n[:, None, None] - nl
        sr = tot_s[:, None, None] - sl
        valid = (vals[:, 1:] > vals[:, :-1])[None] & (nl > 0) & (nr > 0)
        return score_boundaries(nl, sl, nr, sr, valid, vals[None, :, 1:])

    if block >= d_t:
        return sweep(plan.order, plan.sorted_vals)
    parts = [sweep(plan.order[f0:f0 + block], plan.sorted_vals[f0:f0 + block])
             for f0 in range(0, d_t, block)]
    return tuple(torch.cat(ps, dim=1) for ps in zip(*parts))


def _best_feature(plan, scores, thr, sl, nl, sr, nr, tot_n, tot_s) -> SplitResult:
    """Per-(node, feature) best boundaries ((K, d_t)) → the per-node
    winning feature (banded argmax, ties to the lower global feature id)."""
    fbest = _argmax_band(scores, dim=1)[:, None]      # (K, 1)
    pick = lambda a: torch.gather(a, 1, fbest)[:, 0]
    base = torch.square(tot_s) / torch.clamp(tot_n, min=1e-9)
    return SplitResult(
        score=pick(scores) - base,
        feature=plan.global_ids[fbest[:, 0]],
        threshold=pick(thr),
        left_sum=pick(sl),
        left_cnt=pick(nl),
        right_sum=pick(sr),
        right_cnt=pick(nr),
    )


def best_split_for_table(plan, n: torch.Tensor, s: torch.Tensor) -> SplitResult:
    """Sweep all features of one table.  ``n``/``s``: (K, rows) counts
    and residual sums per node per row of the table.  The route follows
    the plan's type: the exact boundary sweep for a
    :class:`TableSplitPlan`, the quantile-histogram sweep (hist.py) for a
    ``TableHistPlan``."""
    from .hist import TableHistPlan, hist_scores

    tot_n = torch.sum(n, dim=1)
    tot_s = torch.sum(s, dim=1)
    if isinstance(plan, TableHistPlan):
        parts = hist_scores(plan, n, s, tot_n, tot_s)
    else:
        parts = _exact_scores(plan, n, s, tot_n, tot_s)
    return _best_feature(plan, *parts, tot_n, tot_s)


def merge_table_results(results) -> SplitResult:
    """argmax across tables (ties — including ulp-level float ties — go
    to the earlier table, i.e. the lower global feature id)."""
    stacked = [torch.stack(xs) for xs in zip(*map(_fields, results))]
    best = _argmax_band(stacked[0], dim=0)[None, :]   # (1, K)
    return SplitResult(*(torch.gather(a, 0, best)[0] for a in stacked))
