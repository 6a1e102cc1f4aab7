"""Quantile-histogram split plans with incrementally maintained bins.

Alternative to the exact sweep in splits.py: instead of cumsumming node
statistics over full per-feature argsort orders and scoring every row
boundary (O(K·d_t·n) per table per level), aggregate the (K, rows)
stats into (K, d_t, B) histograms of B quantile bins and sweep the B
cut boundaries.

Design invariants:

- **Cuts are data values.**  Every bin boundary is an actual column
  value, so the split ``x >= cut → right`` partitions rows exactly along
  a bin boundary: binned (n, Σr) statistics score every candidate cut
  exactly; only the candidate set is quantile-subsampled.  When B ≥
  #distinct values, the cut set equals the exact sweep's candidate set
  and the two routes select identical splits.
- **Non-finite values bin to an explicit INVALID bin** (index
  ``n_bins``): dead capacity slots padded at +inf never shape the
  quantile edges and never become thresholds.  Invalid-bin rows are
  left out of the histogram row lists.
- **The maintained aggregate is the bin map, not the sort**: under row
  changes only the touched rows re-bin against frozen edges
  (:func:`rebin_rows`), and a table's edges re-quantize only when the
  re-binned mass drifts past a tolerance (:func:`refresh_hist_plans`).

Cuts, bins and row lists are numpy, computed exactly as the JAX
package computes them (this module keeps its own copy), so the cuts and
thresholds are bit-identical to the reference's.  The plan keeps its
device arrays on the schema's device.

Histogram accumulation routes (``TableHistPlan.route`` /
``BoostConfig.hist_route``; ``"auto"``, the default, resolves to gather
unless column skew inflates the padded row lists, then to scatter):

- ``"gather"``: each (feature, bin) keeps a padded row-id list ((d_t,
  B, m) with m ≈ n/B, padded with the id n); the (2K, n) stats get one
  zero column at index n, so the padding gathers zeros, and a sum over
  the short axis gives the histogram.
- ``"scatter"`` / ``"kernel"``: one segment-⊕ of the stats keyed by
  ``bins + f·(B+1)`` through ``kernels/segment_sum``: the segment-⊕
  kernel on CUDA tensors, its plain version on CPU tensors.  The key
  column's CSR is built once per plan, with its order taken modulo n,
  so the kernel reads rows of the untiled (n, 2K) stats and the d_t
  tiled copies are never built.  Both names take the same route here;
  ``"scatter"`` stays as a name for parity with the reference, where it
  is the plain segment-sum and ``"kernel"`` its TPU kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.segment_sum import Segments, segment_sum
from .schema import Schema
from .splits import score_boundaries

HIST_DEFAULT_BINS = 256
HIST_ROUTES = ("auto", "gather", "scatter", "kernel")


def quantile_cuts(col: np.ndarray, n_bins: int) -> np.ndarray:
    """≤ ``n_bins − 1`` cut values for one column, drawn from the
    column's own finite values at count-weighted quantile positions.  A
    cut c opens the bin of values ≥ c, so candidate splits sit on real
    data and the minimum value is never a cut.  When the column has ≤
    ``n_bins`` distinct values every one gets its own bin and the cut set
    equals the exact sweep's candidates."""
    col = np.asarray(col)
    finite = col[np.isfinite(col)]
    if finite.size == 0:
        return np.zeros((0,), np.float32)
    d, counts = np.unique(finite, return_counts=True)
    if len(d) <= n_bins:
        return d[1:].astype(np.float32)
    cum = np.cumsum(counts)
    targets = cum[-1] * np.arange(1, n_bins) / n_bins
    idx = np.searchsorted(cum, targets, side="left") + 1
    idx = np.unique(np.clip(idx, 1, len(d) - 1))
    return d[idx].astype(np.float32)


def bin_values(cuts: np.ndarray, x: np.ndarray, n_bins: int) -> np.ndarray:
    """Row→bin map for one feature: ``searchsorted`` right over the real
    cuts (monotone in x), non-finite values to the invalid bin."""
    b = np.searchsorted(cuts, x, side="right").astype(np.int32)
    b[~np.isfinite(x)] = n_bins
    return b


def _padded_bin_rows(bins: np.ndarray, n_bins: int) -> np.ndarray:
    """(d_t, B, m) row-id lists per (feature, bin), padded with the
    out-of-bounds id n.  m is the max valid-bin occupancy, rounded up to
    8; invalid-bin rows are absent."""
    d_t, n = bins.shape
    order = np.argsort(bins, axis=1, kind="stable").astype(np.int32)
    sb = np.take_along_axis(bins, order, axis=1)
    m = 1
    per_f = []
    for f in range(d_t):
        keep = sb[f] < n_bins
        vb, rows = sb[f][keep], order[f][keep]
        start = np.searchsorted(vb, np.arange(n_bins), side="left")
        rank = np.arange(len(vb)) - start[vb]
        per_f.append((vb, rank, rows))
        if len(vb):
            m = max(m, int(rank.max()) + 1)
    m = ((m + 7) // 8) * 8
    out = np.full((d_t, n_bins, m), n, np.int32)
    for f, (vb, rank, rows) in enumerate(per_f):
        out[f, vb, rank] = rows
    return out


@dataclasses.dataclass
class TableHistPlan:
    """Maintainable per-table histogram artifacts.

    Host-side masters (numpy) are the mutable source of truth —
    :func:`rebin_rows` updates them in place — and the device view used
    by the sweep refreshes eagerly on every mutation via :meth:`device`.

    Bin index layout per feature f: valid values take bins
    ``0 … n_cuts[f]`` (boundary j splits bins ≤ j from bins > j at
    threshold ``cuts[f, j]``); non-finite values take the invalid bin
    ``n_bins``, beyond every candidate boundary.
    """

    table: str
    n_bins: int                 # B: valid bins 0..B-1, invalid bin = B
    cuts: np.ndarray            # (d_t, B-1) f32 cut values, +inf padded
    n_cuts: np.ndarray          # (d_t,) int32 real cuts per feature
    bins: np.ndarray            # (d_t, n) int32 row→bin master
    global_ids: torch.Tensor    # (d_t,) global feature ids
    dev: torch.device           # where the sweep's arrays live
    route: str = "auto"         # histogram accumulation (hist_scores)
    rebinned_since_edges: int = 0   # drift meter for edge re-quantization
    _view: Optional[Tuple] = None
    _rows: Optional[torch.Tensor] = None
    _seg: Optional[Segments] = None

    @property
    def n_rows(self) -> int:
        return self.bins.shape[1]

    def device(self):
        """(route, cuts, valid_cut): the resolved accumulation route and
        the sweep's device arrays.  ``"auto"`` resolves here — gather
        while the padded row lists stay within 4× the row count, else the
        segment-⊕ scatter (a value hoarding a large share of a column
        inflates the max bin occupancy m).  The resolved route's own
        artifact (row lists or CSR) is built here too."""
        if self._view is None:
            valid = np.arange(self.n_bins - 1)[None, :] < self.n_cuts[:, None]
            route = self.route
            if route == "auto":
                m = max((int(np.bincount(f, minlength=self.n_bins)[: self.n_bins].max())
                         for f in self.bins if f.size), default=1)
                padded = self.n_bins * (((max(m, 1) + 7) // 8) * 8)
                route = "gather" if padded <= 4 * max(self.n_rows, 1) else "scatter"
            if route == "gather":
                self.gather_rows()
            else:
                self.segments()
            self._view = (route, torch.from_numpy(self.cuts).to(self.dev),
                          torch.from_numpy(valid).to(self.dev))
        return self._view

    def gather_rows(self) -> torch.Tensor:
        """Padded per-(feature, bin) row lists for the gather route
        (int64, padding id n), built on first use."""
        if self._rows is None:
            self._rows = torch.from_numpy(
                _padded_bin_rows(self.bins, self.n_bins).astype(np.int64)).to(self.dev)
        return self._rows

    def segments(self) -> Segments:
        """CSR of the feature-major keys ``bins[f] + f·(B+1)`` for the
        segment-⊕ routes, its order taken modulo n (entry f·n + r names
        row r), built on first use."""
        if self._seg is None:
            d_t, n = self.bins.shape
            nb = self.n_bins + 1                       # + the invalid slot
            ids = self.bins.astype(np.int64) + (np.arange(d_t, dtype=np.int64) * nb)[:, None]
            self._seg = Segments.from_ids(ids.reshape(-1), d_t * nb, self.dev,
                                          row_period=n)
        return self._seg


def _table_plan(name: str, fm: np.ndarray, global_ids, n_bins: int, device,
                route: str = "auto") -> TableHistPlan:
    d_t, n = fm.shape[1], fm.shape[0]
    cuts = np.full((d_t, n_bins - 1), np.inf, np.float32)
    n_cuts = np.zeros((d_t,), np.int32)
    bins = np.empty((d_t, n), np.int32)
    for f in range(d_t):
        c = quantile_cuts(fm[:, f], n_bins)
        n_cuts[f] = len(c)
        cuts[f, : len(c)] = c
        bins[f] = bin_values(c, fm[:, f], n_bins)
    plan = TableHistPlan(
        table=name, n_bins=n_bins, cuts=cuts, n_cuts=n_cuts, bins=bins,
        global_ids=torch.as_tensor(np.asarray(global_ids, np.int64), device=device),
        dev=torch.device(device), route=route,
    )
    plan.device()
    return plan


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_hist_plans(schema: Schema, featmats: Optional[Dict[str, torch.Tensor]] = None,
                     n_bins: int = HIST_DEFAULT_BINS,
                     route: str = "auto") -> Dict[str, TableHistPlan]:
    """Full (re)build, mirroring ``splits.build_split_plans``:
    ``featmats`` overrides the schema's feature matrices (dead slots at
    +inf bin to the invalid slot and stay out of the quantile edges)."""
    plans = {}
    for t in schema.tables:
        src = (featmats[t.name] if featmats is not None and t.name in featmats
               else schema.featmat[t.name])
        fm = _np(src).astype(np.float32, copy=False)
        if fm.shape[1] == 0:
            continue
        gids = [g for g, (ti, _li) in enumerate(schema.feat_global)
                if schema.tables[ti].name == t.name]
        plans[t.name] = _table_plan(t.name, fm, gids, n_bins, schema.device, route=route)
    return plans


def rebin_rows(plan: TableHistPlan, rows: np.ndarray, vals: np.ndarray,
               n_rows: Optional[int] = None) -> None:
    """Re-bin ``rows`` (slot ids) whose feature values became ``vals``
    ((len(rows), d_t), dead rows at +inf) against the plan's FROZEN
    edges, in place; only this table's row lists and CSR re-pack.
    ``n_rows`` extends the row domain (capacity growth); new slots start
    in the invalid bin."""
    rows = np.asarray(rows, np.int64)
    d_t = plan.bins.shape[0]
    need = max(plan.n_rows, int(rows.max()) + 1 if len(rows) else 0, int(n_rows or 0))
    if need > plan.n_rows:
        pad = np.full((d_t, need - plan.n_rows), plan.n_bins, np.int32)
        plan.bins = np.concatenate([plan.bins, pad], axis=1)
    if len(rows):
        vals = np.asarray(vals, np.float32)
        for f in range(d_t):
            plan.bins[f, rows] = bin_values(plan.cuts[f, : plan.n_cuts[f]], vals[:, f],
                                            plan.n_bins)
        plan.rebinned_since_edges += len(rows)
    plan._view = None
    plan._rows = None
    plan._seg = None
    plan.device()


def refresh_hist_plans(plans: Dict[str, TableHistPlan],
                       dirty: Dict[str, Tuple[np.ndarray, np.ndarray]],
                       n_rows_fn: Callable[[str], int],
                       featmat_fn: Callable[[str], np.ndarray],
                       n_bins: int = HIST_DEFAULT_BINS,
                       edge_tol: float = 0.25) -> Dict[str, TableHistPlan]:
    """Row-change-driven plan maintenance: tables absent from ``dirty``
    (``{table: (rows, vals)}``) are reused untouched; dirty tables
    re-bin only the given rows against frozen edges, unless the
    cumulative re-binned mass since the edges were built exceeds
    ``edge_tol`` of the row domain, in which case that table's edges
    re-quantize from its full feature matrix (``edge_tol = 0``
    re-quantizes on any change)."""
    out = dict(plans)
    for name, (rows, vals) in dirty.items():
        plan = plans.get(name)
        if plan is None:                       # feature-less table
            continue
        cap = int(n_rows_fn(name))
        if plan.rebinned_since_edges + len(rows) > edge_tol * max(cap, 1):
            out[name] = _table_plan(name, _np(featmat_fn(name)).astype(np.float32, copy=False),
                                    _np(plan.global_ids), n_bins, plan.dev,
                                    route=plan.route)
        elif len(rows) or cap > plan.n_rows:
            rebin_rows(plan, rows, vals, n_rows=cap)
    return out


def hist_scores(plan: TableHistPlan, n: torch.Tensor, s: torch.Tensor,
                tot_n: torch.Tensor, tot_s: torch.Tensor, route: Optional[str] = None):
    """Histogram sweep for one table: accumulate the (K, rows) node stats
    into (2K, d_t, B) histograms (padded-row-list gather or segment-⊕,
    see the module docstring), then score every cut boundary from B-bin
    cumsums.  ``route`` overrides the plan's resolved route (building the
    route's artifact on demand).  Returns per-(node, feature)
    best-boundary tensors (score, thr, sl, nl, sr, nr), each (K, d_t),
    the same contract as the exact sweep, for ``splits._best_feature``."""
    dev_route, cuts, valid_cut = plan.device()
    d_t = plan.bins.shape[0]
    K = n.shape[0]
    B = plan.n_bins
    if route is None or route == "auto":
        route = dev_route
    stats = torch.cat([n, s], dim=0)                     # (2K, rows)
    if route == "gather":
        padded = torch.cat([stats, stats.new_zeros((2 * K, 1))], dim=1)   # id n reads 0
        g = padded[:, plan.gather_rows()]                # (2K, d_t, B, m)
        hist = torch.sum(g, dim=3)                       # (2K, d_t, B)
    elif route in ("scatter", "kernel"):
        nb = B + 1                                       # + the invalid slot
        h = segment_sum(stats.T.contiguous()[None], plan.segments())   # (1, d_t·nb, 2K)
        hist = h[0].reshape(d_t, nb, 2 * K)[:, :B].permute(2, 0, 1)
    else:
        raise ValueError(f"hist route {route!r}")
    # boundary j (threshold cuts[f, j]) sends bins ≤ j left, > j right;
    # invalid-bin rows sit past every boundary (and carry ⊕-zero stats)
    cum = torch.cumsum(hist, dim=2)[..., : B - 1]        # (2K, d_t, B-1)
    nl, sl = cum[:K], cum[K:]
    nr = tot_n[:, None, None] - nl
    sr = tot_s[:, None, None] - sl
    valid = valid_cut[None] & (nl > 0) & (nr > 0)
    return score_boundaries(nl, sl, nr, sr, valid, cuts[None])
