"""Relational greedy boosted regression trees (paper Algorithms 1–3).

- Trees grow level-by-level in BFS order (paper §2.1); each level's split
  statistics come from SumProd queries *grouped by* every table T_i,
  batched over the level's nodes.
- Node statistics (n, Σy, Σy²) fuse into one Channels(3) query.
- Boosted residuals (paper §2.2):
    Σ r_x       — exact, O(mL) count queries per (node, table),
    Σ r_x²      — EXACT mode: O(m²L²) pair queries per (node, table),
                  SKETCH mode: O(mL) polynomial-semiring queries
                  (paper §3, Thm 3.1) with ‖·‖² via Parseval.
- Split ranking reduces to argmax(S_L²/n_L + S_R²/n_R) over *exact*
  sums, so exact and sketched training select identical splits.  The
  SSR values (what the sketch accelerates) are per-node losses used for
  reporting; tests validate their (1±ε) accuracy per grouping table.

SumProd query and edge counts are accounted *analytically* per level.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import fence, get_registry, span
from .engine import DirectEngine, QueryEngine
from .hist import HIST_ROUTES, build_hist_plans, refresh_hist_plans
from .schema import Schema
from .semiring import Channels, PolyCoeff, PolyFreq
from .sketch import TableHashes
from .splits import SplitResult, best_split_for_table, build_split_plans, merge_table_results
from .sumprod import QueryCounter, SumProd
from .tree import TreeArrays, descend_masks_level, leaf_masks, root_masks


@dataclasses.dataclass(frozen=True)
class BoostConfig:
    n_trees: int = 5
    depth: int = 3
    lr: float = 1.0                  # shrinkage (paper: 1.0)
    mode: str = "exact"              # "exact" (Alg 2) | "sketch" (Alg 3)
    sketch_k: int = 64               # k = O((2+3^τ)/(ε²δ)), power of two
    sketch_domain: str = "freq"      # "freq" (beyond-paper) | "coeff" (paper; polymul ⊗)
    min_gain: float = 1e-7
    ssr_mode: str = "per_table"      # "per_table" (faithful) | "once" | "off"
    split_mode: str = "exact"        # "exact" (paper) | "hist" (quantile bins)
    hist_bins: int = 256             # B: quantile bins per feature (hist mode)
    hist_edge_tol: float = 0.25      # re-quantize a table's bin edges once this
    #                                  fraction of its rows re-binned (0 = always)
    hist_route: str = "auto"         # histogram accumulation: "auto" |
    #                                  "gather" | "scatter" | "kernel" (segment-⊕)
    seed: int = 0


@dataclasses.dataclass
class FitTrace:
    """Everything tests/benchmarks need to validate the paper's claims."""

    queries: int = 0
    node_ssr: List[Dict[str, torch.Tensor]] = dataclasses.field(default_factory=list)
    node_counts: List[torch.Tensor] = dataclasses.field(default_factory=list)


class Booster:
    """Trains boosted regression trees directly on a relational schema.

    ``hashes``: sketch hash constants; by default drawn from
    ``np.random.default_rng(cfg.seed)``.
    """

    def __init__(self, schema: Schema, cfg: BoostConfig,
                 hashes: Optional[TableHashes] = None,
                 engine: Optional[QueryEngine] = None):
        if cfg.split_mode not in ("exact", "hist"):
            raise ValueError(f"split_mode {cfg.split_mode!r}")
        if cfg.hist_route not in HIST_ROUTES:
            raise ValueError(f"hist_route {cfg.hist_route!r}")
        if cfg.mode not in ("exact", "sketch"):
            raise ValueError(f"mode {cfg.mode!r}")
        self.schema = schema
        self.cfg = cfg
        self.counter = QueryCounter()
        self.sp = SumProd(schema)            # counting done analytically below
        self.hashes = (hashes if hashes is not None else
                       TableHashes.make(np.random.default_rng(cfg.seed), schema, cfg.sketch_k))
        self.sem = (PolyFreq(cfg.sketch_k) if cfg.sketch_domain == "freq"
                    else PolyCoeff(cfg.sketch_k))
        self.c3 = Channels(3)
        self.engine = engine if engine is not None else DirectEngine()
        self.engine.bind(self)
        self.plans = self._build_plans()

    def _build_plans(self):
        featmats = self.engine.plan_featmats()
        if self.cfg.split_mode == "hist":
            return build_hist_plans(self.schema, featmats=featmats,
                                    n_bins=self.cfg.hist_bins, route=self.cfg.hist_route)
        return build_split_plans(self.schema, featmats=featmats)

    def refresh_plans(self, dirty: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None):
        """Refresh split plans after the engine's feature matrices changed.
        ``dirty`` (``{table: (rows, new feature rows)}``) names the rows
        that changed: hist mode re-bins only those rows against frozen
        quantile edges (re-quantizing a table's edges only past
        ``cfg.hist_edge_tol`` drift).  Exact mode, or no ``dirty``,
        rebuilds every plan."""
        t0 = time.perf_counter()
        if self.cfg.split_mode == "hist" and dirty is not None:
            with span("plan.refresh", mode="hist", tables=len(dirty),
                      rows=sum(len(r) for r, _ in dirty.values())):
                self.plans = refresh_hist_plans(
                    self.plans, dirty, n_rows_fn=self.engine.n_rows,
                    featmat_fn=self._plan_featmat, n_bins=self.cfg.hist_bins,
                    edge_tol=self.cfg.hist_edge_tol)
        else:
            with span("plan.refresh", mode=self.cfg.split_mode, full_rebuild=True):
                self.plans = self._build_plans()
        get_registry().histogram("train.plan_refresh_ms").observe(
            (time.perf_counter() - t0) * 1e3)

    def _plan_featmat(self, table: str) -> torch.Tensor:
        featmats = self.engine.plan_featmats()
        return featmats[table] if featmats and table in featmats else self.schema.featmat[table]

    # ------------------------------------------------------ residual stats --
    def _table_stats(self, table, masks, prev_masks, prev_vals, want_ssr: bool):
        """(n, sum_r, node_ssr) per (node, row-of-table) at one tree level."""
        eng = self.engine
        base = eng.grouped_c3(table, masks)            # (K, n_t, 3)
        n, sy, uy = base[..., 0], base[..., 1], base[..., 2]
        M = prev_vals.shape[0]
        if M == 0:
            return n, sy, (torch.sum(uy, dim=1) if want_ssr else None)

        leaf = lambda a: {tn: prev_masks[tn][a] for tn in prev_masks}
        sum_r, cross = sy, torch.zeros_like(sy)
        for a in range(M):
            st = eng.grouped_c3(table, masks, extra=leaf(a))
            d = prev_vals[a]
            sum_r, cross = sum_r - d * st[..., 0], cross + d * st[..., 1]
        if not want_ssr:
            return n, sum_r, None

        if self.cfg.mode == "exact":
            # pair term Σ_{a,b} d_a d_b |J^{(a)} ∩ J^{(b)} ∩ J^{(v)} ∩ ρ⋈·|
            pair = torch.zeros_like(sy)
            for i in range(M * M):
                a, b = i // M, i % M
                cnt = eng.grouped_count_pair(table, masks, leaf(a), leaf(b))
                pair = pair + prev_vals[a] * prev_vals[b] * cnt
            ssr_rho = uy - 2.0 * cross + pair
        else:
            resid = eng.grouped_sketch(table, masks, labeled=True)   # (K, n_t, kc)
            for a in range(M):
                s = eng.grouped_sketch(table, masks, extra=leaf(a))
                resid = resid - self.sem.scale(s, prev_vals[a])
            ssr_rho = self.sem.norm_sq(resid)
        return n, sum_r, torch.sum(ssr_rho, dim=1)

    # --------------------------------------------------------- level step --
    def _level_step(self, masks, prev_masks, prev_vals, node_mean):
        """One BFS level: queries → split choice → mask descent."""
        cfg = self.cfg
        results, ssr_out = [], {}
        node_n = None
        for i, tn in enumerate(self.plans):
            want_ssr = cfg.ssr_mode == "per_table" or (cfg.ssr_mode == "once" and i == 0)
            with span("boost.stats", table=tn):
                n, s, ssr = self._table_stats(tn, masks, prev_masks, prev_vals, want_ssr)
            if i == 0:
                node_n = torch.sum(n, dim=1)
            if ssr is not None:
                ssr_out[tn] = ssr
            with span("boost.sweep", table=tn):
                results.append(fence(best_split_for_table(self.plans[tn], n, s)))
        best: SplitResult = merge_table_results(results)

        valid = torch.isfinite(best.score) & (best.score > cfg.min_gain)
        feat = torch.where(valid, best.feature, -1).to(torch.int32)
        thr = torch.where(valid, best.threshold, float("inf")).to(torch.float32)
        lm = torch.where(valid, best.left_sum / torch.clamp(best.left_cnt, min=1e-9), node_mean)
        rm = torch.where(valid, best.right_sum / torch.clamp(best.right_cnt, min=1e-9),
                         node_mean)
        new_mean = torch.stack([lm, rm], dim=1).reshape(-1)
        new_masks = {
            tn: descend_masks_level(self.schema, tn, feat, thr, masks[tn],
                                    featmat=self.engine.mask_featmat(tn))
            for tn in masks
        }
        return feat, thr, new_mean, new_masks, ssr_out, node_n

    def _leaf_masks(self, tree: TreeArrays):
        return {t.name: leaf_masks(self.schema, t.name, tree,
                                   featmat=self.engine.mask_featmat(t.name))
                for t in self.schema.tables}

    # -------------------------------------------------- query accounting --
    def _count_level_queries(self, M: int) -> int:
        """Analytic SumProd counts per level (validates Thms 2.4/3.1)."""
        tau = len(self.plans)
        per_table = 1 + M                                  # c3 + per-leaf stats
        if self.cfg.ssr_mode != "off":
            if self.cfg.mode == "exact":
                per_table += M * M                         # leaf-pair counts
            else:
                per_table += 1 + M                         # Y' + per-leaf sketches
        return per_table * tau

    def _count_level_edges(self, M: int) -> int:
        """Analytic segment-⊕ emissions per level: every query family
        re-emits each join-tree edge (τ_all − 1 for an acyclic schema)."""
        return self._count_level_queries(M) * max(self.schema.n_tables - 1, 0)

    # -------------------------------------------------------------- fitting --
    def _fit_tree(self, prev_trees: List[TreeArrays], trace: FitTrace) -> TreeArrays:
        cfg, schema, dev = self.cfg, self.schema, self.schema.device
        if prev_trees:
            per_tree = [self._leaf_masks(pt) for pt in prev_trees]
            prev_masks = {t.name: torch.cat([pm[t.name] for pm in per_tree])
                          for t in schema.tables}
            prev_vals = torch.cat([pt.leaf for pt in prev_trees])
        else:
            prev_masks = {t.name: torch.zeros((0, self.engine.n_rows(t.name)),
                                              dtype=torch.bool, device=dev)
                          for t in schema.tables}
            prev_vals = torch.zeros((0,), dtype=torch.float32, device=dev)

        tree = TreeArrays.empty(cfg.depth, dev)
        masks = {t.name: root_masks(schema, t.name, n_rows=self.engine.n_rows(t.name))
                 for t in schema.tables}
        node_mean = torch.zeros((1,), dtype=torch.float32, device=dev)
        M = int(prev_vals.shape[0])

        for level in range(cfg.depth):
            t0 = time.perf_counter()
            with span("boost.level", level=level, prev_leaves=M):
                feat, thr, node_mean, masks, ssr, node_n = self._level_step(
                    masks, prev_masks, prev_vals, node_mean)
                fence(None)
            get_registry().histogram("train.level_ms").observe(
                (time.perf_counter() - t0) * 1e3)
            start = 2 ** level - 1
            tree.feat[start:start + feat.shape[0]] = feat
            tree.thr[start:start + thr.shape[0]] = thr
            self.counter.bump(self._count_level_queries(M))
            if self.engine.analytic_edges:
                self.counter.bump_edges(self._count_level_edges(M))
            if ssr:
                trace.node_ssr.append(ssr)
                trace.node_counts.append(node_n)

        return TreeArrays(feat=tree.feat, thr=tree.thr, leaf=cfg.lr * node_mean)

    def boost(self, trees: List[TreeArrays], n_trees: int,
              trace: Optional[FitTrace] = None) -> Tuple[List[TreeArrays], FitTrace]:
        """Warm start: append ``n_trees`` new trees fitted on the residuals
        of ``trees`` (which are left untouched).  The returned trace
        reports THIS call's query cost (the lifetime total lives on
        ``self.counter``)."""
        trace = trace if trace is not None else FitTrace()
        reg = get_registry()
        q0 = self.counter.count
        trees = list(trees)
        for _ in range(n_trees):
            t0 = time.perf_counter()
            rq, re = self.counter.count, self.counter.edges
            with span("boost.round", round=len(trees), mode=self.cfg.mode):
                trees.append(self._fit_tree(trees, trace))
            reg.histogram("train.round_ms").observe((time.perf_counter() - t0) * 1e3)
            reg.histogram("train.round_queries").observe(self.counter.count - rq)
            reg.histogram("train.round_edges").observe(self.counter.edges - re)
            reg.counter("train.rounds").inc()
        trace.queries = self.counter.count - q0
        return trees, trace

    def fit(self) -> Tuple[List[TreeArrays], FitTrace]:
        return self.boost([], self.cfg.n_trees)

    # ------------------------------------------------------------ serving --
    def predict_grouped(self, trees: List[TreeArrays], group_by: str):
        """Per-row-of-`group_by` (Σ ŷ(x), count) over x ∈ ρ⋈J through the
        compiled one-pass scorer (serving/compile.py)."""
        from ..serving import compile_ensemble, score_grouped

        # the held tuple keeps strong refs to the trees, so the id-based
        # key cannot be reused by a reallocated ensemble
        key = tuple(id(t) for t in trees)
        cached = getattr(self, "_compiled", None)
        if cached is None or cached[0] != key:
            ens = compile_ensemble(self.schema, trees, counter=self.counter)
            self._compiled = cached = (key, tuple(trees), ens)
        return score_grouped(cached[2], group_by)
