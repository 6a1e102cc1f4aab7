"""Incremental relational boosting: maintained messages feed RETRAINING.

- :class:`MaintainedEngine` is a :class:`~repro_torch.core.engine.QueryEngine`
  that answers the Booster's node-statistics queries (fused c3 channels,
  leaf-pair counts, polynomial sketches) from a signature-keyed per-edge
  message cache (:class:`~repro_torch.core.sumprod.MessageCache`) over a
  :class:`~repro_torch.incremental.state.DynamicState` kept fresh under
  :class:`TableDelta` streams.  Per query family it hashes each table's
  concrete row mask (node-uniform tables collapse to one broadcast row),
  and re-emits a segment-⊕ only on edges whose child subtree's
  signatures miss the cache — unchanged-subtree messages are reused
  across tree levels, across trees, and across deltas.

- :class:`IncrementalBooster` wraps a :class:`Booster` bound to that
  engine: ``apply(deltas)`` mutates the store and invalidates exactly
  the changed tables' bases/signatures; ``refit(deltas, n_new_trees)``
  warm-starts — it measures residual drift with a cheap sketched SSR
  query, and only when drift exceeds the threshold appends (or, over a
  tree budget, replaces the most recent) trees fitted on the residuals
  of the frozen prefix.

- Split-plan maintenance is delta-driven too: the engine accumulates
  touched slots from its state subscription and serves them through
  :meth:`MaintainedEngine.plan_delta`, so in histogram split mode each
  ``refresh_plans`` re-bins only delta rows against frozen quantile
  edges (``core/hist.py``) instead of re-sorting every table.

The engine is host-orchestrated (``jittable = False``): a cache key is a
blake2b digest of a keep mask's bytes, the JAX package's signature, so
the cache hits — and ``QueryCounter``'s queries and edges — are the
reference's.  The masks live on the query device: a mask whose K rows
are all equal is found so there and only its first row is copied to the
host; ``signature_s`` adds up the host seconds the signatures take.
Every real segment-⊕ emission (the segment-⊕ kernel on CUDA) bumps
``QueryCounter.edges`` (``analytic_edges = False``).

Under the data mesh active when the engine is built, its query bases are
this rank's row blocks of the capacity slots, each query cuts its keep
masks to them, and the grouped outputs are replicated.  The signatures
stay digests of the WHOLE keep masks, the same bytes on every rank, so
every rank hits and misses the message cache as one process does — and
so runs the same collectives in the same order.  The feature matrices,
which the trainer builds its masks and split plans from, stay whole.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.engine import QueryEngine
from ..core.schema import Schema
from ..core.semiring import Arithmetic, PolyFreq
from ..core.sketch import TableHashes, monomial_coeff, monomial_freq
from ..core.sumprod import MessageCache, QueryCounter, SumProd
from ..core.trainer import BoostConfig, Booster, FitTrace
from ..core.tree import TreeArrays
from ..distributed import spmd
from ..obs import get_registry, span
from .deltas import TableDelta, assign_ids
from .state import DynamicState, TableChange


class MaintainedEngine(QueryEngine):
    """Grouped boosting queries answered from maintained messages, on the
    state's device."""

    jittable = False          # signatures hash concrete mask bytes
    analytic_edges = False    # every real emission is counted here

    def __init__(self, state: DynamicState,
                 counter: Optional[QueryCounter] = None,
                 max_cache_per_edge: int = 64):
        self.state = state
        self.counter = counter
        self.mesh = spmd.current_data_mesh()
        self.cache = MessageCache(max_per_edge=max_cache_per_edge)
        self.signature_s = 0.0                   # host seconds of mask signatures
        self._version: Dict[str, int] = {n: 0 for n in state.tables}
        self._stale = set(state.tables)
        # slots whose feature values (or liveness) changed since the last
        # plan_delta() consumption — the o(n) feed for hist-plan rebinning
        self._plan_dirty: Dict[str, List[np.ndarray]] = {}
        # every state.apply — whoever issues it — flows through notify,
        # so a shared DynamicState can never leave this engine stale
        state.subscribe(self.notify)
        # maintained projection dictionaries (the schema's static w_ids,
        # made append-only so sketch hashes stay stable under churn)
        self._proj: Dict[str, Dict[tuple, int]] = {n: {} for n in state.tables}
        self._w_ids: Dict[str, np.ndarray] = {}

    # ---------------------------------------------------------------- bind --
    def bind(self, booster) -> None:
        self.booster = booster
        schema: Schema = booster.schema
        self.schema = schema
        self.dev = schema.device
        if self.counter is None:
            self.counter = booster.counter
        self.sp = SumProd(schema, counter=self.counter)
        self.c3 = booster.c3
        self.sem = booster.sem
        self.hashes: TableHashes = booster.hashes
        self._ar = Arithmetic()
        self._owned = {
            t.name: [c for c in t.columns if schema.owner[c] == t.name]
            for t in schema.tables
        }
        for name, dt in self.state.tables.items():
            self._w_ids[name] = np.zeros((dt.capacity,), np.int64)
            self._assign_proj(name, dt.live_slots())
        self._live: Dict[str, torch.Tensor] = {}
        self._featmat: Dict[str, torch.Tensor] = {}
        self._c3_base: Dict[str, torch.Tensor] = {}
        self._cnt_base: Dict[str, torch.Tensor] = {}
        self._sk_base: Dict[str, torch.Tensor] = {}
        self._sk_label: Dict[str, torch.Tensor] = {}
        self.refresh()

    # -------------------------------------------------------------- deltas --
    def _assign_proj(self, table: str, slots: np.ndarray):
        """Append-only projection ids for ``slots`` (changed/inserted
        rows): an unseen projection tuple gets the next id — existing
        rows keep theirs, so their sketch monomials (and any cached
        message built from them) stay valid."""
        dt = self.state.tables[table]
        ids = self._w_ids[table]
        if len(ids) < dt.capacity:                     # capacity grew
            ids = np.concatenate(
                [ids, np.zeros((dt.capacity - len(ids),), np.int64)]
            )
            self._w_ids[table] = ids
        owned = self._owned.get(table)
        if not owned or not len(slots):
            return
        slots = np.asarray(slots, np.int64)
        ids[slots] = assign_ids(self._proj[table], [dt.columns[c][slots] for c in owned])

    def notify(self, changes: Sequence[TableChange]):
        """Invalidate per-table bases/signatures for applied deltas
        (subscribed to ``DynamicState.apply``).  Bumping ``_version`` is
        what retires cached messages: any edge whose child subtree
        contains the table can no longer hit."""
        for ch in changes:
            if len(ch.changed) or len(ch.deleted) or ch.grew:
                self._version[ch.table] += 1
                self._stale.add(ch.table)
                touched = np.concatenate([ch.changed, ch.deleted])
                if len(touched):
                    self._plan_dirty.setdefault(ch.table, []).append(touched)
                # pre-bind deltas need no projection upkeep: bind()
                # assigns ids for every live slot from scratch
                if hasattr(self, "_owned"):
                    self._assign_proj(ch.table, ch.changed)

    def refresh(self):
        """Rebuild the query bases of stale tables (no-op when clean).
        Holds the state lock: the rebuild reads live bits / feature
        columns that a concurrent ``state.apply`` mutates in place, and
        a torn base would poison the signature-keyed message cache."""
        if not self._stale:
            return
        with self.state.lock, span("engine.refresh", tables=len(self._stale)):
            for name in sorted(self._stale):
                self._rebuild(name)
            self._stale.clear()

    def _rebuild(self, name: str):
        schema, dt, dev = self.schema, self.state.tables[name], self.dev
        cap = dt.capacity
        live_np = dt.live.copy()
        live = torch.from_numpy(live_np).to(dev)
        self._live[name] = live
        cols = schema.feat_cols[name]
        if cols:
            fm = np.stack(
                [dt.columns[c][:cap].astype(np.float32) for c in cols], axis=1
            )
        else:
            fm = np.zeros((cap, 0), np.float32)
        self._featmat[name] = torch.from_numpy(fm).to(dev)
        ones = live.to(torch.float32)
        self._cnt_base[name] = ones
        lbl = None
        if name == schema.label_table:
            lbl_np = dt.columns[schema.label_column][:cap].astype(np.float32)
            lbl = torch.from_numpy(np.where(live_np, lbl_np, np.float32(0.0))).to(dev)
            self._c3_base[name] = torch.stack([ones, lbl, torch.square(lbl)], dim=-1)
        else:
            self._c3_base[name] = self.c3.mask(self.c3.ones((cap,), device=dev), live)
        h = self.hashes.hashes[name]
        w = torch.from_numpy(self._w_ids[name][:cap]).to(dev)
        mono = monomial_freq if isinstance(self.sem, PolyFreq) else monomial_coeff
        m = self.sem.mask(mono(self.sem, h.sign(w), h.bucket(w)), live)
        self._sk_base[name] = m
        self._sk_label[name] = self.sem.scale(m, lbl) if lbl is not None else m
        for base in (self._cnt_base, self._c3_base, self._sk_base, self._sk_label):
            base[name] = spmd.shard_factor(base[name], self.mesh)

    # ------------------------------------------------------------- queries --
    def _combine(self, name: str, mask, extra):
        """Canonical (K, capacity) keep mask: node masks ∧ optional leaf
        mask ∧ liveness (dead slots' garbage feature bits must not leak
        into signatures)."""
        m = mask & self._live[name][None, :]
        if extra is not None:
            m = m & extra[None, :]
        return m

    def _signature(self, keep: torch.Tensor) -> Tuple[torch.Tensor, int, bytes]:
        """(rows, row count, digest) of one (K, n) keep mask: the mask, or
        its first row when all K rows are equal, and the blake2b digest
        of those rows' bytes on the host."""
        t0 = time.perf_counter()
        K = keep.shape[0]
        uniform = K == 1 or bool((keep == keep[:1]).all())
        rows = keep[:1] if uniform else keep
        digest = hashlib.blake2b(rows.cpu().numpy().tobytes(), digest_size=12).digest()
        self.signature_s += time.perf_counter() - t0
        return rows, rows.shape[0], digest

    def _grouped(self, kinds, bases, sem, table, keeps):
        """One grouped query family: per-table signatures → memoized
        message pass → root combine.  Node-uniform tables collapse to a
        single broadcast row, making their signatures (and cached
        messages) independent of the level's node count K.  ``kinds``:
        base-identity tag per table (str applies to every table)."""
        with self.state.lock:
            jt = self.state.jt(table)
        K = next(iter(keeps.values())).shape[0]
        factors, sigs = {}, {}
        with span("engine.grouped", table=table,
                  kind=kinds if isinstance(kinds, str) else "sk"), \
                spmd.use_data_mesh(self.mesh):
            for name, keep in keeps.items():
                rows, n_rows, digest = self._signature(keep)
                kind = kinds if isinstance(kinds, str) else kinds[name]
                sigs[name] = (kind, self._version[name], n_rows, digest)
                rows = spmd.shard_rows(rows, self.mesh, row_axis=-1, dtype=sem.dtype)
                factors[name] = sem.mask(bases[name][None], rows)
            msgs = self.sp.messages_memo(sem, factors, jt, sigs, self.cache)
            out = self.sp.node_factor(sem, factors, jt, jt.root, msgs)
            out = spmd.replicate(out, self.mesh, row_axis=1,
                                 rows=self.state.capacity(table))
        if out.shape[0] != K:
            out = out.expand((K,) + tuple(out.shape[1:]))
        return out

    def grouped_c3(self, table, masks, extra=None):
        self.refresh()
        keeps = {
            tn: self._combine(tn, masks[tn],
                              None if extra is None else extra[tn])
            for tn in masks
        }
        return self._grouped("c3", self._c3_base, self.c3, table, keeps)

    def grouped_count_pair(self, table, masks, extra_a, extra_b):
        self.refresh()
        keeps = {
            tn: self._combine(tn, masks[tn] & extra_a[tn][None, :],
                              extra_b[tn])
            for tn in masks
        }
        return self._grouped("cnt", self._cnt_base, self._ar, table, keeps)

    def grouped_sketch(self, table, masks, extra=None, labeled=False):
        self.refresh()
        keeps = {
            tn: self._combine(tn, masks[tn],
                              None if extra is None else extra[tn])
            for tn in masks
        }
        bases = self._sk_label if labeled else self._sk_base
        # the labeled/unlabeled bases differ only at the label table —
        # sharing the kind tag everywhere else lets their subtree
        # messages interchange
        kinds = {tn: (("skl" if labeled else "sku")
                      if tn == self.schema.label_table else "sk")
                 for tn in keeps}
        return self._grouped(kinds, bases, self.sem, table, keeps)

    # -------------------------------------------------------- data surface --
    def n_rows(self, table):
        return self.state.capacity(table)

    def mask_featmat(self, table):
        self.refresh()
        return self._featmat[table]

    def plan_featmats(self):
        return {name: self.plan_featmat(name) for name in self.state.tables}

    def plan_featmat(self, table):
        """The capacity-shaped feature matrix, dead slots at +inf (they
        never become thresholds)."""
        self.refresh()
        live = self._live[table][:, None]
        return torch.where(live, self._featmat[table], torch.inf)

    def plan_delta(self):
        """Slots touched since the last consumption, with their CURRENT
        feature values straight from the dynamic store (multiple deltas
        to one slot collapse; deleted slots read +inf) — O(|delta|·d_t)
        host work, never a full-table scan."""
        with self.state.lock:
            dirty, self._plan_dirty = self._plan_dirty, {}
            out = {}
            for name, chunks in dirty.items():
                slots = np.unique(np.concatenate(chunks))
                out[name] = (slots, self.state.feature_rows(name, slots))
            return out


@dataclasses.dataclass
class RefitReport:
    """What one :meth:`IncrementalBooster.refit` call did and cost."""

    refitted: bool
    drift: float                 # relative residual (MSE) growth since last fit
    mse_before: float
    mse_after: float
    n_new: int                   # trees fitted this call
    n_trees: int                 # ensemble size after the call
    queries: int                 # SumProd queries this call
    edges: int                   # real segment-⊕ emissions this call
    cache_hit_rate: float        # message-cache hit rate (lifetime)


class IncrementalBooster:
    """Delta-driven warm-start retraining on maintained messages.

    ``hashes``: the sketch hash constants, as ``Booster`` takes them
    (default: drawn from ``cfg.seed``)."""

    def __init__(self, schema: Schema, cfg: BoostConfig,
                 hashes: Optional[TableHashes] = None,
                 slack: float = 0.25,
                 counter: Optional[QueryCounter] = None,
                 max_cache_per_edge: int = 64):
        self.schema = schema
        self.cfg = cfg
        self.state = DynamicState(schema, slack=slack)
        self.engine = MaintainedEngine(self.state, counter=counter,
                                       max_cache_per_edge=max_cache_per_edge)
        self.booster = Booster(schema, cfg, hashes=hashes, engine=self.engine)
        # one counter for everything: analytic query counts from the
        # trainer, real edge emissions from the engine
        self.counter = self.engine.counter
        self.booster.counter = self.counter
        self.trees: List[TreeArrays] = []
        self.trace = FitTrace()
        self._mse_ref: Optional[float] = None
        # perf_counter instant of the oldest delta the model has not yet
        # been (re)evaluated against: the training-side freshness lag
        self._stale_since: Optional[float] = None

    # -------------------------------------------------------------- deltas --
    def apply(self, deltas: Sequence[TableDelta]) -> int:
        """Mutate the store; the engine invalidates via its state
        subscription, and bases/plans refresh lazily at next query."""
        if isinstance(deltas, TableDelta):
            deltas = [deltas]
        with span("retrain.apply", n_deltas=len(deltas)):
            self.state.apply(deltas)
        if self._stale_since is None:
            self._stale_since = time.perf_counter()
        return self.state.data_version

    def staleness_s(self, root: Optional[str] = None) -> float:
        """Seconds the model has been behind applied deltas (0.0 once a
        fit or drift check consumed them).  ``root`` is accepted for the
        serving batcher's ``MaintainedScorer`` surface and ignored: model
        freshness here is global."""
        if self._stale_since is None:
            return 0.0
        return max(0.0, time.perf_counter() - self._stale_since)

    def _mark_fresh(self) -> None:
        """The model was re-evaluated against every applied delta: record
        the consumed lag and reset the staleness clock."""
        if self._stale_since is not None:
            reg = get_registry()
            reg.histogram("retrain.delta_lag_s").observe(
                time.perf_counter() - self._stale_since)
            reg.gauge("retrain.staleness_s").set(0.0)
            self._stale_since = None

    def live_rows(self, table: str) -> np.ndarray:
        return self.state.live_rows(table)

    def effective_schema(self) -> Schema:
        return self.state.effective_schema()

    def _refresh(self) -> None:
        """Bases, then split plans, against the store as it stands."""
        self.engine.refresh()
        self.booster.refresh_plans(self.engine.plan_delta())

    # ----------------------------------------------------------- residuals --
    def _leaf_state(self):
        per_tree = [self.booster._leaf_masks(t) for t in self.trees]
        dev = self.schema.device
        prev_masks = {
            t.name: torch.cat([pm[t.name] for pm in per_tree])
            for t in self.schema.tables
        } if per_tree else {}
        prev_vals = (torch.cat([t.leaf for t in self.trees]) if self.trees
                     else torch.zeros((0,), dtype=torch.float32, device=dev))
        return prev_masks, prev_vals

    def ensemble_mse(self) -> float:
        """Mean squared residual of the CURRENT ensemble over the live
        join — one sketched-SSR query family per frozen leaf, all served
        from the message cache (repeat calls on unchanged data emit no
        edges).  Sketched ⇒ (1±ε)-accurate, the paper's Thm 3.4
        guarantee; used as the refit drift signal."""
        self.engine.refresh()
        lbl = self.schema.label_table
        dev = self.schema.device
        masks = {
            t.name: torch.ones((1, self.state.capacity(t.name)), dtype=torch.bool, device=dev)
            for t in self.schema.tables
        }
        eng = self.engine
        c3 = eng.grouped_c3(lbl, masks)                    # (1, cap, 3)
        n = float(torch.sum(c3[..., 0]))
        uy = float(torch.sum(c3[..., 2]))
        if not self.trees:
            return uy / max(n, 1.0)
        sem = self.booster.sem
        resid = eng.grouped_sketch(lbl, masks, labeled=True)
        prev_masks, prev_vals = self._leaf_state()
        for a in range(int(prev_vals.shape[0])):
            extra = {tn: prev_masks[tn][a] for tn in prev_masks}
            s = eng.grouped_sketch(lbl, masks, extra=extra)
            resid = resid - sem.scale(s, prev_vals[a])
        ssr = float(torch.sum(sem.norm_sq(resid)))
        return max(ssr, 0.0) / max(n, 1.0)

    # ------------------------------------------------------------- fitting --
    def fit(self) -> Tuple[List[TreeArrays], FitTrace]:
        """From-scratch fit through the maintained engine."""
        self._refresh()
        self.trees, self.trace = self.booster.boost([], self.cfg.n_trees)
        self._mse_ref = self.ensemble_mse()
        self._mark_fresh()
        return self.trees, self.trace

    def refit(
        self,
        deltas: Optional[Sequence[TableDelta]] = None,
        n_new_trees: int = 1,
        drift_threshold: float = 0.0,
        max_trees: Optional[int] = None,
    ) -> RefitReport:
        """Apply ``deltas`` (if any) and warm-start on the result.

        Residual drift = relative MSE growth of the current ensemble on
        the live data since the last (re)fit.  At or below
        ``drift_threshold`` the model is left alone (the maintained
        aggregates absorbed the delta); above it, ``n_new_trees`` trees
        are fitted on the frozen ensemble's residuals.  With a
        ``max_trees`` budget, the most recent trees are dropped first to
        make room — they encode the finest residual structure, which the
        delta invalidated."""
        reg = get_registry()
        t0 = time.perf_counter()
        if deltas is not None:
            self.apply(deltas)
        self._refresh()
        c = self.counter
        q0, e0 = c.count, c.edges
        with span("retrain.drift_check"):
            mse0 = self.ensemble_mse()
        # the drift check evaluated the ensemble on the post-delta data:
        # whatever its verdict, the model is no longer behind the store
        self._mark_fresh()
        drift = (float("inf") if self._mse_ref is None
                 else (mse0 - self._mse_ref) / max(self._mse_ref, 1e-12))
        if self.trees and drift <= drift_threshold:
            reg.counter("retrain.kept").inc()
            return RefitReport(
                refitted=False, drift=drift, mse_before=mse0, mse_after=mse0,
                n_new=0, n_trees=len(self.trees),
                queries=c.count - q0, edges=c.edges - e0,
                cache_hit_rate=self.engine.cache.hit_rate,
            )
        if max_trees is not None:
            keep = max(0, max_trees - n_new_trees)
            self.trees = self.trees[:keep]
        with span("retrain.refit", n_new=n_new_trees, drift=round(drift, 4)
                  if drift != float("inf") else None):
            self.trees, self.trace = self.booster.boost(self.trees, n_new_trees)
        mse1 = self.ensemble_mse()
        self._mse_ref = mse1
        reg.counter("retrain.refits").inc()
        reg.histogram("retrain.refit_ms").observe((time.perf_counter() - t0) * 1e3)
        reg.histogram("retrain.refit_edges").observe(c.edges - e0)
        return RefitReport(
            refitted=True, drift=drift, mse_before=mse0, mse_after=mse1,
            n_new=n_new_trees, n_trees=len(self.trees),
            queries=c.count - q0, edges=c.edges - e0,
            cache_hit_rate=self.engine.cache.hit_rate,
        )
