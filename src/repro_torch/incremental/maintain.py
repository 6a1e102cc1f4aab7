"""Delta-driven maintenance of compiled ensembles and memoized scores.

:class:`MaintainedScorer` turns the one-shot :class:`CompiledEnsemble`
into a continuously maintainable view (the static/dynamic factorization
of Kara et al.): typed table deltas update (a) the per-table stacked
leaf-mask factors — only the changed rows' masks are re-evaluated
(``stack_table_factor`` on those rows: per-row elementwise work, the
same bits as a full-table evaluation) and scattered in — and (b) the
memoized grouped counts/scores, by re-emitting segment-⊕ messages only
along the changed tables' paths to the root
(:meth:`~repro_torch.core.sumprod.SumProd.refresh_messages`, planned by
``refresh_plan``) and ⊗-combining them with the cached clean messages.
A full inside-out recompute costs one segment-⊕ per join-tree edge; a
single-table delta costs one per edge on that table's root path.  On
CUDA every emission is the segment-⊕ kernel, over the edge's maintained
CSR (``DynamicState.jt``).

The refresh is eager: one emission per planned edge, each bumping
``QueryCounter.edges`` once, which is the JAX package's accounting for
the same stream.

The scorer duck-types the slice of :class:`CompiledEnsemble` the serving
layer uses (``factors`` / ``leaf_values`` / ``grouped_cached`` /
``n_rows``), so it can be published to a :class:`ModelRegistry` and
served by the micro-batcher unchanged; every applied delta bumps
``data_version``, which the service folds into its result-cache key so
stale scores are unreachable.  Row ids are slots in the capacity-padded
store: live rows keep their ids across deltas, dead slots score as
(0, 0) — count 0 marks "row not in the join", same as a live row whose
key matches nothing.

For CONCURRENT ingest + serve the scorer publishes MVCC
:class:`Snapshot` views (:meth:`MaintainedScorer.snapshot`): a pin of
factors + cached messages + join trees at one ``data_version``, captured
under ``state.lock`` and served lock-free while ``apply`` builds the
next version.  Tensors are never written after a snapshot may hold
them: ``apply`` writes each changed table's factor into a fresh copy
(copy on write), and refreshes build new message lists.

Staleness: ``staleness_s(root)`` is the wall-clock lag of a root's
served view behind the applied deltas (0 once a score refreshed it),
the signal the serving batcher burns its staleness objective against;
every catch-up observes the ``ivm.refresh_lag_s`` histogram and
re-samples the ``ivm.staleness_s`` gauge.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core.schema import Schema
from ..core.sumprod import QueryCounter, SumProd
from ..obs import get_registry, span
from ..serving.compile import CompiledEnsemble, compile_ensemble, contract, stack_table_factor
from .deltas import DynamicEdge, DynamicTable, TableDelta
from .state import DynamicState, StateView


class MaintainedScorer:
    """A compiled ensemble plus the dynamic state that keeps it fresh, on
    the ensemble's schema device."""

    def __init__(self, ens: CompiledEnsemble, slack: float = 0.25,
                 counter: Optional[QueryCounter] = None,
                 served_window_s: float = 30.0,
                 snapshot_retention: int = 4):
        sch = ens.schema
        self.schema = sch
        self.source = ens
        self.trees = ens.trees
        self.leaf_values = ens.leaf_values
        self.tree0_leaves = ens.tree0_leaves
        self.total_leaves = ens.total_leaves
        self.counter = counter if counter is not None else ens.counter
        self._sem = ens._sem
        self._sp = SumProd(sch, counter=self.counter)
        self.factor_dtype = ens.factor_dtype
        self.data_version = 0

        self.state = DynamicState(sch, slack=slack)
        self.tables: Dict[str, DynamicTable] = self.state.tables
        self.edges: Dict[frozenset, DynamicEdge] = self.state.edges

        # capacity-padded factors: source rows verbatim, dead slots ⊕-zero
        self.factors: Dict[str, torch.Tensor] = {}
        for t in sch.tables:
            pad = self.tables[t.name].capacity - t.n_rows
            self.factors[t.name] = torch.cat([
                ens.factors[t.name],
                torch.zeros((pad, self.total_leaves), dtype=self.factor_dtype,
                            device=sch.device),
            ])

        # per-root cached state (created lazily on first score)
        self._msgs: Dict[str, List[torch.Tensor]] = {}
        self._dirty: Dict[str, Set[int]] = {}
        self._grouped: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        # perf_counter instant of the oldest applied-but-unrefreshed delta,
        # PER ROOT (absent = that root's served view is caught up).  A root
        # counts toward the aggregate only while it is served (queried
        # within `served_window_s`): one abandoned by traffic must not pin
        # the staleness objective forever.
        self._stale_since: Dict[str, float] = {}
        self._last_query: Dict[str, float] = {}
        self.served_window_s = served_window_s
        # recently published MVCC snapshots, keyed by data_version; at
        # most `snapshot_retention` versions stay cached (evicted ones keep
        # serving whoever still references them)
        self.snapshot_retention = max(1, int(snapshot_retention))
        self._snaps: Dict[int, "Snapshot"] = {}

    # ------------------------------------------------------------- queries --
    def n_rows(self, table: str) -> int:
        return self.tables[table].capacity

    def live_rows(self, table: str) -> np.ndarray:
        return self.state.live_rows(table)

    def effective_schema(self) -> Schema:
        """A fresh static Schema over the live rows (slot order) — the
        full-recompute oracle the maintained scores must match."""
        return self.state.effective_schema()

    # -------------------------------------------------------------- deltas --
    def apply(self, deltas: Sequence[TableDelta]) -> int:
        """Apply a delta batch; returns the new ``data_version``.

        Per table: mutate the dynamic store (via ``DynamicState``),
        re-evaluate leaf-mask factor rows for just the changed slots, and
        mark the table dirty in every cached root's message state.
        Nothing global is recomputed here — the path-restricted refresh
        happens lazily at the next score."""
        if isinstance(deltas, TableDelta):
            deltas = [deltas]
        t0 = time.perf_counter()
        # the state lock makes the whole batch one atomic version step:
        # a concurrent snapshot() observes either none or all of it, and
        # never a factor scatter without its data_version bump
        with self.state.lock, span("ivm.apply", n_deltas=len(deltas)):
            fresh: Set[str] = set()              # factors copied in this batch
            for ch in self.state.apply(deltas):
                if ch.grew or len(ch.deleted) or len(ch.changed):
                    self._writable_factor(ch.table, fresh)
                # zero deleted slots BEFORE scattering fresh rows: an insert in
                # this same delta may have reused a just-deleted slot
                if len(ch.deleted):
                    gone = torch.from_numpy(ch.deleted).to(self.schema.device)
                    self.factors[ch.table][gone] = 0
                if len(ch.changed):
                    self._refresh_factor_rows(ch.table, ch.changed)
                if len(ch.changed) or len(ch.deleted):
                    ti = self.schema.index[ch.table]
                    now = time.perf_counter()
                    for root in self._msgs:
                        self._dirty.setdefault(root, set()).add(ti)
                        self._stale_since.setdefault(root, now)
            self._grouped.clear()
            self.data_version += 1
            self._gc_snapshots()
        reg = get_registry()
        reg.counter("ivm.deltas").inc(len(deltas))
        reg.histogram("ivm.apply_ms").observe((time.perf_counter() - t0) * 1e3)
        return self.data_version

    def staleness_s(self, root: Optional[str] = None) -> float:
        """Wall-clock lag of the served view behind applied deltas.

        With ``root``: 0.0 when that root's cached messages reflect the
        current ``data_version``, else seconds since its oldest
        unrefreshed delta landed.  Without: the max over *served* roots
        (queried within ``served_window_s``); before any root has been
        queried, every stale root counts."""
        now = time.perf_counter()
        if root is not None:
            t = self._stale_since.get(root)
            return max(0.0, now - t) if t is not None else 0.0
        if not self._stale_since:
            return 0.0
        if self._last_query:
            candidates = [t for r, t in self._stale_since.items()
                          if now - self._last_query.get(r, -np.inf) <= self.served_window_s]
        else:
            candidates = list(self._stale_since.values())
        if not candidates:
            return 0.0
        return max(0.0, now - min(candidates))

    def _note_fresh(self, root: str) -> None:
        """``root``'s served view just caught up: observe how long its
        resolved deltas sat unserved and re-sample the aggregate gauge."""
        self._last_query[root] = time.perf_counter()
        t = self._stale_since.pop(root, None)
        reg = get_registry()
        if t is not None:
            reg.histogram("ivm.refresh_lag_s").observe(time.perf_counter() - t)
        reg.gauge("ivm.staleness_s").set(self.staleness_s())

    def _writable_factor(self, table: str, fresh: Set[str]) -> None:
        """Give ``table`` a factor tensor of its current capacity that no
        snapshot holds: a copy (padded with ⊕-zero rows after growth),
        made at most once a batch unless the capacity grew again."""
        cur = self.factors[table]
        cap = self.tables[table].capacity
        if cap > cur.shape[0]:
            self.factors[table] = torch.cat(
                [cur, cur.new_zeros((cap - cur.shape[0], cur.shape[1]))])
        elif table not in fresh:
            self.factors[table] = cur.clone()
        fresh.add(table)

    def _refresh_factor_rows(self, table: str, slots: np.ndarray):
        """Re-evaluate the stacked leaf masks for ``slots`` and write them
        into the live factor (elementwise per-row ops — identical bits to
        a full-table recompute of the same rows)."""
        dt = self.tables[table]
        cols = self.schema.feat_cols[table]
        if cols:
            rows = np.stack(
                [dt.columns[c][slots].astype(np.float32) for c in cols], axis=1
            )
        else:
            rows = np.zeros((len(slots), 0), np.float32)
        dev = self.schema.device
        frows = stack_table_factor(self.schema, self.trees, table,
                                   featmat=torch.from_numpy(rows).to(dev),
                                   dtype=self.factor_dtype)
        self.factors[table][torch.from_numpy(np.asarray(slots, np.int64)).to(dev)] = frows

    # ------------------------------------------------------------- scoring --
    def _counts(self, group_by: str) -> torch.Tensor:
        """Grouped leaf counts via cached messages + path refresh."""
        jt = self.state.jt(group_by)
        sem, sp = self._sem, self._sp
        dirty = self._dirty.get(group_by)
        if group_by not in self._msgs:
            self._msgs[group_by] = sp.messages(sem, self.factors, jt=jt)
        elif dirty:
            t0 = time.perf_counter()
            with span("ivm.refresh", root=group_by, dirty=len(dirty)):
                self._msgs[group_by] = sp.refresh_messages(
                    sem, self.factors, self._msgs[group_by], dirty, jt)
            get_registry().histogram("ivm.refresh_ms").observe(
                (time.perf_counter() - t0) * 1e3)
        self._dirty[group_by] = set()
        self._note_fresh(group_by)
        return sp.node_factor(sem, self.factors, jt, jt.root, self._msgs[group_by])

    def score_grouped(self, group_by: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Σŷ, |ρ⋈J|) per slot of ``group_by`` — maintained counts, same
        contraction as the compiled scorer.  Dead slots read (0, 0)."""
        if self.counter is not None:
            self.counter.bump(1)
        return contract(self._counts(group_by), self.leaf_values, self.tree0_leaves)

    def grouped_cached(self, group_by: str) -> Tuple[torch.Tensor, torch.Tensor]:
        if group_by not in self._grouped:
            self._grouped[group_by] = self.score_grouped(group_by)
        return self._grouped[group_by]

    def recompute_oracle(self, group_by: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ground-truth full recompute: a fresh static compile over the
        effective live tables (new key dictionaries, no cached state),
        evaluated through a full message pass.  Returned tensors are
        capacity-shaped (live slots filled, dead slots 0) so they compare
        bit-for-bit against the maintained grouped output: the leaf counts
        are integer-valued float32 below 2²⁴, exact in any summation
        order, and the contraction runs over the same capacity-shaped
        count matrix (``contract``)."""
        with self.state.lock:
            eff = self.effective_schema()
            live = self.live_rows(group_by)
            cap = self.tables[group_by].capacity
        return self._oracle_from(eff, group_by, live, cap)

    def _oracle_from(self, eff: Schema, group_by: str, live, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The recompute oracle over an EXPLICIT effective schema /
        live-slot / capacity pin — shared by :meth:`recompute_oracle`
        (current state) and :meth:`Snapshot.recompute_oracle` (a frozen
        historical version)."""
        fresh = compile_ensemble(eff, self.trees, factor_dtype=self.factor_dtype)
        sp = SumProd(eff)
        jt = eff.join_tree(group_by)
        msgs = sp.messages(fresh._sem, fresh.factors, jt=jt)
        counts = sp.node_factor(fresh._sem, fresh.factors, jt, jt.root, msgs)
        full = counts.new_zeros((capacity, counts.shape[1]))
        full[torch.from_numpy(np.asarray(live, np.int64)).to(counts.device)] = counts
        return contract(full, fresh.leaf_values, fresh.tree0_leaves)

    # ----------------------------------------------------------- snapshots --
    def snapshot(self, roots: Optional[Sequence[str]] = None,
                 pin_oracle: bool = False) -> "Snapshot":
        """Publish an MVCC :class:`Snapshot` of the current
        ``data_version``.

        Cheap: ``apply`` writes into fresh tensors, never through ones a
        snapshot holds, so the factor dict and cached message lists are
        captured by reference; the only real work is join-tree
        materialization, cached per ``jt_version``.  The result is cached
        until the next ``apply``, so concurrent batches at one version
        share one snapshot.

        ``roots`` limits which roots the snapshot can serve (default:
        every table); ``pin_oracle=True`` additionally freezes the
        effective schema + live slots so :meth:`Snapshot.recompute_oracle`
        stays bit-exact after the live state has moved on.
        """
        names = (tuple(sorted(roots)) if roots is not None
                 else tuple(t.name for t in self.schema.tables))
        with self.state.lock:
            snap = self._snaps.get(self.data_version)
            if (snap is not None
                    and set(names) <= set(snap.view.jts)
                    and (not pin_oracle or snap.view.schema is not None)):
                return snap
            view = self.state.snapshot(names, pin_oracle=pin_oracle)
            snap = Snapshot(
                owner=self, view=view, data_version=self.data_version,
                factors=dict(self.factors), leaf_values=self.leaf_values,
                msgs={r: list(self._msgs[r]) for r in names
                      if r in self._msgs},
                dirty={r: frozenset(self._dirty.get(r, ())) for r in names},
            )
            self._snaps[self.data_version] = snap
            self._gc_snapshots()
            return snap

    def _gc_snapshots(self) -> None:
        """Evict cached snapshot versions beyond the retention window.
        Called under ``state.lock`` (from ``apply`` and ``snapshot``)."""
        floor = self.data_version - self.snapshot_retention
        for v in [v for v in self._snaps if v <= floor]:
            del self._snaps[v]

    def adopt_state(self, state: DynamicState) -> None:
        """Replace the dynamic substrate with a RECOVERED state (a
        checkpoint load — see :mod:`repro_torch.incremental.recover`).

        The stacked leaf-mask factors are re-evaluated for every live
        slot of the adopted state; factor rows are pure per-row
        functions of current column values, so the result is
        bit-identical to having maintained them through the original
        delta stream.  All cached messages, memoized scores, staleness
        and snapshots are dropped (they referred to the old
        substrate), and ``data_version`` adopts the recovered LSN."""
        if state.device != self.schema.device:
            raise ValueError(f"state on {state.device}, scorer on {self.schema.device}")
        with state.lock:
            self.state = state
            self.tables = state.tables
            self.edges = state.edges
            self.factors = {}
            for t in self.schema.tables:
                dt = self.tables[t.name]
                self.factors[t.name] = torch.zeros(
                    (dt.capacity, self.total_leaves), dtype=self.factor_dtype,
                    device=self.schema.device)
                live = dt.live_slots()
                if len(live):
                    self._refresh_factor_rows(t.name, live)
            self._msgs.clear()
            self._dirty.clear()
            self._grouped.clear()
            self._stale_since.clear()
            self._last_query.clear()
            self._snaps.clear()
            self.data_version = state.data_version

    def _absorb(self, root: str, data_version: int, msgs) -> None:
        """Adopt a snapshot's refreshed messages iff the live scorer is
        still at the snapshot's ``data_version`` — at the same version
        the snapshot and the live scorer share one dirty set (both only
        change under ``state.lock``), so its refresh IS the live
        refresh.  After the version has moved on, the refresh only
        served that snapshot; drop it."""
        with self.state.lock:
            if self.data_version != data_version:
                return
            self._msgs[root] = list(msgs)
            self._dirty[root] = set()
            self._note_fresh(root)

    def score_full(self, group_by: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full recompute over the SAME maintained state (every edge of
        ``group_by``'s join tree re-emitted): the baseline of the edge and
        latency ratios.  Touches no cached message."""
        jt = self.state.jt(group_by)
        msgs = self._sp.messages(self._sem, self.factors, jt=jt)
        counts = self._sp.node_factor(self._sem, self.factors, jt, jt.root, msgs)
        return contract(counts, self.leaf_values, self.tree0_leaves)


class Snapshot:
    """An MVCC view of a :class:`MaintainedScorer`, pinned at one
    ``data_version``.

    Duck-types the serving surface (``n_rows`` / ``score_grouped`` /
    ``grouped_cached`` / ``data_version``), so the micro-batcher
    dispatches against it unchanged while the owner applies the next
    version concurrently — reads never observe a half-applied delta
    because nothing here is written after capture: the factor dict and
    message lists were captured under ``state.lock``, and the owner
    writes only fresh tensors; the join trees were materialized at
    capture.

    Snapshots are *lazily consistent*: one captured with pending dirty
    tables resolves them on first score (same ``refresh_plan``, same
    edge accounting), then writes the refreshed messages back to the
    owner iff it is still at this version
    (:meth:`MaintainedScorer._absorb`) — so snapshot serving costs no
    extra message emissions over serving the live scorer.  Scoring a
    root outside the pinned set raises ``KeyError``.
    """

    def __init__(self, owner: MaintainedScorer, view: StateView,
                 data_version: int, factors, leaf_values, msgs, dirty):
        self._owner = owner
        self.view = view
        self.data_version = data_version
        self.jt_version = view.jt_version
        self.factors = factors
        self.leaf_values = leaf_values
        self._msgs = msgs           # root → message list (None until scored)
        self._dirty = dirty         # root → frozenset of dirty table idx
        self._grouped: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        # serializes lazy refresh within ONE snapshot; never held while
        # taking state.lock (write-back happens after release)
        self._lock = threading.Lock()

    # ------------------------------------------------------------- surface --
    def n_rows(self, table: str) -> int:
        return self.view.capacities[table]

    def _counts(self, group_by: str) -> torch.Tensor:
        jt = self.view.jt(group_by)              # KeyError if not pinned
        o = self._owner
        sem, sp = o._sem, o._sp
        with self._lock:
            msgs = self._msgs.get(group_by)
            dirty = self._dirty.get(group_by, frozenset())
            if msgs is None:
                msgs = sp.messages(sem, self.factors, jt=jt)
            elif dirty:
                t0 = time.perf_counter()
                with span("ivm.refresh", root=group_by, dirty=len(dirty)):
                    msgs = sp.refresh_messages(sem, self.factors, msgs, dirty, jt)
                get_registry().histogram("ivm.refresh_ms").observe(
                    (time.perf_counter() - t0) * 1e3)
            self._msgs[group_by] = msgs
            self._dirty[group_by] = frozenset()
        o._absorb(group_by, self.data_version, msgs)
        return sp.node_factor(sem, self.factors, jt, jt.root, msgs)

    def score_grouped(self, group_by: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Σŷ, |ρ⋈J|) per slot at this snapshot's pinned version —
        identical contraction (and bits) to the owner at this version."""
        o = self._owner
        if o.counter is not None:
            o.counter.bump(1)
        return contract(self._counts(group_by), self.leaf_values, o.tree0_leaves)

    def grouped_cached(self, group_by: str) -> Tuple[torch.Tensor, torch.Tensor]:
        with self._lock:
            hit = self._grouped.get(group_by)
        if hit is None:
            hit = self.score_grouped(group_by)
            with self._lock:
                hit = self._grouped.setdefault(group_by, hit)
        return hit

    def recompute_oracle(self, group_by: str
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ground-truth full recompute AT THIS PINNED VERSION — works
        even after the live state has moved on.  Requires the snapshot
        to have been taken with ``pin_oracle=True``."""
        if self.view.schema is None:
            raise ValueError(
                "snapshot was not captured with pin_oracle=True; "
                "no frozen effective schema to recompute from")
        return self._owner._oracle_from(
            self.view.schema, group_by,
            self.view.live[group_by], self.view.capacities[group_by])
