"""Shared dynamic relational state for maintained views AND retraining.

:class:`DynamicState` owns everything that makes a schema *mutable
in place with stable identities*: the capacity-padded
:class:`DynamicTable` stores, the append-only :class:`DynamicEdge` join
key dictionaries, and per-root join trees with the maintained key-id
arrays spliced into the schema's static edge order.  It applies
:class:`TableDelta` batches and reports typed :class:`TableChange`
records; what to DO about a change is the consumer's business:

- :class:`~repro_torch.incremental.maintain.MaintainedScorer` owns its
  state and drives it through its own ``apply`` (which also re-evaluates
  stacked leaf-mask factor rows and refreshes memoized scores).
- ``MaintainedEngine`` (retrain.py) *subscribes* to its state
  (:meth:`DynamicState.subscribe`): every ``apply`` — whoever issues
  it — pushes the change records through the engine's invalidation
  hook.  Consumers that cache derived artifacts MUST subscribe rather
  than poll; a direct ``state.apply`` then cannot leave them stale.

Join trees live on ``schema.device``.  Each edge carries the CSR of its
child's key ids (:class:`~repro_torch.kernels.segment_sum.Segments`),
the segment-⊕ kernel's input; :meth:`DynamicState.jt` rebuilds an
edge's CSR and parent ids only when that side's ids were written since
(``DynamicEdge.versions``), on the device (``Segments.from_tensor``),
and every other edge keeps its objects; a side's ids go to the device
once whether it serves as child, parent or both.  ``csr_s`` adds up
the host seconds those rebuilds take, ``csr_builds`` counts the CSRs.
Under a data mesh a SumProd pass walks the CSR of this rank's block of a
local child's capacity slots (``spmd.local_segments``), built once per
edge CSR, so it too is rebuilt only when that side moved; the layout is
decided afresh from each side's capacity, which a growth can make
indivisible.

Concurrency: the state owns a reentrant ``lock`` serializing mutation
against snapshot capture.  :meth:`apply` holds it for the whole batch
(listeners included), so a :class:`StateView` taken under the same lock
can never observe a half-applied delta.  Reads of pinned views then run
lock-free: everything a view holds is immutable (tensors copied from the
numpy ids, frozen join trees, copied numpy).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.schema import JoinTree, Schema, TreeEdge
from ..kernels.segment_sum import Segments
from .deltas import DynamicEdge, DynamicTable, TableDelta


@dataclasses.dataclass(frozen=True)
class TableChange:
    """What one applied :class:`TableDelta` did to one table."""

    table: str
    changed: np.ndarray      # slots whose values changed (updates, then inserts)
    deleted: np.ndarray      # slots whose live bit was cleared
    n_inserted: int          # count of trailing insert slots in ``changed``
    grew: bool               # capacity grew (factor arrays need padding)


@dataclasses.dataclass(frozen=True)
class StateView:
    """An immutable pin of one :class:`DynamicState` version.

    Captured atomically under ``state.lock``: the version pair, the
    per-root join trees materialized at capture time (their tensors are
    copies of the numpy ids, which later ``apply`` calls mutate in
    place), per-table capacities, and — when pinned for oracle use — a
    frozen effective schema plus live-slot arrays so a full recompute at
    exactly this version stays possible after the live state has moved
    on.
    """

    data_version: int
    jt_version: int
    jts: Dict[str, JoinTree]
    capacities: Dict[str, int]
    schema: Optional[Schema] = None          # effective schema (oracle pin)
    live: Optional[Dict[str, np.ndarray]] = None  # live slots per table

    def jt(self, root: str) -> JoinTree:
        if root not in self.jts:
            raise KeyError(
                f"root {root!r} not pinned in this view "
                f"(pinned: {sorted(self.jts)})"
            )
        return self.jts[root]


class DynamicState:
    """Mutable mirror of a :class:`Schema` with stable row/key identities."""

    def __init__(self, schema: Schema, slack: float = 0.25):
        self.schema = schema
        self.tables: Dict[str, DynamicTable] = {
            t.name: DynamicTable(t, slack=slack) for t in schema.tables
        }
        # one maintained key dictionary per undirected join edge
        self.edges: Dict[frozenset, DynamicEdge] = {}
        for a, b, key in schema._undirected_edges:
            self.edges[frozenset((a, b))] = DynamicEdge(
                self.tables[a], self.tables[b], key
            )
        self.data_version = 0
        self.jt_version = 0                      # bumps on any id/key change
        self._init_runtime()

    def _init_runtime(self) -> None:
        """The state that is not data (caches, listeners, the lock): set
        by ``__init__`` and by a checkpoint load."""
        self._jts: Dict[str, JoinTree] = {}
        self._jt_built_at: Dict[str, int] = {}
        # (edge, table) → [ids version, ids tensor, Segments or None]: one
        # copy of a side's ids serves as parent ids and under its CSR
        self._sides: Dict[tuple, list] = {}
        self.csr_s = 0.0                         # host seconds of edge rebuilds
        self.csr_builds = 0                      # CSRs built by jt()
        self._listeners: List = []
        # durable delta log (incremental/wal.py), attached via
        # ``WalWriter.attach(state)``: every applied batch is appended
        # under this lock with lsn == the data_version it produces
        self.wal = None
        # Reentrant: apply() holds it across listener callbacks, and a
        # listener may legitimately take a snapshot of the state it is
        # being notified about.
        self.lock = threading.RLock()

    @property
    def device(self) -> torch.device:
        return self.schema.device

    def subscribe(self, fn) -> None:
        """Register a change listener: ``fn(changes)`` is called after
        every :meth:`apply` with the batch's :class:`TableChange`
        records (cache owners invalidate here, not by polling)."""
        self._listeners.append(fn)

    # ------------------------------------------------------------- queries --
    def capacity(self, table: str) -> int:
        return self.tables[table].capacity

    def live_rows(self, table: str) -> np.ndarray:
        return self.tables[table].live_slots()

    def feature_rows(self, table: str, slots: np.ndarray) -> np.ndarray:
        """(len(slots), d_t) float32 feature values at ``slots``, dead
        slots pushed to +inf — the payload incremental split-plan
        maintenance re-bins (see ``core.hist.rebin_rows``): a dead
        slot's stale column values must neither bin validly nor ever
        become a threshold."""
        dt = self.tables[table]
        cols = self.schema.feat_cols[table]
        slots = np.asarray(slots, np.int64)
        if not cols:
            return np.zeros((len(slots), 0), np.float32)
        vals = np.stack(
            [dt.columns[c][slots].astype(np.float32) for c in cols], axis=1
        )
        vals[~dt.live[slots]] = np.inf
        return vals

    def effective_schema(self) -> Schema:
        """A fresh static Schema over the live rows (slot order), on the
        same device — the full-recompute oracle maintained results must
        match."""
        return Schema(
            [self.tables[t.name].effective() for t in self.schema.tables],
            label=(self.schema.label_table, self.schema.label_column),
            device=self.device,
        )

    def _ids_tensor(self, de: DynamicEdge, table: str) -> torch.Tensor:
        # .copy() is load-bearing: torch.from_numpy shares memory, and
        # DynamicEdge.assign mutates `ids` in place — on the CPU, where
        # .to() is a no-op, a pinned join tree's ids would otherwise
        # change under a concurrent reader (a reused slot's contribution
        # migrates to the wrong segment: a torn read)
        return torch.from_numpy(de.ids[table].copy()).to(self.device).to(torch.int64)

    def _side(self, key: frozenset, de: DynamicEdge, table: str) -> list:
        ver, side = de.versions[table], self._sides.get((key, table))
        if side is None or side[0] != ver:
            side = self._sides[(key, table)] = [ver, self._ids_tensor(de, table), None]
        return side

    def _child_seg(self, key: frozenset, de: DynamicEdge, table: str) -> Segments:
        side = self._side(key, de, table)
        if side[2] is None or side[2].n_keys != de.n_keys:
            side[2] = Segments.from_tensor(side[1], de.n_keys)
            self.csr_builds += 1
        return side[2]

    def jt(self, root: str) -> JoinTree:
        """Join tree for ``root`` with the MAINTAINED key-id arrays spliced
        into the schema's static edge order."""
        if self._jt_built_at.get(root) == self.jt_version and root in self._jts:
            return self._jts[root]
        t0 = time.perf_counter()
        base = self.schema.join_tree(root)
        names = self.schema.names
        edges = []
        for e in base.edges:
            child, parent = names[e.child], names[e.parent]
            key = frozenset((child, parent))
            de = self.edges[key]
            edges.append(TreeEdge(
                child=e.child, parent=e.parent, key_cols=e.key_cols,
                child_seg=self._child_seg(key, de, child),
                parent_ids=self._side(key, de, parent)[1],
            ))
        jt = JoinTree(root=base.root, edges=tuple(edges))
        self._jts[root] = jt
        self._jt_built_at[root] = self.jt_version
        self.csr_s += time.perf_counter() - t0
        return jt

    def snapshot(self, roots: Sequence[str], pin_oracle: bool = False) -> StateView:
        """Pin an immutable :class:`StateView` at the current version.

        ``roots`` selects which join trees to materialize; with
        ``pin_oracle=True`` the effective schema and live-slot arrays
        are frozen too (copied — ``DynamicTable.live`` mutates in
        place), enabling bit-exact full recompute at this version
        arbitrarily far in the future.
        """
        with self.lock:
            jts = {r: self.jt(r) for r in roots}
            caps = {t: dt.capacity for t, dt in self.tables.items()}
            sch = live = None
            if pin_oracle:
                sch = self.effective_schema()
                live = {t: dt.live_slots().copy() for t, dt in self.tables.items()}
            return StateView(
                data_version=self.data_version, jt_version=self.jt_version,
                jts=jts, capacities=caps, schema=sch, live=live,
            )

    # -------------------------------------------------------------- deltas --
    def apply(self, deltas: Sequence[TableDelta]) -> List[TableChange]:
        """Apply a delta batch to the stores and key dictionaries;
        returns per-delta change records in application order.  Bumps
        ``jt_version`` on structural change (inserts / capacity growth)
        and ``data_version`` once per batch."""
        if isinstance(deltas, TableDelta):
            deltas = [deltas]
        with self.lock:
            return self._apply_locked(deltas)

    def _apply_locked(self, deltas: Sequence[TableDelta]) -> List[TableChange]:
        changes: List[TableChange] = []
        structural = False
        for d in deltas:
            if d.table not in self.tables:
                raise KeyError(f"unknown table {d.table!r}")
            dt = self.tables[d.table]
            if d.updates is not None:
                key_cols = {c for e in self.edges.values()
                            if d.table in e.tables for c in e.key_cols}
                bad = key_cols & set(d.updates[1])
                if bad:
                    raise ValueError(
                        f"update of join-key columns {sorted(bad)} on "
                        f"{d.table!r}: issue delete + insert instead"
                    )
            deleted = (np.unique(np.asarray(d.deletes, np.int64))
                       if d.deletes is not None and len(d.deletes)
                       else np.zeros((0,), np.int64))
            n_ins = (len(next(iter(d.inserts.values()))) if d.inserts else 0)
            changed, grew = dt.apply(d)
            if grew:
                structural = True
            # inserts (tail of `changed`) need key ids on incident edges;
            # key-domain growth is absorbed by ⊕-identity padding of any
            # cached messages, so only the id arrays (→ join trees) go
            # stale here
            if n_ins:
                structural = True
                ins_slots = changed[-n_ins:]
                for e in self.edges.values():
                    if d.table in e.tables:
                        e.assign(dt, ins_slots)
            changes.append(TableChange(
                table=d.table, changed=changed, deleted=deleted,
                n_inserted=n_ins, grew=grew,
            ))
        if structural:
            self.jt_version += 1
        # WAL append sits AFTER the mutations (which can only raise
        # before touching anything durable) and BEFORE the version bump:
        # the log carries exactly the committed versions in order, and a
        # crash in the append window loses only in-memory state — which
        # the crash loses anyway — never a logged-but-unapplied version
        if self.wal is not None:
            self.wal.append(self.data_version + 1, deltas)
        self.data_version += 1
        for fn in self._listeners:
            fn(changes)
        return changes
