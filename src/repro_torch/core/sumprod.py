"""Inside-out evaluation of SumProd queries (paper §1.1.1, Lemma 1.1).

The evaluator is a message-passing pass over a rooted join tree.  Each
table contributes a *factor*: one semiring value per row (``⊗`` of that
table's q_f terms, with J^{(v)}-constraint masks already applied as
semiring zeros).  An edge child→parent sends

    msg[key] = ⊕_{rows r of child : key(r)=key} factor_child[r]
    factor_parent[r'] ⊗= msg[key(r')]

computed as one segment-⊕ over the edge's static CSR (the segment-⊕
kernel on CUDA) plus one gather.  After all edges, the root's factor
holds, per root row ρ, exactly ``⊕_{x ∈ ρ ⋈ J} ⊗_f q_f(x_f)`` — the
paper's *grouped-by* query.  The ungrouped query is one more ⊕-reduce.

Query families (tree nodes, leaves, leaf pairs) run as one pass with an
explicit leading batch dim on the factors: every emission is then one
kernel launch for the whole family.

Data parallelism: under an active ``spmd`` data mesh a table whose rows
the layout rule shards for the semiring's dtype is *local* — its factor
arrives as this rank's row block.  An edge whose child is local runs its
segment-⊕ over the CSR of the child's block (``spmd.local_segments``,
built once per CSR) against the same key domain, then ONE all-reduce of
the message with the semiring's ⊕ (``spmd.psum_message``); an edge whose
child is replicated runs on the whole CSR with no collective (an
all-reduce there would count every row once per rank).  A local parent
gathers with its block of the parent ids.  A grouped result of a local
root stays a row block (callers ``spmd.replicate`` it); the ungrouped
reduce of a local root is all-reduced.  Query and edge accounting is
host-side and so the same on every rank and as for one process.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Hashable, Iterable, List, Optional, Set

import numpy as np
import torch

from ..distributed import spmd as _spmd
from ..obs import metrics as _metrics
from ..obs.trace import span as _span
from .schema import JoinTree, Schema, dense_ids
from .semiring import Semiring


class QueryCounter:
    """Counts SumProd evaluations — used by benchmarks to verify the
    paper's query-complexity claims (O(m²L²τ) exact vs O(mLτ) sketched).

    ``edges`` separately counts segment-⊕ message emissions: a full
    inside-out pass emits one per join-tree edge, while a path-restricted
    refresh (:meth:`SumProd.refresh_messages`) emits only along the
    changed tables' root paths.  Each instance owns thread-safe counters
    and mirrors into the process registry's ``sumprod.queries`` /
    ``sumprod.edges`` series.
    """

    def __init__(self):
        self._count = _metrics.Counter("sumprod.queries")
        self._edges = _metrics.Counter("sumprod.edges")
        reg = _metrics.get_registry()
        self._g_count = reg.counter("sumprod.queries")
        self._g_edges = reg.counter("sumprod.edges")

    @property
    def count(self) -> int:
        return self._count.value

    @property
    def edges(self) -> int:
        return self._edges.value

    def bump(self, n: int = 1):
        self._count.inc(n)
        self._g_count.inc(n)

    def bump_edges(self, n: int = 1):
        self._edges.inc(n)
        self._g_edges.inc(n)


def refresh_plan(jt: JoinTree, dirty: Iterable[int]) -> List[bool]:
    """Static plan of a path-restricted refresh: which edges (leaf-first
    order, aligned with ``jt.edges``) must re-emit their segment-⊕ when
    the tables in ``dirty`` changed.  Dirtiness propagates child→parent,
    so the plan covers the union of the dirty tables' root paths."""
    live: Set[int] = set(dirty)
    plan: List[bool] = []
    for e in jt.edges:
        hit = e.child in live
        plan.append(hit)
        if hit:
            live.add(e.parent)
    return plan


class MessageCache:
    """Signature-keyed memo of per-edge segment-⊕ messages.

    Key: (join-tree root, edge index, subtree signature).  The subtree
    signature combines, bottom-up, the factor signatures of every table
    in the edge's child subtree — two queries whose factors agree on that
    whole subtree share the message.  Entries are LRU-bounded per edge;
    a cached message whose key domain grew since emission is ⊕-identity
    padded on retrieval (a new key has no child rows yet).
    """

    def __init__(self, max_per_edge: int = 64):
        self.max_per_edge = max_per_edge
        self._store: Dict[tuple, "OrderedDict[Hashable, torch.Tensor]"] = {}
        self.hits = 0
        self.misses = 0
        reg = _metrics.get_registry()
        self._g_hits = reg.counter("msgcache.hits")
        self._g_misses = reg.counter("msgcache.misses")

    def get(self, root: int, edge: int, sig: Hashable):
        slot = self._store.get((root, edge))
        if slot is None or sig not in slot:
            self.misses += 1
            self._g_misses.inc()
            return None
        slot.move_to_end(sig)
        self.hits += 1
        self._g_hits.inc()
        return slot[sig]

    def put(self, root: int, edge: int, sig: Hashable, msg: torch.Tensor):
        slot = self._store.setdefault((root, edge), OrderedDict())
        slot[sig] = msg
        slot.move_to_end(sig)
        while len(slot) > self.max_per_edge:
            slot.popitem(last=False)

    def clear(self):
        self._store.clear()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


def _pad_keys(sem: Semiring, msg: torch.Tensor, n_keys: int) -> torch.Tensor:
    """⊕-identity-pad a message whose key domain grew since emission."""
    ax = sem.row_dim(msg)
    if msg.shape[ax] >= n_keys:
        return msg
    pad = sem.zeros(msg.shape[:ax] + (n_keys - msg.shape[ax],), device=msg.device)
    return torch.cat([msg, pad], dim=ax)


class _Layout:
    """Which tables of a join tree are local row blocks on this rank."""

    def __init__(self, mesh, sem: Semiring, jt: JoinTree):
        self.mesh, self.dtype = mesh, sem.dtype
        self.rows: Dict[int, int] = {}
        for e in jt.edges:
            self.rows[e.child] = e.child_seg.n_rows
            self.rows[e.parent] = int(e.parent_ids.shape[0])
        self.local = {t: _spmd.shards(n, sem.dtype, mesh) for t, n in self.rows.items()}

    @staticmethod
    def of(sem: Semiring, jt: JoinTree) -> Optional["_Layout"]:
        mesh = _spmd.current_data_mesh()
        return _Layout(mesh, sem, jt) if _spmd.data_axis_size(mesh) > 1 else None

    def block(self, node: int, ids: torch.Tensor) -> torch.Tensor:
        """The rows of a per-row tensor of ``node`` that this rank holds."""
        lo, hi = _spmd.local_range(self.rows[node], self.dtype, self.mesh)
        return ids[lo:hi]

    def check(self, sem: Semiring, node: int, f: torch.Tensor, name: str) -> None:
        """A factor must have its table's rows in this layout: the block
        for a local table, all of them otherwise; nothing is resliced."""
        if node not in self.rows:
            return
        want = self.rows[node] // self.mesh.size if self.local[node] else self.rows[node]
        got = f.shape[sem.row_dim(f)]
        if got != want:
            raise ValueError(
                f"factor of {name!r} has {got} rows; its layout over {self.mesh.size} ranks "
                f"wants {want} ({'a row block' if self.local[node] else 'replicated'} of "
                f"{self.rows[node]})")


class SumProd:
    """Executable SumProd program for one schema."""

    def __init__(self, schema: Schema, counter: Optional[QueryCounter] = None):
        self.schema = schema
        self.counter = counter

    def ones_factors(self, sem: Semiring, batch_shape=()) -> Dict[str, torch.Tensor]:
        """Factor dict with ⊗-identity everywhere (q_f ≡ 1)."""
        return {
            t.name: _spmd.shard_rows(sem.ones(tuple(batch_shape) + (t.n_rows,),
                                              device=self.schema.device),
                                     row_axis=len(batch_shape), dtype=sem.dtype)
            for t in self.schema.tables
        }

    # ------------------------------------------------------- message pass --
    def node_factor(self, sem: Semiring, factors: Dict[str, torch.Tensor], jt: JoinTree,
                    node: int, msgs: List[Optional[torch.Tensor]]) -> torch.Tensor:
        """Combined factor at ``node``: base factor ⊗ gathered messages
        from every child edge whose message is already available.  The
        gather axis is derived from each message's rank, so factors and
        messages may carry leading batch dims (broadcast under ⊗).  Under
        a data mesh a local node's factor is its row block."""
        name = self.schema.names[node]
        f = factors[name]
        lay = _Layout.of(sem, jt)
        if lay is not None:
            lay.check(sem, node, f, name)
        for i, e in enumerate(jt.edges):
            if e.parent == node and msgs[i] is not None:
                m = msgs[i]
                ids = e.parent_ids if lay is None else lay.block(node, e.parent_ids)
                f = sem.mul(f, m.index_select(sem.row_dim(m), ids))
        return f

    def _emit(self, sem, factors, jt, i, msgs):
        e = jt.edges[i]
        with _span("sumprod.emit", edge=i, child=e.child, parent=e.parent,
                   n_keys=e.n_keys):
            cf = self.node_factor(sem, factors, jt, e.child, msgs)
            lay = _Layout.of(sem, jt)
            if lay is None or not lay.local[e.child]:
                return sem.segment_add(cf, e.child_seg)
            msg = sem.segment_add(cf, _spmd.local_segments(e.child_seg, lay.mesh))
            return _spmd.psum_message(msg, sem.all_reduce_op, lay.mesh)

    def messages(self, sem: Semiring, factors: Dict[str, torch.Tensor],
                 root: Optional[str] = None,
                 jt: Optional[JoinTree] = None) -> List[torch.Tensor]:
        """Full inside-out pass, returning the per-edge segment-⊕ messages
        (leaf-first order, aligned with ``jt.edges``) instead of consuming
        them inline — the cacheable state incremental maintenance reuses."""
        if jt is None:
            jt = self.schema.join_tree(root)
        msgs: List[Optional[torch.Tensor]] = [None] * len(jt.edges)
        with _span("sumprod.messages", n_edges=len(jt.edges)):
            for i in range(len(jt.edges)):
                msgs[i] = self._emit(sem, factors, jt, i, msgs)
        if self.counter is not None:
            self.counter.bump_edges(len(jt.edges))
        return msgs  # type: ignore[return-value]

    def refresh_messages(self, sem: Semiring, factors: Dict[str, torch.Tensor],
                         msgs: List[torch.Tensor], dirty: Iterable[int],
                         jt: JoinTree) -> List[torch.Tensor]:
        """Path-restricted re-emission: recompute messages only on edges
        whose child subtree contains a changed table, reusing every cached
        clean message (⊕-identity-padded where a key domain grew).
        ``dirty``: indices of tables whose factors changed."""
        plan = refresh_plan(jt, dirty)
        new = list(msgs)
        with _span("sumprod.refresh", n_edges=sum(plan)):
            for i, e in enumerate(jt.edges):
                new[i] = _pad_keys(sem, new[i], e.n_keys)
                if plan[i]:
                    new[i] = self._emit(sem, factors, jt, i, new)
        if self.counter is not None:
            self.counter.bump_edges(sum(plan))
        return new

    def messages_memo(self, sem: Semiring, factors: Dict[str, torch.Tensor],
                      jt: JoinTree, sigs: Dict[str, Hashable],
                      cache: MessageCache) -> List[torch.Tensor]:
        """Inside-out message pass through a signature-keyed cache.

        ``factors``: per-table tensors with ONE leading batch dim
        ((B_t, n_rows, *value_shape), B_t ∈ {1, K}).  ``sigs``: per-table
        hashable factor signatures.  An edge whose whole child subtree
        matches a cached signature reuses the cached message and emits
        nothing; only misses run a segment-⊕ (and bump
        ``QueryCounter.edges``).
        """
        names = self.schema.names
        msgs: List[Optional[torch.Tensor]] = [None] * len(jt.edges)
        subsig: List[Hashable] = [None] * len(jt.edges)
        recomputed = 0
        for i, e in enumerate(jt.edges):
            incoming = [j for j in range(i) if jt.edges[j].parent == e.child]
            sig = (sigs[names[e.child]], tuple(subsig[j] for j in incoming))
            subsig[i] = sig
            hit = cache.get(jt.root, i, sig)
            if hit is not None:
                padded = _pad_keys(sem, hit, e.n_keys)
                if padded is not hit:
                    cache.put(jt.root, i, sig, padded)
                msgs[i] = padded
                continue
            msgs[i] = self._emit(sem, factors, jt, i, msgs)
            cache.put(jt.root, i, sig, msgs[i])
            recomputed += 1
        if self.counter is not None:
            self.counter.bump_edges(recomputed)
        return msgs  # type: ignore[return-value]

    def __call__(self, sem: Semiring, factors: Dict[str, torch.Tensor],
                 group_by: Optional[str] = None, root: Optional[str] = None,
                 n_queries: int = 1):
        """Evaluate the query.

        factors: per-table tensors (*batch, n_rows, *value_shape); a
        leading batch dim evaluates a family of queries in one pass (the
        plan is shared).
        group_by: if set, return per-row results for that table (the tree
        is rooted there; its row block where the table is local under a
        data mesh).  Otherwise reduce the rows to one value each.
        """
        root_name = group_by or root or self.schema.names[0]
        jt: JoinTree = self.schema.join_tree(root_name)
        if self.counter is not None:
            self.counter.bump(n_queries)
        msgs = self.messages(sem, factors, jt=jt)
        out = self.node_factor(sem, factors, jt, jt.root, msgs)
        if group_by is not None:
            return out
        red = sem.reduce_add(out, dim=sem.row_dim(out))
        lay = _Layout.of(sem, jt)
        if lay is not None and lay.local.get(jt.root, False):
            red = _spmd.psum_message(red, sem.all_reduce_op, lay.mesh)
        return red


def materialize_join(schema: Schema) -> Dict[str, torch.Tensor]:
    """Materialize J = T_1 ⋈ … ⋈ T_τ (bag semantics) — tests/oracle ONLY.

    Returns {column_name: (|J|,) tensor} on ``schema.device`` plus
    per-table row indices ``__rows__<table>``, with the rows in the same
    order as a nested loop over (left row, matching right rows in row
    order).  Each join step is index arithmetic: the right rows are
    grouped by key once (stable argsort), and every left row's run of
    matches is laid out with ``np.repeat`` and a running offset.
    """
    tables = schema.tables
    cur_cols = {c: np.asarray(v) for c, v in tables[0].columns.items()}
    cur_rows = {tables[0].name: np.arange(tables[0].n_rows)}
    pending = list(tables[1:])
    while pending:
        progress = False
        for t in list(pending):
            shared = [c for c in t.columns if c in cur_cols]
            if not shared:
                continue
            n_left = len(next(iter(cur_cols.values())))
            ids = dense_ids([np.concatenate([cur_cols[c], t.col(c)]) for c in shared])
            lk, rk = ids[:n_left], ids[n_left:]
            order = np.argsort(rk, kind="stable")          # right rows grouped by key
            counts = np.bincount(rk, minlength=int(ids.max()) + 1 if len(ids) else 0)
            starts = np.cumsum(counts) - counts            # each key's run in `order`
            per_left = counts[lk]                          # matches of each left row
            li_out = np.repeat(np.arange(n_left), per_left)
            # output slot j of left row i takes the (j - first slot of i)-th match
            shift = starts[lk] - (np.cumsum(per_left) - per_left)
            ri_out = order[np.arange(len(li_out)) + np.repeat(shift, per_left)]
            cur_cols = {c: v[li_out] for c, v in cur_cols.items()}
            for c in t.columns:
                if c not in cur_cols:
                    cur_cols[c] = t.col(c)[ri_out]
            cur_rows = {k: v[li_out] for k, v in cur_rows.items()}
            cur_rows[t.name] = ri_out
            pending.remove(t)
            progress = True
        if not progress:
            raise ValueError("disconnected join graph")
    dev = schema.device
    out = {c: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for c, v in cur_cols.items()}
    for k, v in cur_rows.items():
        out["__rows__" + k] = torch.from_numpy(v.astype(np.int64)).to(dev)
    return out
