"""Injectable grouped-query engines for the boosting trainer.

The trainer's node-statistics queries — the fused (n, Σy, Σy²) channels
query, the exact leaf-pair count queries, and the polynomial-semiring
sketch queries — are routed through a :class:`QueryEngine`, so the same
Algorithm 1–3 control flow can run against different evaluation
strategies.  :class:`DirectEngine` (the paper's execution model) runs
one full inside-out SumProd pass per query family, with the level's K
tree nodes as the leading batch dim of every factor; its query and edge
costs are accounted analytically by the trainer.

Engines also own the trainer's data surface (row-domain sizes and the
feature matrices masks and split plans are built from).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .semiring import Arithmetic
from .sketch import sketch_factors


class QueryEngine:
    """Strategy interface for the Booster's grouped SumProd queries.

    ``bind(booster)`` is called once from ``Booster.__init__`` with the
    fully-constructed trainer (schema, semirings, sketch hashes).
    ``analytic_edges``: the trainer bumps ``QueryCounter.edges``
    analytically (one emission per join-tree edge per query family);
    engines that count real emissions themselves set False.
    """

    analytic_edges: bool = True

    def bind(self, booster) -> None:
        raise NotImplementedError

    def grouped_c3(self, table: str, masks, extra=None):
        """(K, rows(table), 3): (count, Σy, Σy²) grouped by ``table``,
        batched over the K node-mask rows; ``extra`` conjoins optional
        per-table masks (a previous tree's leaf)."""
        raise NotImplementedError

    def grouped_count_pair(self, table: str, masks, extra_a, extra_b):
        """(K, rows(table)): |J^{(a)} ∩ J^{(b)} ∩ J^{(v)} ∩ ρ⋈·| counts."""
        raise NotImplementedError

    def grouped_sketch(self, table: str, masks, extra=None, labeled=False):
        """(K, rows(table), *value_shape): polynomial-semiring sketch
        grouped by ``table``; ``labeled`` weights the label table's
        factor by y."""
        raise NotImplementedError

    def n_rows(self, table: str) -> int:
        raise NotImplementedError

    def mask_featmat(self, table: str) -> Optional[torch.Tensor]:
        """Feature matrix for mask descent; None → the schema's."""
        raise NotImplementedError

    def plan_featmats(self) -> Optional[Dict[str, torch.Tensor]]:
        """Per-table feature matrices for split plans; None → the schema's."""
        raise NotImplementedError


def _keep(masks, extra, tn):
    return masks[tn] if extra is None else masks[tn] & extra[tn]


class DirectEngine(QueryEngine):
    """The paper's execution model: one batched SumProd pass per query
    family over the static schema."""

    analytic_edges = True

    def bind(self, booster) -> None:
        schema = booster.schema
        self.schema = schema
        self.sp = booster.sp
        self.c3 = booster.c3
        self.sem = booster.sem
        lbl = schema.labels
        self._c3_base = {}
        for t in schema.tables:
            if t.name == schema.label_table:
                self._c3_base[t.name] = torch.stack(
                    [torch.ones_like(lbl), lbl, torch.square(lbl)], dim=-1)
            else:
                self._c3_base[t.name] = self.c3.ones((t.n_rows,), device=schema.device)
        # unweighted monomial factors (weights applied per query by linearity)
        self._sk_base = sketch_factors(schema, self.sem, booster.hashes,
                                       schema.label_table, torch.ones_like(lbl))
        self._sk_label = dict(self._sk_base)
        self._sk_label[schema.label_table] = self.sem.scale(
            self._sk_base[schema.label_table], lbl)

    def grouped_c3(self, table, masks, extra=None):
        f = {tn: self.c3.mask(self._c3_base[tn], _keep(masks, extra, tn)) for tn in masks}
        return self.sp(self.c3, f, group_by=table)

    def grouped_count_pair(self, table, masks, extra_a, extra_b):
        ar = Arithmetic()
        f = {tn: (masks[tn] & extra_a[tn] & extra_b[tn]).to(torch.float32) for tn in masks}
        return self.sp(ar, f, group_by=table)

    def grouped_sketch(self, table, masks, extra=None, labeled=False):
        base = self._sk_label if labeled else self._sk_base
        f = {tn: self.sem.mask(base[tn], _keep(masks, extra, tn)) for tn in masks}
        return self.sp(self.sem, f, group_by=table)

    def n_rows(self, table):
        return self.schema.table(table).n_rows

    def mask_featmat(self, table):
        return None

    def plan_featmats(self):
        return None
