"""Batched multi-model scoring: A/B variants in one SumProd pass.

Compiled ensembles over the same schema differ only along the leaf
channel axis, so N variants stack into ONE factor set: per table the
(n_rows, A_m) factors concatenate to (n_rows, ΣA_m), one inside-out
pass yields every model's leaf counts at once (on CUDA each message
emission is one segment-⊕ kernel launch at C = ΣA_m channels), and the
contraction splits per model by slicing the channel axis — N models for
the query cost of one.

Each model's slice contracts through :func:`~repro_torch.serving.compile.contract`,
the code its own ``score_grouped`` runs.  Leaf counts are integer-valued
float32 sums, exact in any order below 2²⁴, so in float32 a stacked
model's (Σŷ, count) equal its own pass bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..core.semiring import Channels
from ..core.sumprod import QueryCounter, SumProd
from .compile import CompiledEnsemble, contract


@dataclasses.dataclass
class StackedEnsembles:
    """N compiled ensembles fused along the leaf channel axis."""

    ensembles: List[CompiledEnsemble]
    factors: Dict[str, torch.Tensor]       # table → (n_rows, ΣA_m)
    leaf_values: torch.Tensor              # (ΣA_m,)
    offsets: List[int]                     # model m spans [off[m], off[m+1])
    counter: Optional[QueryCounter] = None

    def __post_init__(self):
        self.schema = self.ensembles[0].schema
        # the constituents' data_versions at stack time: the stacked factor
        # set is a copy, and its scores belong to exactly these versions
        self.data_versions = tuple(getattr(e, "data_version", 0) for e in self.ensembles)
        self._sp = SumProd(self.schema)
        self._sem = Channels(int(self.leaf_values.shape[0]),
                             self.factors[self.schema.names[0]].dtype)

    @property
    def n_models(self) -> int:
        return len(self.ensembles)

    def score_grouped(self, group_by: str) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per-model [(Σŷ, |ρ⋈J|)] for every row of ``group_by`` — ONE
        SumProd evaluation for all N models."""
        if self.counter is not None:
            self.counter.bump(1)
        counts = self._sp(self._sem, self.factors, group_by=group_by)     # (n_g, ΣA)
        return [contract(counts[:, lo:hi], self.leaf_values[lo:hi], e.tree0_leaves)
                for e, lo, hi in zip(self.ensembles, self.offsets, self.offsets[1:])]


def stack_ensembles(ensembles: List[CompiledEnsemble],
                    counter: Optional[QueryCounter] = None) -> StackedEnsembles:
    """Concatenate N same-schema ensembles' leaf axes into one factor set.

    Refuses a capacity-padded scorer (a ``MaintainedScorer``: its factor
    rows are slots, not the schema's rows) and ensembles over different
    row domains.  The stack is bfloat16 only when every constituent is."""
    if not ensembles:
        raise ValueError("need at least one ensemble to stack")
    sch = ensembles[0].schema
    for e in ensembles:
        bad = [t.name for t in e.schema.tables if e.factors[t.name].shape[0] != t.n_rows]
        if bad:
            raise ValueError(
                f"cannot stack a maintained/padded scorer (factor rows ≠ "
                f"schema rows for {bad}); compile a static snapshot first")
    shape0 = {t: f.shape[0] for t, f in ensembles[0].factors.items()}
    for e in ensembles[1:]:
        if {t: f.shape[0] for t, f in e.factors.items()} != shape0:
            raise ValueError("stacked ensembles must share one schema (factor row "
                             "domains differ)")
    dtype = (torch.bfloat16 if all(e.factor_dtype == torch.bfloat16 for e in ensembles)
             else torch.float32)
    factors = {t.name: torch.cat([e.factors[t.name].to(dtype) for e in ensembles], dim=1)
               for t in sch.tables}
    leaf_values = torch.cat([e.leaf_values for e in ensembles])
    offsets = [0]
    for e in ensembles:
        offsets.append(offsets[-1] + e.total_leaves)
    return StackedEnsembles(ensembles=list(ensembles), factors=factors,
                            leaf_values=leaf_values, offsets=offsets, counter=counter)
