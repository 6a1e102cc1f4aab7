"""Compile a trained ensemble into a one-pass relational scorer.

The per-leaf scoring path walks tree × leaf and issues one Arithmetic
SumProd pass per leaf per tree — O(n_trees · L) inside-out passes per
request.  Compilation stacks **every leaf of every tree** into one
channel axis instead.

For each table T_t the per-leaf membership masks (L, n_rows) of all
trees concatenate into a single (total_leaves, n_rows) array; its
transpose, cast to ``factor_dtype``, is T_t's factor in a
``Channels(total_leaves)`` product semiring.  ONE inside-out pass
grouped by ρ's table then yields

    counts[ρ, a] = |{x ∈ ρ ⋈ J : x in leaf a}|        (all a at once)

and the served quantities are two dense contractions:

    Σŷ[ρ]  = counts[ρ, :] @ leaf_values                 (boosted sum)
    |ρ⋈J|  = Σ_{a ∈ leaves of tree 0} counts[ρ, a]      (any one tree
              partitions J, so its leaf counts sum to the group size)

SumProd evaluations per request drop from n_trees·L + 1 to **1**; the
wide segment-⊕ that remains is a (n_rows, total_leaves) segment sum,
which on CUDA runs the segment-⊕ kernel (``kernels/segment_sum``).

Under a data mesh the ensemble holds its factors as row blocks
(``spmd.shard_factors``); a grouped pass contracts the local rows and
replicates (Σŷ, count).  ``contract`` is row-local, so the bits do not
depend on the blocking, and leaf-mask counts are integers, exact under
the cross-rank sums: the scores equal one process's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..core.schema import Schema
from ..core.semiring import Channels
from ..core.sumprod import QueryCounter, SumProd
from ..core.tree import TreeArrays, leaf_masks
from ..distributed import spmd


def stack_table_factor(schema: Schema, trees: List[TreeArrays], table: str,
                       featmat: Optional[torch.Tensor] = None,
                       dtype=torch.float32) -> torch.Tensor:
    """Stacked leaf-mask factor for one table: (n_rows, total_leaves).

    With ``featmat`` (k, d_t), only those k feature rows are evaluated."""
    per_tree = [leaf_masks(schema, table, t, featmat=featmat) for t in trees]
    return torch.cat(per_tree, dim=0).T.to(dtype).contiguous()


def contract(counts: torch.Tensor, leaf_values: torch.Tensor, tree0_leaves: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σŷ, |ρ⋈J|) per row from grouped leaf counts (n_g, A).

    The leaf axis contracts as an explicitly sequenced chain: each output
    row reads only its own counts row in a fixed order, so the bits do
    not depend on how the rows are blocked or how many there are (a
    maintained scorer's capacity-shaped counts and a fresh compile's
    give the same bits row for row)."""
    counts = counts.to(torch.float32)         # bf16 counts contract in f32
    tot = counts[:, 0] * leaf_values[0]
    for j in range(1, int(leaf_values.shape[0])):
        tot = tot + counts[:, j] * leaf_values[j]
    # integer-valued counts: exact in f32 in any association order
    cnt = torch.sum(counts[:, :tree0_leaves], dim=1)
    return tot.to(torch.float32), cnt.to(torch.float32)


@dataclasses.dataclass
class CompiledEnsemble:
    """A trained ensemble lowered to single-pass relational scoring.

    factors: per-table (n_rows, total_leaves) stacked leaf masks, ready to
    drop into a Channels(total_leaves) SumProd query.  ``factor_dtype``
    is float32 (exact counts) or bfloat16 (masks are 0/1, so bf16 halves
    factor memory; the kernel accumulates in float32 and the counts are
    rounded to bf16's 8-bit mantissa when cast back).

    ``use_kernel`` is kept for signature parity with the JAX package: on
    CUDA every segment-⊕ runs the segment-⊕ kernel whatever its value,
    and on the CPU the plain version runs.

    ``data_version`` is bumped by whoever mutates served state in place;
    caches keyed on it never serve stale scores.

    ``mesh``: the data mesh the factors are sharded over (None: one
    process).  Every score re-enters it; under a mesh of more than one
    rank, :meth:`score_grouped` is a collective that every rank must
    call, so a server fills ``grouped_cached`` on every rank before it
    takes traffic.
    """

    schema: Schema
    trees: List[TreeArrays]
    leaf_values: torch.Tensor              # (total_leaves,)
    factors: Dict[str, torch.Tensor]       # table → (n_rows, total_leaves)
    tree0_leaves: int                      # leaves of tree 0 (for counts)
    use_kernel: bool = False
    counter: Optional[QueryCounter] = None
    factor_dtype: torch.dtype = torch.float32
    data_version: int = 0
    mesh: Optional[spmd.DataMesh] = None

    def __post_init__(self):
        self._sp = SumProd(self.schema)
        self._sem = Channels(self.total_leaves, self.factor_dtype)
        self._grouped: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.factors = spmd.shard_factors(self.factors, self.mesh)

    @property
    def total_leaves(self) -> int:
        return int(self.leaf_values.shape[0])

    @property
    def n_trees(self) -> int:
        return len(self.trees)

    def n_rows(self, table: str) -> int:
        """Row-id domain of ``table``'s factor."""
        return self.schema.table(table).n_rows

    def score_grouped(self, group_by: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Σŷ, |ρ⋈J|) per row of ``group_by`` — ONE SumProd evaluation."""
        if self.counter is not None:
            self.counter.bump(1)
        with spmd.use_data_mesh(self.mesh):
            counts = self._sp(self._sem, self.factors, group_by=group_by)   # (n_g, A)
        rows = self.n_rows(group_by)
        return tuple(spmd.replicate(x, self.mesh, rows=rows)
                     for x in contract(counts, self.leaf_values, self.tree0_leaves))

    def grouped_cached(self, group_by: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """Memoized full-table scores: tables are static per model version,
        so interactive row lookups reduce to gathers into this pass."""
        if group_by not in self._grouped:
            self._grouped[group_by] = self.score_grouped(group_by)
        return self._grouped[group_by]


def compile_ensemble(schema: Schema, trees: List[TreeArrays], use_kernel: bool = False,
                     counter: Optional[QueryCounter] = None,
                     factor_dtype=torch.float32,
                     mesh: Optional[spmd.DataMesh] = None) -> CompiledEnsemble:
    """Stack per-table leaf masks across all trees into channel factors,
    sharded over ``mesh`` (default: the active data mesh).
    ``use_kernel`` has no effect (see :class:`CompiledEnsemble`)."""
    if not trees:
        raise ValueError("cannot compile an empty ensemble")
    factors = {t.name: stack_table_factor(schema, trees, t.name, dtype=factor_dtype)
               for t in schema.tables}
    leaf_values = torch.cat([t.leaf for t in trees]).to(torch.float32)
    return CompiledEnsemble(
        schema=schema, trees=list(trees), leaf_values=leaf_values, factors=factors,
        tree0_leaves=int(trees[0].leaf.shape[0]), use_kernel=use_kernel,
        counter=counter, factor_dtype=factor_dtype,
        mesh=mesh if mesh is not None else spmd.current_data_mesh(),
    )
