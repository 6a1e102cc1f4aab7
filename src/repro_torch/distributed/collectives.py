"""Data-parallel SumProd in its explicit form: the paper's inside-out pass
over row-sharded tables, every table sharded.

Each table is padded to a multiple of the world size with ⊕-zero rows
whose key id is 0 (they add the semiring zero to key 0's segment, which
changes nothing), and each rank holds one row block of every factor and
key-id array.  Each edge runs a local segment-⊕ of its child's block
into the dense key-domain message, then one all-reduce with the
semiring's ⊕ (``spmd.psum_message``): the key-domain message is the ONLY
cross-rank traffic, and factor rows never move.  The grouped result is
gathered and trimmed.

Bandwidth: per edge per query, |key domain| × |semiring value| bytes
all-reduced, independent of the row count.  ``core/sumprod.py`` runs the
same pass under the layout rule instead (a table that does not divide
stays whole, with no collective on its edges); this module is the
reference that pads everything.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..core.schema import Schema
from ..core.semiring import Semiring
from ..core.sumprod import SumProd
from ..kernels.segment_sum import Segments
from . import spmd


class ShardedSumProd:
    """Row-sharded inside-out pass over every table of ``schema`` on
    ``mesh`` (a :class:`~repro_torch.distributed.spmd.DataMesh`); the
    per-rank CSRs of each root's edges are built once."""

    def __init__(self, schema: Schema, mesh: spmd.DataMesh):
        self.schema = schema
        self.mesh = mesh
        self.n_shards = mesh.size
        self._plans: Dict[str, List[Tuple[Segments, torch.Tensor]]] = {}

    def _block(self, x: torch.Tensor, pad_value) -> torch.Tensor:
        """This rank's row block of ``x`` padded to a multiple of the
        shard count with ``pad_value`` rows (a tensor of one row)."""
        pad = (-x.shape[0]) % self.n_shards
        if pad:
            x = torch.cat([x, pad_value.expand((pad,) + tuple(x.shape[1:])).to(x.dtype)])
        b = x.shape[0] // self.n_shards
        return x[self.mesh.rank * b:(self.mesh.rank + 1) * b]

    def _plan(self, group_by: str) -> List[Tuple[Segments, torch.Tensor]]:
        if group_by not in self._plans:
            zero = torch.zeros((1,), dtype=torch.int64, device=self.schema.device)
            self._plans[group_by] = [
                (Segments.from_tensor(self._block(e.child_ids, zero).clone(), e.n_keys),
                 self._block(e.parent_ids, zero))
                for e in self.schema.join_tree(group_by).edges]
        return self._plans[group_by]

    def __call__(self, sem: Semiring, factors: Dict[str, torch.Tensor],
                 group_by: str) -> torch.Tensor:
        """Grouped query from whole ``factors`` (n_rows, *value_shape);
        returns the rows of ``group_by``, whole on every rank."""
        names = self.schema.names
        zero = sem.zeros((1,), device=self.schema.device)
        f = {tn: self._block(x, zero) for tn, x in factors.items()}
        jt = self.schema.join_tree(group_by)
        for e, (seg, parent_ids) in zip(jt.edges, self._plan(group_by)):
            msg = spmd.psum_message(sem.segment_add(f[names[e.child]], seg),
                                    sem.all_reduce_op, self.mesh)
            f[names[e.parent]] = sem.mul(f[names[e.parent]],
                                         msg.index_select(sem.row_dim(msg), parent_ids))
        out = spmd.replicate(f[group_by], self.mesh)
        return out[: self.schema.table(group_by).n_rows]


def reference_matches(schema: Schema, sem: Semiring, factors, group_by: str,
                      mesh: spmd.DataMesh):
    """Test helper: (sharded, one-process) results of the same query."""
    sharded = ShardedSumProd(schema, mesh)(sem, factors, group_by)
    with spmd.use_data_mesh(None):
        plain = SumProd(schema)(sem, factors, group_by=group_by)
    return sharded, plain
