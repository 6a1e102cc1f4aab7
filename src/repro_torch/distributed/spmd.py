"""Data-parallel layer of the relational engine over a process group.

A :class:`DataMesh` is a 1-D ("data",) mesh: the ranks of a
``torch.distributed`` process group, one row block of every shardable
table on each (``launch.mesh.make_data_mesh`` builds it).  The layout
rule, one for every tensor with a row axis:

  factor   (n_rows, *value_shape)  rows sharded
  mask     (..., n_rows)           rows sharded (row_axis=-1)
  message  (n_keys, *value_shape)  replicated

A row axis is sharded only when the world size divides it; otherwise the
tensor stays replicated, whole on every rank (small dimension tables
replicate, which is what you want: their messages are cheap).  A torch
tensor carries no placement, so "sharded" means the tensor a rank holds
IS its contiguous row block ``[rank·n/W, (rank+1)·n/W)``, and an
untouched tensor means replicated; :func:`shards` is the rule, and every
layer that holds row data decides with it.

The collective point is :func:`psum_message`: per-edge segment-⊕
messages are computed on row blocks and all-reduced with the semiring's
⊕ (sum, min for Tropical, max on a uint8 view for Boolean).  Everything
downstream of a message is replicated, so split sweeps and tree
construction run on every rank with the control flow of one process;
grouped outputs of a sharded table come back whole through
:func:`replicate`, an all-gather of the equal row blocks.

Bit-equality: the cross-rank combine re-associates the ⊕ reduction.
For integer-valued float32 payloads (leaf-mask counts — the whole
serving path — and training statistics of labels on a dyadic grid)
every partial sum is exact, so sharded equals one process bit for bit.
Complex payloads (the frequency-domain sketch monomials) are never
sharded: their partial sums are not exact, so sketch queries run
whole on every rank while the count and statistic queries around them
run on row blocks.

The active mesh is per thread (a ``ContextVar``): objects that outlive a
call (``CompiledEnsemble``, ``DirectEngine``, ``MaintainedScorer``,
``MaintainedEngine``) capture it when built and re-enter it themselves.
With the gloo backend a CUDA tensor is staged through the host for each
collective.  ``spmd.all_reduce_ms`` / ``spmd.all_gather_ms`` (host clock
around a collective, after a synchronise when it stages) and their
``*_bytes`` counters go to the metrics registry.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..kernels.segment_sum import Segments
from ..obs import get_registry, span


@dataclasses.dataclass(eq=False)
class DataMesh:
    """The ranks of a process group as a 1-D ("data",) mesh.  ``group``
    None is the default group.  Holds the per-rank block CSRs built for
    it (:func:`local_segments`)."""

    size: int
    rank: int = 0
    group: Optional[object] = None
    backend: Optional[str] = None
    blocks: Dict[int, Segments] = dataclasses.field(default_factory=dict, repr=False)

    axis_names = ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size}


_ACTIVE: contextvars.ContextVar[Optional[DataMesh]] = contextvars.ContextVar(
    "repro_torch_data_mesh", default=None)

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def current_data_mesh() -> Optional[DataMesh]:
    """This thread's active data mesh, or None (one-process semantics)."""
    return _ACTIVE.get()


def _resolve(mesh: Optional[DataMesh]) -> Optional[DataMesh]:
    """The effective mesh: ``mesh``, else the active one; a mesh of one
    rank resolves to None, which makes every helper an identity."""
    m = mesh if mesh is not None else _ACTIVE.get()
    if m is None or m.size <= 1:
        return None
    return m


def data_axis_size(mesh: Optional[DataMesh] = None) -> int:
    """Number of row blocks (1 when no mesh is active)."""
    m = _resolve(mesh)
    return 1 if m is None else m.size


@contextlib.contextmanager
def use_data_mesh(mesh: Optional[DataMesh]):
    """Make ``mesh`` this thread's active data mesh for the block;
    ``use_data_mesh(None)`` clears it (one-process semantics)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def shards(rows: int, dtype: torch.dtype, mesh: Optional[DataMesh] = None) -> bool:
    """The layout rule: an axis of ``rows`` holding ``dtype`` is sharded
    iff a mesh is active, the world size divides ``rows`` and the payload
    is not complex."""
    m = _resolve(mesh)
    return m is not None and not dtype.is_complex and rows % m.size == 0


def _block(rows: int, m: DataMesh):
    b = rows // m.size
    return m.rank * b, b


def shard_rows(x: torch.Tensor, mesh: Optional[DataMesh] = None, row_axis: int = 0,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's row block of the whole tensor ``x`` (a copy), or ``x``
    itself where the rule keeps it replicated.  ``dtype`` names the
    payload the rule judges when it is not ``x``'s own (a mask of a
    complex factor stays whole like the factor)."""
    m = _resolve(mesh)
    ra = row_axis % x.dim()
    if m is None or not shards(x.shape[ra], dtype or x.dtype, m):
        return x
    lo, b = _block(x.shape[ra], m)
    return x.narrow(ra, lo, b).clone(memory_format=torch.contiguous_format)


# torch has no trace-time placement hint: constraining IS placing
constrain_rows = shard_rows


def shard_factor(x: torch.Tensor, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """(n_rows, *value_shape) factor: rows sharded, values local."""
    return shard_rows(x, mesh, row_axis=0)


def shard_featmat(x: torch.Tensor, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """(n_rows, d_t) feature matrix, the port's layout: rows sharded."""
    return shard_rows(x, mesh, row_axis=0)


def shard_factors(factors: Dict[str, torch.Tensor],
                  mesh: Optional[DataMesh] = None) -> Dict[str, torch.Tensor]:
    """Shard a {table: factor} dict by rows (each table's own rule)."""
    m = _resolve(mesh)
    if m is None:
        return factors
    return {t: shard_factor(f, m) for t, f in factors.items()}


def replicate_put(x: torch.Tensor, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """A tensor every rank holds whole is replicated: the identity."""
    return x


def _staged(x: torch.Tensor, m: DataMesh) -> bool:
    """gloo runs a CUDA tensor's collective through the host."""
    if m.backend == "gloo" and x.is_cuda:
        torch.cuda.synchronize(x.device)
        return True
    return False


def psum_message(x: torch.Tensor, op: str = "sum",
                 mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """THE collective point: all-reduce a per-edge message (or an
    ungrouped result) computed on row blocks, with the semiring's ⊕
    named by ``op`` ("sum", "min" or "max"; a bool message is reduced
    as uint8, gloo having no bool).  Identity when no mesh is active."""
    m = _resolve(mesh)
    if m is None:
        return x
    buf = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    stage = _staged(buf, m)
    nbytes = buf.numel() * buf.element_size()
    with span("spmd.all_reduce", bytes=nbytes, op=op):
        t0 = time.perf_counter()
        work = buf.cpu() if stage else buf
        dist.all_reduce(work, op=_OPS[op], group=m.group)
        out = work.to(buf.device) if stage else work
        dt = time.perf_counter() - t0
    reg = get_registry()
    reg.histogram("spmd.all_reduce_ms").observe(dt * 1e3)
    reg.counter("spmd.all_reduce_bytes").inc(nbytes)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def broadcast_object(obj, mesh: Optional[DataMesh] = None):
    """``obj`` (any picklable value) from the mesh's rank 0 to every rank:
    a collective every rank calls, the others passing anything (None).
    Identity when no mesh is active."""
    m = _resolve(mesh)
    if m is None:
        return obj
    box = [obj]
    src = 0 if m.group is None else dist.get_global_rank(m.group, 0)
    with span("spmd.broadcast"):
        t0 = time.perf_counter()
        dist.broadcast_object_list(box, src=src, group=m.group)
        dt = time.perf_counter() - t0
    get_registry().histogram("spmd.broadcast_ms").observe(dt * 1e3)
    return box[0]


def replicate(x: torch.Tensor, mesh: Optional[DataMesh] = None, row_axis: int = 0,
              rows: Optional[int] = None) -> torch.Tensor:
    """The whole tensor from this rank's row block: an all-gather of the
    equal blocks along ``row_axis``.  With ``rows`` (the axis's whole
    length) a tensor that already has them is returned as it is, so a
    caller need not know which rule placed it.  Identity when no mesh is
    active."""
    m = _resolve(mesh)
    if m is None:
        return x
    ra = row_axis % x.dim()
    if rows is not None:
        if x.shape[ra] == rows:
            return x
        if x.shape[ra] * m.size != rows:
            raise ValueError(f"{x.shape[ra]} rows are neither the whole {rows} nor a "
                             f"block of it over {m.size} ranks")
    buf = x.movedim(ra, 0).contiguous()
    stage = _staged(buf, m)
    nbytes = buf.numel() * buf.element_size() * m.size
    with span("spmd.all_gather", bytes=nbytes):
        t0 = time.perf_counter()
        work = buf.cpu() if stage else buf
        parts = [torch.empty_like(work) for _ in range(m.size)]
        dist.all_gather(parts, work, group=m.group)
        out = torch.cat(parts)
        out = out.to(buf.device) if stage else out
        dt = time.perf_counter() - t0
    reg = get_registry()
    reg.histogram("spmd.all_gather_ms").observe(dt * 1e3)
    reg.counter("spmd.all_gather_bytes").inc(nbytes)
    # contiguous: a strided result would change the order of later reductions
    return out.movedim(0, ra).contiguous()


def local_segments(seg: Segments, mesh: Optional[DataMesh] = None) -> Segments:
    """The CSR of this rank's block of ``seg``'s rows, against the same
    ``n_keys``: what a segment-⊕ over a row block walks.  Built once per
    CSR object and mesh (``seg``'s lifetime bounds the cache entry)."""
    m = _resolve(mesh)
    if m is None:
        return seg
    key = id(seg)
    hit = m.blocks.get(key)
    if hit is None:
        if seg.n_rows != seg.ids.shape[0] or seg.n_rows % m.size:
            raise ValueError(f"a CSR of {seg.ids.shape[0]} entries over {seg.n_rows} rows "
                             f"has no block layout over {m.size} ranks")
        lo, b = _block(seg.n_rows, m)
        hit = m.blocks[key] = Segments.from_tensor(seg.ids[lo:lo + b].clone(), seg.n_keys)
        weakref.finalize(seg, m.blocks.pop, key, None)
    return hit


def local_range(rows: int, dtype: torch.dtype, mesh: Optional[DataMesh] = None):
    """(lo, hi): the rows of an axis of ``rows`` holding ``dtype`` that
    this rank holds — its block, or all of them where the rule keeps the
    axis replicated."""
    m = _resolve(mesh)
    if m is None or not shards(rows, dtype, m):
        return 0, rows
    lo, b = _block(rows, m)
    return lo, lo + b


def mesh_fingerprint(mesh: Optional[DataMesh] = None) -> Optional[Dict[str, int]]:
    """{axis: size} for run records; None when unsharded."""
    m = _resolve(mesh)
    return None if m is None else dict(m.shape)


def is_row_sharded(x: torch.Tensor, mesh: Optional[DataMesh] = None, row_axis: int = 0,
                   *, rows: int) -> bool:
    """True iff ``x`` is this rank's row block of an axis of ``rows``
    rows.  A torch tensor carries no placement, so the answer comes from
    the rule and ``x``'s row count."""
    m = _resolve(mesh)
    if m is None:
        return False
    ra = row_axis % x.dim()
    return shards(rows, x.dtype, m) and x.shape[ra] * m.size == rows
