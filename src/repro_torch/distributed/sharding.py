"""Logical-axis placement rules → DTensor placements for every parameter,
optimizer-state, batch and cache leaf (the reference's
``distributed/sharding.py``), and the gather that lets a placed step run
every block on plain local tensors.

Logical axes, the reference's:
  fsdp — parameter and optimizer sharding (ZeRO-3 style): ("pod", "data")
         on the multi-pod mesh, ("data",) on one pod.
  tp   — tensor parallel (heads, d_ff, vocab): "model".
  dp   — the batch: ("pod", "data").

The rules match a leaf's path by regex and give a logical axis per
trailing dimension; a leading layer axis is never sharded, and a
dimension is sharded only where the axes' total size divides it (GQA's
few K/V heads against tp = 16 stay whole).  A *spec* is the port's
PartitionSpec: a tuple with one entry per tensor dimension, each None, a
mesh axis name or a tuple of axis names (that dimension split over those
mesh dimensions, the first the major one).  :func:`to_placements` turns a
spec into DTensor placements, one per mesh dimension: ``Shard(d)`` where
tensor dimension d lists that axis, else ``Replicate()``; a tuple's axes
must come in the mesh's order, which is how DTensor splits one dimension
over two mesh dimensions.  The rule functions take a
``torch.distributed.device_mesh.DeviceMesh`` or an :class:`AbstractMesh`
(names and sizes, no process group), as the reference's take
``jax.sharding.AbstractMesh``.

Paths are a leaf's keys joined by "/" in the reference's pytree order, as
its ``_path_str`` makes them.  The port's stacked parameter tree
(``models.stack_layers``) has the reference's names ("layers/attn/wq",
the leading L axis never sharded), and so does its optimizer state.  The
port's decode cache holds a list of per-layer dicts ("layers/3/k"), where
the reference stacks a scan kind's layers over a leading L axis
("layers/k"): the rules match a path's end, so a per-layer leaf's spec is
the reference's less its leading None.  The port's encoder–decoder cache
also holds each layer's cross-attention k, v ("layers/3/xk"), which the
reference recomputes every step: their rows over dp as the self-attention
k, v's, their K/V heads over tp (where tp divides them), as the
tensor-parallel cross-attention computes them.

How a placed step computes (``launch/steps.py``): the parameters, AdamW's
moments and the batch are DTensors; a block reads its leaves through
:func:`take`, which gathers each :class:`Placed` leaf (:class:`_Gather`),
so every kernel sees plain tensors and the peak holds one block's
weights, as FSDP does; each dp rank computes on its own rows.  Without
tensor parallelism a leaf is gathered whole and the ranks of one tp group
compute the same rows.  With it (any config on a mesh whose "model" axis
has more than one rank: ``distributed/tp.py``),
:func:`wrap`'s ``tp`` names the leaves that keep their shard over "model"
(the block computes on the rank's heads, d_ff, experts and vocab slice)
and the others are gathered over every axis.  The gather's backward reduces explicitly: the
rank's gradient of the gathered tensor is summed over the dp ranks (each
dp rank's own rows gave it) and, under tensor parallelism, over the tp
ranks where the block read the leaf whole over tp (each tp rank's own
sequence slice or heads gave it: the norm scales, ``wk``, ``wv``, the
meta tokens, a hybrid block's ``bn_a``, ``bn_s`` and the SSM's ``wdt``,
``dt_bias``, ``A_log`` and ``Dskip``), and
brought back to the leaf's placement (reduce-scatter where an axis
summed over shards the leaf, all-reduce where it replicates it).
DTensor's own backward of ``full_tensor()`` takes the local slice
without the sum.  A cache leaf is gathered over its tp axes only (its
rows stay the rank's own), or not at all under tensor parallelism (the
rank keeps its slots).  On a gloo mesh (the CPU, or two ranks sharing
one card) a redistribution runs one mesh dimension at a time through the
host transport of ``distributed/tp.py``.  :func:`constrain` is the
reference's activation constraint: a DTensor is redistributed to the
logical spec's placements on the active mesh (:func:`use_mesh`); a plain
tensor, a rank's own rows in a placed step, passes unchanged, as does
anything outside a mesh or on a mesh of one.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from ..tree import leaves, paths, unflatten
from . import tp as TP

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

# (path regex, logical spec per trailing dim): the reference's table
_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r"embed/tok$",                    ("tp", "fsdp")),
    (r"embed/head$",                   ("fsdp", "tp")),
    (r"attn/wq$|attn/wk$|attn/wv$",    ("fsdp", "tp")),
    (r"attn/wo$",                      ("tp", "fsdp")),
    (r"attn/b[qkv]$",                  ("tp",)),
    (r"xattn/wq$|xattn/wk$|xattn/wv$", ("fsdp", "tp")),
    (r"xattn/wo$",                     ("tp", "fsdp")),
    (r"xattn/b[qkv]$",                 ("tp",)),
    (r"mlp/w_gate$|mlp/w_up$",         ("fsdp", "tp")),
    (r"mlp/w_down$",                   ("tp", "fsdp")),
    (r"moe/router$",                   ("fsdp", None)),
    (r"moe/w_gate$|moe/w_up$",         ("tp", "fsdp", None)),   # experts on tp (EP)
    (r"moe/w_down$",                   ("tp", None, "fsdp")),
    (r"shared/w_gate$|shared/w_up$",   ("fsdp", "tp")),
    (r"shared/w_down$",                ("tp", "fsdp")),
    (r"mix/w[rkvg]$|mix/cr$",          ("fsdp", "tp")),
    (r"mix/wo$|mix/cv$",               ("tp", "fsdp")),
    (r"mix/ck$",                       ("fsdp", "tp")),
    (r"mix/wA$",                       ("fsdp", None)),
    (r"mix/wB$",                       (None, "tp")),
    (r"ssm/wx$|ssm/wB$|ssm/wC$",       ("fsdp", "tp")),
    (r"ssm/wdt$",                      ("fsdp", None)),
    (r"ssm/wo$",                       ("tp", "fsdp")),
    (r"ssm/conv$",                     (None, "tp")),
    (r"meta$",                         (None, None)),
]

# the reference's cache table (trailing dims), and the port's cross-attention k, v
_CACHE_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r"/k$|/v$",           ("dp", "tp", None, None)),    # (B, span, Kh, dh)
    (r"/x[kv]$",           ("dp", None, "tp", None)),    # (B, Se, Kh, dh), the port's
    (r"/kpos$",            ("dp", "tp")),                # (B, span)
    (r"/S$",               ("dp", "tp", None, None)),    # rwkv (B, H, hs, hs)
    (r"x_last_tm$|x_last_cm$", ("dp", "tp")),            # (B, D)
    (r"ssm/h$",            ("dp", "tp", None, None)),    # (B, H, N, P)
    (r"ssm/conv$",         ("dp", None, "tp")),          # (B, 4, d_inner)
    (r"enc_out$",          ("dp", "tp", None)),          # (B, S_src, D)
    (r"enc_pos$",          ("dp", "tp")),
    (r"pos$",              ("dp",)),
]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh axis names and sizes without devices or a process group (the
    reference's ``jax.sharding.AbstractMesh``): enough for the rules."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return math.prod(self.shape) if mesh_dim is None else self.shape[mesh_dim]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the reference's ``NamedSharding``.  ``mesh`` None
    (:data:`UNPLACED`) marks a leaf that stays a plain tensor, whole on
    every rank (a host scalar, the compressor's state)."""
    mesh: Any
    spec: Spec = ()

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return to_placements(self.mesh, self.spec)


UNPLACED = NamedSharding(None)


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axes(mesh) -> Dict[str, Tuple[str, ...]]:
    """The logical axes' mesh axes on ``mesh``."""
    names = mesh.mesh_dim_names
    fsdp = tuple(n for n in ("pod", "data") if n in names)
    tp = ("model",) if "model" in names else ()
    return {"fsdp": fsdp, "dp": fsdp, "tp": tp, "all": fsdp + tp}


def _axis_size(mesh, axes: Tuple[str, ...]) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _entry(axes: Tuple[str, ...]) -> Entry:
    return axes if len(axes) > 1 else axes[0]


def logical_to_spec(mesh, logical: Tuple[Optional[str], ...], shape) -> Spec:
    """Resolve logical axes (the trailing dims') to a spec, a leading dim
    beyond them never sharded, a dim the axes do not divide whole."""
    la = mesh_axes(mesh)
    extra = len(shape) - len(logical)
    out: List[Entry] = [None] * extra
    for dim, name in zip(tuple(shape)[extra:], logical):
        axes = la[name] if name is not None else ()
        out.append(_entry(axes) if axes and dim % _axis_size(mesh, axes) == 0 else None)
    return tuple(out)


def to_placements(mesh, spec: Spec) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec``, one per mesh dimension."""
    names = list(mesh.mesh_dim_names)
    out: List[Placement] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} splits dim {d} over mesh axes out of the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def path_strings(tree) -> List[str]:
    """Each leaf's path, keys joined by "/" (the reference's ``_path_str``)."""
    return [p.replace(".", "/") for p in paths(tree)]


def _by_rules(rules, mesh, tree) -> Any:
    """The first matching rule's spec for each leaf (its global shape), else
    replicated."""
    out = []
    for ps, leaf in zip(path_strings(tree), leaves(tree)):
        spec: Spec = ()
        for pat, logical in rules:
            if re.search(pat, ps):
                spec = logical_to_spec(mesh, logical, leaf.shape)
                break
        out.append(NamedSharding(mesh, spec))
    return unflatten(tree, out)


def param_shardings(mesh, params) -> Any:
    """A :class:`NamedSharding` per leaf of a parameter tree (global
    shapes); norms and scalars replicated."""
    return _by_rules(_RULES, mesh, params)


def batch_shardings(mesh, batch) -> Any:
    """A batch's leaves: the leading (global batch) dim over dp where dp
    divides it, else replicated."""
    dp = mesh_axes(mesh)["dp"]

    def one(leaf):
        ok = dp and leaf.shape[0] % _axis_size(mesh, dp) == 0
        return NamedSharding(mesh, (_entry(dp),) if ok else ())
    return unflatten(batch, [one(x) for x in leaves(batch)])


def cache_shardings(mesh, cache) -> Any:
    """A decode cache's leaves (the port's per-layer lists)."""
    return _by_rules(_CACHE_RULES, mesh, cache)


def replicated(mesh, tree) -> Any:
    return unflatten(tree, [NamedSharding(mesh) for _ in leaves(tree)])


def opt_shardings(mesh, pshard, opt_state) -> Any:
    """AdamW's state placed as the reference's dry run places it: the
    moments as the parameters; the step count, a host scalar, unplaced.
    A float32 master copy, where kept, is placed as the parameters too
    (the reference replicates it; the port's AdamW updates local shards)."""
    return type(opt_state)(step=UNPLACED, m=pshard, v=pshard,
                           master=pshard if leaves(opt_state.master) else ())


# ------------------------------------------------------------- placement --
def shard_slices(shape, mesh, placements) -> Tuple[slice, ...]:
    """This rank's slice of a global ``shape`` under ``placements``."""
    local, offset = compute_local_shape_and_global_offset(tuple(shape), mesh, placements)
    return tuple(slice(o, o + n) for o, n in zip(offset, local))


def place(tree, shardings) -> Any:
    """``tree``'s whole tensors (the same on every rank, e.g. made from one
    seed) as DTensors: each rank keeps a copy of its own slice (the tensor
    itself where its slice is all of it), no collective.  A leaf under
    :data:`UNPLACED` stays as it is."""
    out = []
    for t, sh in zip(leaves(tree), leaves(shardings)):
        if sh.mesh is None:
            out.append(t)
            continue
        pl = sh.placements
        sl = shard_slices(t.shape, sh.mesh, pl)
        whole = all(s.stop - s.start == n for s, n in zip(sl, t.shape))
        local = t if whole else t[sl].clone()
        out.append(DTensor.from_local(local, sh.mesh, pl, run_check=False, shape=t.shape,
                                      stride=contiguous_stride(t.shape)))
    return unflatten(tree, out)


def contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def local(tree) -> Any:
    """Each DTensor leaf's local tensor (the same storage); other leaves
    as they are."""
    return unflatten(tree, [t.to_local() if isinstance(t, DTensor) else t
                            for t in leaves(tree)])


def is_placed(tree) -> bool:
    return any(isinstance(t, DTensor) for t in leaves(tree))


def is_whole(t: DTensor) -> bool:
    """True where ``t``'s local tensor is the whole tensor (no mesh
    dimension of more than one rank splits it)."""
    return all(not p.is_shard() or t.device_mesh.size(i) == 1
               for i, p in enumerate(t.placements))


def gathered(tree) -> Any:
    """Each DTensor leaf whole (a collective every rank calls, on the host
    on a gloo mesh; the local tensor itself where it is whole already, so
    an in-place update of the result updates the leaf); other leaves as
    they are."""
    def one(t):
        if not isinstance(t, DTensor):
            return t
        if is_whole(t):
            return t.to_local()
        mesh = t.device_mesh
        if not TP.on_host(mesh):
            return t.full_tensor()
        return redistribute(t.to_local(), mesh, t.placements, (Replicate(),) * mesh.ndim)
    return unflatten(tree, [one(t) for t in leaves(tree)])


def redistribute(local: torch.Tensor, mesh, placements, target) -> torch.Tensor:
    """This rank's tensor of ``local`` (placed as ``placements``, which may
    hold ``Partial``) redistributed to ``target``: by DTensor, or on a gloo
    mesh by :func:`_by_axis` (the host transport of ``distributed/tp.py``)."""
    if tuple(placements) == tuple(target):
        return local
    if TP.on_host(mesh):
        return _by_axis(local, mesh, placements, target)
    return DTensor.from_local(local, mesh, placements, run_check=False).redistribute(
        mesh, target).to_local()


def _by_axis(t: torch.Tensor, mesh, placements, target) -> torch.Tensor:
    """:func:`redistribute` one mesh dimension at a time by tp's
    collectives: ``Shard(d)`` → ``Replicate`` an all-gather, the inner mesh
    dimension first (a tensor dimension split over several mesh dimensions
    is split major first); then ``Partial`` → ``Replicate`` an all-reduce,
    ``Partial`` → ``Shard(d)`` a reduce-scatter and ``Replicate`` →
    ``Shard(d)`` a local slice, the major mesh dimension first.  Every sum
    is in rank order, so every rank gets the same bits."""
    moves = [(i, p, q) for i, (p, q) in enumerate(zip(placements, target))
             if p != q and mesh.size(i) > 1]
    for i, p, q in reversed(moves):
        if p.is_shard():
            if not q.is_replicate():
                raise ValueError(f"no move from {p} to {q} on mesh dimension {i}")
            t = TP.gather(t, TP.axis(mesh, i), p.dim)
    for i, p, q in moves:
        if p.is_shard():
            continue
        ax = TP.axis(mesh, i)
        if p.is_partial():
            t = TP.reduce_scatter(t, ax, q.dim) if q.is_shard() else TP.reduce(t, ax)
        elif q.is_shard():
            t = TP.local_slice(t, ax, q.dim).contiguous()
        else:
            raise ValueError(f"no move from {p} to {q} on mesh dimension {i}")
    return t


# ----------------------------------------------------------------- gather --
@dataclasses.dataclass(frozen=True)
class Placed:
    """A rank's local tensor of a leaf and how to gather it: its mesh, its
    placements and the placements to gather to (``target``); ``tp_partial``:
    its gradient is partial over tp where ``target`` replicates it over tp
    (tensor parallelism, module docstring)."""
    local: torch.Tensor
    mesh: Any
    placements: Tuple[Placement, ...]
    target: Tuple[Placement, ...]
    tp_partial: bool = False

    @property
    def shape(self) -> torch.Size:
        """The gathered tensor's shape."""
        size = list(self.local.shape)
        for i, (p, t) in enumerate(zip(self.placements, self.target)):
            if p.is_shard() and not t.is_shard():
                size[p.dim] *= self.mesh.size(i)
        return torch.Size(size)


def wrap(local_tree, shardings, keep_rows: bool = False, tp=None) -> Any:
    """``local_tree``'s tensors as :class:`Placed` leaves under
    ``shardings``, gathered whole on :func:`take`, or with ``keep_rows``
    over every axis but dp (a cache: the rows stay the rank's own).
    ``tp``: tensor parallelism (a predicate on a leaf's path, True where
    the leaf keeps its shard over "model"; module docstring).  A leaf
    stays plain where that gather and its gradient's reduction move
    nothing: where no mesh dimension of more than one rank splits it (to
    gather) or, for a parameter, is an axis to sum its gradient over (dp;
    tp where it is read whole over tp), as on a mesh of one."""
    mesh = next((s.mesh for s in leaves(shardings) if s.mesh is not None), None)
    dp = set(mesh_axes(mesh)["dp"]) if mesh is not None else set()
    out = []
    for path, t, sh in zip(path_strings(local_tree), leaves(local_tree), leaves(shardings)):
        if sh.mesh is None:
            out.append(t)
            continue
        pl = sh.placements
        names = sh.mesh.mesh_dim_names
        keep = tp is not None and tp(path)
        target = tuple(p if (keep_rows and n in dp) or (keep and n == TP.TP_AXIS) else Replicate()
                       for p, n in zip(pl, names))
        partial = tp is not None
        moves = any(sh.mesh.size(i) > 1 and (
            p != q or (not keep_rows and n in dp)
            or (partial and n == TP.TP_AXIS and not q.is_shard()))
            for i, (p, q, n) in enumerate(zip(pl, target, names)))
        out.append(Placed(t, sh.mesh, pl, target, partial) if moves else t)
    return unflatten(local_tree, out)


def take(tree) -> Any:
    """``tree`` with every :class:`Placed` leaf gathered (differentiably:
    :class:`_Gather`); plain leaves as they are."""
    if isinstance(tree, Placed):
        return _Gather.apply(tree.local, tree.mesh, tree.placements, tree.target,
                             tree.tp_partial)
    if isinstance(tree, dict):
        return {k: take(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [take(v) for v in tree]
    return tree


class _Gather(torch.autograd.Function):
    """Forward: ``local`` gathered from ``placements`` to ``target``.
    Backward: this rank's gradient of the gathered tensor, summed over the
    dp ranks where ``target`` gathered a dp axis (each dp rank's own rows
    gave it) and, with ``tp_partial``, over the tp ranks where ``target``
    replicates it over tp, and sliced back to ``placements``: a
    reduce-scatter, an all-reduce or a local slice, by DTensor's
    redistribution from ``Partial`` over the summed axes and ``Replicate``
    over the others."""

    @staticmethod
    def forward(ctx, local, mesh, placements, target, tp_partial=False):
        ctx.mesh, ctx.placements, ctx.target = mesh, placements, target
        ctx.tp_partial = tp_partial
        return redistribute(local.detach(), mesh, placements, target)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        summed = set(mesh_axes(mesh)["dp"]) | ({TP.TP_AXIS} if ctx.tp_partial else set())
        src = tuple(t if t.is_shard() else
                    (Partial() if name in summed and mesh.size(i) > 1 else Replicate())
                    for i, (t, name) in enumerate(zip(ctx.target, mesh.mesh_dim_names)))
        return redistribute(grad.contiguous(), mesh, src, ctx.placements), None, None, None, None


# -------------------------------------------------------------- the mesh --
_ACTIVE: contextvars.ContextVar[Optional[Any]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Make ``mesh`` the active mesh of this thread (the reference's ``with
    mesh:``) for :func:`constrain`."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def constrain(x, *logical: Optional[str]):
    """The reference's activation constraint by logical axis names: a
    DTensor on the active mesh is redistributed to the spec's placements;
    outside a mesh, on a mesh of one, and for a plain tensor (a rank's own
    rows, module docstring) it is a no-op."""
    mesh = _ACTIVE.get()
    if mesh is None or mesh.size() == 1 or not isinstance(x, DTensor):
        return x
    spec = logical_to_spec(mesh, tuple(logical), x.shape[:len(logical)])
    return x.redistribute(mesh, to_placements(mesh, spec))
