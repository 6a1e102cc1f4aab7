"""Tensor and sequence parallelism over a mesh's "model" axis (tp): every
block kind computed on a rank's own heads, d_ff, experts and vocab
slices, Megatron-LM style, as the reference's block is laid out under
GSPMD (its ``models/lm.py``: the residual stream sequence-sharded over tp
between blocks, heads, d_ff and experts over tp inside, logits
vocab-sharded).  An MoE block is expert-parallel with an all-gather
dispatcher (``models/moe.moe_ffn_tp``); an RWKV block runs its time mix on
the rank's heads, ``ln_x``'s mean square summed over tp, and its channel
mix on the rank's d_ff slice (``models/rwkv6.py``); a hybrid block runs
its attention and its SSM branch (``models/ssm.local_view``) on the
rank's heads, each branch's partial sum reduced before its norm
(``models/lm._mix``); an encoder–decoder runs its encoder as dense blocks
on the rank's sequence slice, gathers the encoder's output once a step,
and cross-attends on the rank's heads and K/V heads.

The collectives, each an ``autograd.Function`` with its dual backward:

  gather_seq   all-gather over tp on dim 1      backward: reduce-scatter
  scatter_seq  reduce-scatter over tp on dim 1  backward: all-gather
  split_seq    this rank's slice of dim 1       backward: zeros elsewhere
  all_reduce   sum over tp                      backward: identity, or the
                                                sum again (``grad_sum``)

and the vocab-parallel pieces: :func:`embed_partial` (the rank's vocab
rows looked up, the others zero) and :func:`cross_entropy_parts` (the row
max and Σexp reduced over tp, the gold logit from the rank that owns the
target id; no rank holds (B, S, V)).

A block (``models/lm.py``) enters its full-sequence region with
:func:`enter` and leaves it with :func:`leave`.  Where tp divides the
sequence (sequence parallelism, SP) the residual stream is each rank's
slice (B, S/tp, D): enter gathers it, and leave reduce-scatters a partial
sum (a row-parallel ``wo`` or ``w_down``) or, where the block computed its
output whole on every rank (heads that tp does not divide: Qwen's 40 and
LLaVA's 56 at tp 16), takes the rank's slice.  Where tp does not divide
the sequence the stream is whole on every rank and its gradient partial
over tp: enter is the identity and leave sums a partial output over tp
in both directions.  Either way every leaf that a rank reads whole over
tp (the norm scales, ``wk``/``wv``, a gathered ``wq``, the router, RWKV's
``wA``, ``cr``, lerps, ``w0``, ``u`` and ``ln_x``) gets a gradient
that is partial over tp, which ``sharding._Gather`` sums over tp as well
as over dp (Megatron's sequence-parallel norm-gradient all-reduce), and a
leaf kept sharded over tp (``wq``, ``wo``, the MLP's, the embedding's) a
gradient that is the rank's own.

Transport.  With the gloo backend (two ranks sharing one card, or the
CPU) a collective runs on the host: each rank's tensor is all-gathered as
bytes (a CUDA tensor copied to the host and the parts back: ``staged_bytes``
counts both ways, ``host_seconds`` the time) and the parts are summed on
the tensor's device in rank order in float32, so every rank gets the same
bits and a rerun is bit-equal to itself.  ``sharding``'s gathers and
gradient reductions on a gloo mesh run on this transport too, one mesh
dimension at a time (:func:`axis` names any dimension).  With any other
backend (NCCL; the dry run's fake group) the collectives are
``torch.distributed._functional_collectives`` on the sub-group of the
``DeviceMesh``, reduced in the library's fixed order.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed import _functional_collectives as funcol

TP_AXIS = "model"
# the functional collectives' current names (torch ≥ 2.13), their older ones before
_ALL_GATHER = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
_REDUCE_SCATTER = getattr(funcol, "reduce_scatter_single", None) or funcol.reduce_scatter_tensor

staged_bytes = 0      # bytes the host transport copied between a card and the host
host_collectives = 0  # collectives the host transport ran
host_seconds = dict.fromkeys(("wait", "to_host", "exchange", "to_device"), 0.0)


def reset_counters() -> None:
    global staged_bytes, host_collectives
    staged_bytes = host_collectives = 0
    for k in host_seconds:
        host_seconds[k] = 0.0


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The tp axis of a mesh: its mesh dimension, size, this rank's
    coordinate on it and the transport (``host``: gloo).  ``spans``: in a
    decode step, each layer's global cache span (the cache holds the
    rank's contiguous block of span/tp slots where tp divides the span)."""
    mesh: Any
    dim: int
    size: int
    rank: int
    host: bool
    spans: Optional[Tuple[int, ...]] = None

    @property
    def group(self):
        return self.mesh.get_group(self.dim)

    def divides(self, n: int) -> bool:
        return n % self.size == 0

    def with_spans(self, spans) -> "TensorParallel":
        return dataclasses.replace(self, spans=tuple(spans))


def axis(mesh, dim: int) -> TensorParallel:
    """Mesh dimension ``dim`` as a transport (any axis: a dp sum too)."""
    return TensorParallel(mesh, dim, mesh.size(dim), mesh.get_local_rank(dim),
                          dist.get_backend(mesh.get_group(dim)) == "gloo")


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The dp ranks of one tp group, in dp-rank order: the mesh's dp
    dimensions of more than one rank (``axes``, the major one first, as
    ``sharding``'s dp entry splits the batch's rows over them)."""
    axes: Tuple[TensorParallel, ...]

    @property
    def size(self) -> int:
        n = 1
        for a in self.axes:
            n *= a.size
        return n

    @property
    def rank(self) -> int:
        r = 0
        for a in self.axes:
            r = r * a.size + a.rank
        return r


def data_group(mesh) -> Optional[DataGroup]:
    """The dp group of this rank on ``mesh`` (None where no dp axis has
    more than one rank)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    dims = [i for i, n in enumerate(names) if n in ("pod", "data") and mesh.size(i) > 1]
    return DataGroup(tuple(axis(mesh, d) for d in dims)) if dims else None


def gather_dp(x: torch.Tensor, dp: DataGroup) -> torch.Tensor:
    """Every dp rank's ``x`` stacked in dp-rank order: (dp.size, *x.shape),
    one all-gather a dp dimension, the minor one first."""
    out = x[None]
    for a in reversed(dp.axes):
        out = gather(out, a, 0)
    return out


def context(mesh, cfg) -> Optional[TensorParallel]:
    """The tp context of a config on ``mesh``: None unless the mesh has a
    "model" axis of more than one rank and tp divides the padded vocab
    (always, at 512).  Every block kind has a tensor-parallel path."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if mesh is None or TP_AXIS not in names or cfg.padded_vocab % mesh.size(names.index(TP_AXIS)):
        return None
    dim = names.index(TP_AXIS)
    return None if mesh.size(dim) == 1 else axis(mesh, dim)


def keeps(cfg, tp: TensorParallel) -> Callable[[str], bool]:
    """Which leaves a block reads as its tp shard (the others it gathers
    over tp, whole): the embedding's two; a dense, hybrid, MoE or encdec
    block's ``wq``, ``bq`` and ``wo`` where tp divides the heads (a shard
    must not cut one), a dense, hybrid or encdec block's MLP three, an MoE
    block's expert stacks (E over tp) and its shared expert's three
    (d_ff); a hybrid block's SSM ``wx``, ``wB``, ``wC``, ``conv`` (columns)
    and ``wo`` (rows) where tp divides the SSM heads; a decoder block's
    cross-attention ``wq``, ``bq`` and ``wo`` where tp divides the heads and
    its ``wk``, ``wv``, ``bk`` and ``bv``, and an encoder block's
    self-attention's (no decode cache holds its k, v), where tp divides the
    K/V heads; an
    RWKV block's channel-mix ``ck`` and ``cv`` (d_ff) and, where tp divides
    its heads, the time mix's ``wr``, ``wk``, ``wv``, ``wg``, ``wB``
    (columns) and ``wo`` (rows).  A leaf the rules leave whole over tp
    stays whole either way."""
    pats = [r"embed/(tok|head)$"]
    if cfg.kind == "rwkv":
        pats.append(r"mix/(ck|cv)$")
        if (cfg.d_model // cfg.rwkv_head_size) % tp.size == 0:
            pats.append(r"mix/(w[rkvg]|wB|wo)$")
    else:
        pats.append(r"moe/w_(gate|up|down)$|shared/w_(gate|up|down)$" if cfg.kind == "moe"
                    else r"mlp/w_(gate|up|down)$")
        if cfg.n_heads % tp.size == 0:
            pats.append(r"attn/(wq|bq|wo)$")      # the cross-attention's too (xattn/...)
        if cfg.kind == "encdec" and cfg.kv_heads % tp.size == 0:
            pats.append(r"(xattn|^enc_layers/.*attn)/(wk|wv|bk|bv)$")
        if cfg.kind == "hybrid" and (cfg.ssm_heads or cfg.n_heads) % tp.size == 0:
            pats.append(r"ssm/(wx|wB|wC|conv|wo)$")
    rx = re.compile("|".join(pats))
    return lambda path: rx.search(path) is not None


# -------------------------------------------------------------- transport --
def _parts(x: torch.Tensor, tp: TensorParallel, pick=None):
    """Every rank's ``x`` (``pick`` of it), in rank order, on ``x``'s device:
    gloo exchanges them as bytes on the host, a CUDA tensor copied there and
    back.  ``host_seconds`` splits the time: waiting for the card's queued
    work, the copy to the host, gloo's exchange, the copies back."""
    global staged_bytes, host_collectives
    t0 = time.perf_counter()
    work = x.detach().contiguous()
    if work.is_cuda:
        torch.cuda.synchronize(work.device)
        t1 = time.perf_counter()
        work = work.cpu()
        staged_bytes += work.numel() * work.element_size()
    else:
        t1 = t0
    t2 = time.perf_counter()
    raw = work.reshape(-1).view(torch.uint8)
    got = [torch.empty_like(raw) for _ in range(tp.size)]
    dist.all_gather(got, raw, group=tp.group)
    t3 = time.perf_counter()
    parts = [g.view(x.dtype).view(x.shape) for g in got]
    if pick is not None:
        parts = [pick(p) for p in parts]
    if x.is_cuda:
        parts = [p.to(x.device) for p in parts]
        staged_bytes += sum(p.numel() * p.element_size() for p in parts)
    host_collectives += 1
    for k, dt in zip(("wait", "to_host", "exchange", "to_device"),
                     (t1 - t0, t2 - t1, t3 - t2, time.perf_counter() - t3)):
        host_seconds[k] += dt
    return parts


def _ordered(parts, op: str, dtype) -> torch.Tensor:
    """The parts reduced in rank order (float32 for a narrower float)."""
    wide = torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype
    acc = parts[0].to(wide).clone()
    for p in parts[1:]:
        if op == "sum":
            acc += p.to(wide)
        else:
            acc = torch.maximum(acc, p.to(wide))
    return acc.to(dtype)


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def gather(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """All-gather over tp, the ranks' tensors concatenated along ``dim``."""
    if tp.host:
        return torch.cat(_parts(x, tp), dim)
    return _wait(_ALL_GATHER(x.contiguous(), dim, (tp.mesh, tp.dim)))


def reduce_scatter(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """Sum over tp, this rank keeping its slice of ``dim``."""
    if tp.host:
        n = x.shape[dim] // tp.size
        return _ordered(_parts(x, tp, lambda p: p.narrow(dim, tp.rank * n, n)), "sum", x.dtype)
    return _wait(_REDUCE_SCATTER(x.contiguous(), "sum", dim, (tp.mesh, tp.dim)))


def reduce(x: torch.Tensor, tp: TensorParallel, op: str = "sum") -> torch.Tensor:
    """All-reduce over tp, ``op`` "sum" or "max"."""
    if tp.host:
        return _ordered(_parts(x, tp), op, x.dtype)
    return _wait(funcol.all_reduce(x.contiguous(), op, (tp.mesh, tp.dim)))


def on_host(mesh) -> bool:
    """True where collectives on ``mesh`` run on the host (gloo)."""
    return dist.get_backend(mesh.get_group(0)) == "gloo"


# ----------------------------------------------------------- collectives --
class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return gather(x, tp, 1)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.tp, 1), None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return reduce_scatter(x, tp, 1)

    @staticmethod
    def backward(ctx, g):
        return gather(g, ctx.tp, 1), None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        n = x.shape[1] // tp.size
        ctx.tp, ctx.n, ctx.S = tp, n, x.shape[1]
        return x[:, tp.rank * n:(tp.rank + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros((g.shape[0], ctx.S) + tuple(g.shape[2:]))
        out[:, ctx.tp.rank * ctx.n:(ctx.tp.rank + 1) * ctx.n] = g
        return out, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, grad_sum: bool):
        ctx.tp, ctx.grad_sum = tp, grad_sum
        return reduce(x, tp, "sum")

    @staticmethod
    def backward(ctx, g):
        return (reduce(g, ctx.tp, "sum") if ctx.grad_sum else g), None, None


def gather_seq(x, tp):
    return _GatherSeq.apply(x, tp)


def scatter_seq(x, tp):
    return _ScatterSeq.apply(x, tp)


def split_seq(x, tp):
    return _SplitSeq.apply(x, tp)


def all_reduce(x, tp, grad_sum: bool = False):
    return _AllReduce.apply(x, tp, grad_sum)


# ------------------------------------------------------------ the blocks --
def seq_parallel(tp: Optional[TensorParallel], S: int) -> bool:
    """Whether a sequence of S positions runs sequence-parallel."""
    return tp is not None and tp.divides(S)


def enter(x: torch.Tensor, tp: Optional[TensorParallel], sp: bool) -> torch.Tensor:
    """The residual stream → a block's full-sequence input."""
    return gather_seq(x, tp) if tp is not None and sp else x


def leave(out: torch.Tensor, tp: Optional[TensorParallel], sp: bool,
          partial: bool) -> torch.Tensor:
    """A block's output → the residual stream's layout: a partial sum over
    tp (``partial``) reduced, an output every rank computed whole sliced."""
    if tp is None:
        return out
    if partial:
        return scatter_seq(out, tp) if sp else all_reduce(out, tp, grad_sum=True)
    return split_seq(out, tp) if sp else out


def last_position(h: torch.Tensor, tp: Optional[TensorParallel], sp: bool) -> torch.Tensor:
    """(B, D): the sequence's last position (on the last rank under SP)."""
    if tp is None or not sp:
        return h[:, -1]
    return gather(h[:, -1:], tp, 1)[:, -1]


def local_slice(t: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """This rank's contiguous block of ``dim`` (tp divides it)."""
    n = t.shape[dim] // tp.size
    return t.narrow(dim, tp.rank * n, n)


# ----------------------------------------------------- the vocab pieces --
def embed_partial(tok: torch.Tensor, tokens: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The rank's rows of the embedding ``tok`` (V/tp, D) looked up, ids
    outside them zero: summed over tp it is the whole lookup (the
    counterpart of the reference's one-hot product under a mesh)."""
    n = tok.shape[0]
    ids = tokens - tp.rank * n
    own = (ids >= 0) & (ids < n)
    return tok[torch.where(own, ids, 0)] * own[..., None].to(tok.dtype)


def cross_entropy_parts(logits: torch.Tensor, targets: torch.Tensor,
                        tp: TensorParallel) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, gold) of the full vocab's logits from the rank's vocab slice
    ``logits`` (..., V/tp) float32, padded ids already masked: the row max
    (no gradient) and Σexp reduced over tp, the gold logit from the rank
    that holds ``targets``' id; each reduction's backward the identity."""
    n = logits.shape[-1]
    m = reduce(logits.detach().amax(-1), tp, "max")
    se = all_reduce(torch.exp(logits - m[..., None]).sum(-1), tp)
    ids = targets - tp.rank * n
    own = (ids >= 0) & (ids < n)
    mine = torch.gather(logits, -1, torch.where(own, ids, 0)[..., None])[..., 0]
    gold = all_reduce(torch.where(own, mine, torch.zeros_like(mine)), tp)
    return m + torch.log(se), gold
