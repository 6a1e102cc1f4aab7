"""Mixture-of-experts FFN with capacity-based scatter dispatch, the port of
the reference's ``models/moe.py`` (dbrx-132b: 16 experts, top-4;
llama4-scout: 16 experts, top-1 and a shared expert).

A float32 router and its softmax pick each token's top-k experts, whose
gates are renormalised to sum to 1.  Each (token, choice) pair takes its
rank in its expert in arrival order, the flattened (T·K) pairs token
by token and, within a token, choice by choice; pairs ranked at the
capacity C or past it are dropped.  The kept tokens are scattered into an
(E, C, D) buffer (a dp rank's, (E, min(C, T), D): ``Routing.slot``), run
through each expert's SwiGLU (a batched product a weight, ``torch.bmm``:
the reference computes it outside any Pallas kernel too), gathered back,
weighted by their gates and summed over a
token's K contributions; the shared expert, where there is one, adds its
MLP of every token.  The Switch load-balance loss comes back beside the
output.  Under autograd (the training loss, at the config's own capacity
factor) the gradient flows as the reference's: through the gates and
the router (the top-k probabilities and the mean probabilities of the aux
loss; the one-hot expert counts carry none), the scatter into the
buffer, the expert products and the gather; a dropped pair adds nothing
and takes no gradient.

Two changes from the reference, neither of which moves a result:

- top-k is a stable descending sort of the probabilities, so tied
  experts come in index order, as ``jax.lax.top_k`` gives them
  (``torch.topk`` leaves the order of ties open);
- a token's K contributions are summed as a (T, K, D) sum over K, where
  the reference scatter-adds them in its dtype (``segment_sum``): in
  bf16 the two round differently, in float32 they agree to the last bits.

Expert parallelism (:func:`moe_ffn_tp`, a tp rank of ``distributed/tp.py``,
Megatron's all-gather dispatcher): every rank of a tp group routes the
group's whole token set, as one process would, and computes its own E/tp
experts over the pairs routed to them; the ranks' outputs sum over tp.

:func:`route` is the routing alone (a chip run reads its drops and loads,
and may replay another run's choices through its ``expert`` argument);
:func:`moe_ffn` calls it through this module, so a caller may stand a
recording or replaying version in for it.  The expert products run inside a
``record_function`` range ``moe_experts``, which a profile counts as a
kind of its own (:func:`moe_ffn_tp`'s too).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..distributed import tp as TP
from .config import ModelConfig
from .layers import _dense_init


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, device=None):
    """The router (D, E) float32, the experts' w_gate, w_up (E, D, F) and
    w_down (E, F, D), and with ``cfg.shared_expert`` a shared SwiGLU of
    width F, drawn from ``gen``."""
    E, D, Fw = cfg.n_experts, cfg.d_model, cfg.d_ff
    dense = lambda shape, dt=dtype, scale=1.0: _dense_init(gen, shape, dt, scale, device=device)
    down = 1.0 / math.sqrt(2 * cfg.n_layers)
    p = {"router": dense((D, E), torch.float32),
         "w_gate": dense((E, D, Fw)), "w_up": dense((E, D, Fw)),
         "w_down": dense((E, Fw, D), scale=down)}
    if cfg.shared_expert:
        p["shared"] = {"w_gate": dense((D, Fw)), "w_up": dense((D, Fw)),
                       "w_down": dense((Fw, D), scale=down)}
    return p


@dataclasses.dataclass
class Routing:
    """The routing of T tokens: the top-k ``expert`` (T, K) and their
    renormalised ``gate`` (T, K), each pair's ``rank`` in its expert
    (T·K,), ``keep`` = rank < ``capacity``, and the Switch ``aux`` loss (a
    float32 scalar).  A kept pair's row in this process's (E, ``depth``, D)
    expert buffer is ``slot`` (T·K,): its rank, less the pairs that lower
    dp ranks sent to its expert (``route``'s ``dp``); ``depth`` is C, or
    min(C, T) on a dp rank (a token picks an expert once, so a rank holds at
    most T pairs an expert, and the lower ranks' pairs take no row here)."""
    expert: torch.Tensor
    gate: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    capacity: int
    aux: torch.Tensor
    slot: torch.Tensor
    depth: int


def capacity(cfg: ModelConfig, T: int, capacity_factor=None) -> int:
    """C = min(max(⌈T·K/E·cf⌉, 1), T·K), the reference's rule."""
    K, E = cfg.top_k, cfg.n_experts
    C = math.ceil(T * K / E * (capacity_factor or cfg.capacity_factor))
    return min(max(C, 1), T * K)


def route(p, cfg: ModelConfig, xt: torch.Tensor, capacity_factor=None,
          expert=None, aux_rows=None, dp=None) -> Routing:
    """Routing of the tokens ``xt`` (T, D) (see the module docstring).
    ``expert`` (T, K): take these choices instead of the top k (a run that
    replays another run's routing); the gates are then their probabilities,
    renormalised, and the rest follows from them as it does from the top k.
    ``aux_rows`` (lo, hi): the aux loss's value is the same, but its
    gradient reaches the probabilities of tokens lo..hi−1 alone (a tp
    rank's share: summed over the ranks it counts once).

    ``dp`` (a ``tp.DataGroup``): ``xt`` is this dp rank's slice of one
    microbatch whose rows the group's ranks hold in dp-rank order, T rows
    each.  The route is then the whole microbatch's, as one process routes
    it: C is the capacity of the group's T·dp tokens, a pair's rank in its
    expert counts the pairs the lower dp ranks sent there before its own
    (so the later rows' pairs are the ones dropped), and the aux loss's f_e
    and p̄_e are the group's means.  One all-gather over dp a call carries
    each rank's per-expert counts and probability sums (float64: the counts
    exact).  The aux loss's value is then the group's on every rank, and its
    gradient reaches the rank's own probabilities alone (its ``aux_rows``
    where given), so summed over the dp ranks it counts once: the caller
    must not weight it by the rank's share of the tokens (``launch/steps``).
    Every rank of the group must make the same calls in the same order,
    a remat recompute's included.  A rank's expert buffer holds its own
    kept pairs alone (``Routing.slot`` and ``depth``), so its expert
    products are those of its T tokens, not the group's."""
    T, E, K = xt.shape[0], cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ p["router"], -1)                   # (T, E)
    if expert is None:
        gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, expert = gate[:, :K], expert[:, :K]
    else:
        gate = torch.gather(probs, 1, expert)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat = expert.reshape(-1)
    onehot = F.one_hot(flat, E)                                           # (T·K, E)
    slot = torch.gather(torch.cumsum(onehot, 0) - onehot, 1, flat[:, None])[:, 0]
    rank, total = slot, T
    if dp is None:
        me, ce = probs.mean(0), onehot.reshape(T, K, E).sum(1).float().mean(0)
    else:
        total = T * dp.size
        parts = TP.gather_dp(torch.cat([onehot.sum(0).double(),
                                        probs.detach().sum(0).double()]), dp)   # (dp, 2E)
        rank = rank + parts[:dp.rank, :E].sum(0).long()[flat]
        ce = (parts[:, :E].sum(0) / total).float()
        me = (parts[:, E:].sum(0) / total).float()
    if aux_rows is not None or dp is not None:
        own = (probs if aux_rows is None else probs[aux_rows[0]:aux_rows[1]]).sum(0) / total
        me = me.detach() + (own - own.detach())             # the value bit for bit
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef
    C = capacity(cfg, total, capacity_factor)
    return Routing(expert, gate, rank, rank < C, C, aux, slot, C if dp is None else min(C, T))


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor, capacity_factor=None, dp=None):
    """x (B, S, D) → (out (B, S, D) in x's dtype, aux float32 scalar).
    ``capacity_factor`` overrides the config's (serving passes 4.0: a
    token dropped at training's factor must not move a decode result).
    ``dp``: x is a dp rank's rows of the group's microbatch (``route``)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(B * S, D)
    r = route(p, cfg, xt, capacity_factor, dp=dp)
    C = r.depth
    # a dropped pair writes zeros at slot 0, where its row is dropped again: no host sync
    slot = torch.where(r.keep, r.expert.reshape(-1) * C + r.slot, 0)
    rows = torch.where(r.keep[:, None], xt.repeat_interleave(K, 0), 0)
    buf = xt.new_zeros(E * C, D).index_add_(0, slot, rows).view(E, C, D)
    with torch.profiler.record_function("moe_experts"):
        if cfg.act == "swiglu":
            h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
        else:
            h = F.gelu(torch.bmm(buf, p["w_up"]), approximate="tanh")
        out_buf = torch.bmm(h, p["w_down"]).view(E * C, D)
    got = torch.where(r.keep[:, None], out_buf[slot], 0)                   # (T·K, D)
    out = (got * r.gate.reshape(-1, 1).to(x.dtype)).view(B * S, K, D).sum(1)
    if cfg.shared_expert:
        s = p["shared"]
        out = out + (F.silu(xt @ s["w_gate"]) * (xt @ s["w_up"])) @ s["w_down"]
    return out.reshape(B, S, D).to(x.dtype), r.aux


def is_partial(p, cfg: ModelConfig) -> bool:
    """Whether a tp rank's :func:`moe_ffn_tp` output is a partial sum over
    tp: its experts a block of E, or its shared expert a slice of d_ff."""
    return p["w_gate"].shape[0] != cfg.n_experts or (
        cfg.shared_expert and p["shared"]["w_down"].shape[0] != cfg.d_ff)


def moe_ffn_tp(p, cfg: ModelConfig, x: torch.Tensor, tpc, capacity_factor=None, dp=None):
    """Expert parallelism on a tp rank (``distributed/tp.py``): x (B, S, D),
    the tp group's whole token set, the same on every rank → (out (B, S,
    D) in x's dtype, a partial sum over tp where :func:`is_partial`, aux).

    Every rank routes all B·S tokens as :func:`moe_ffn` does (the same
    choices, ranks, drops and capacity C as one process), the aux loss's
    gradient taken from the rank's 1/tp share of the tokens (``route``'s
    ``aux_rows``).  The rank runs its own experts only (``p["w_gate"]``'s
    E/tp block, as the rules place it): their (E/tp, ``depth``, D) buffer is
    gathered from the tokens by slot, the pairs routed elsewhere never
    copied, and each slot's output, weighted by its gate, is added to its
    token's row in float32.  The shared expert adds the rank's d_ff slice.
    A part the rules keep whole (E or d_ff that tp does not divide) is
    added by tp rank 0 alone where the output is a partial sum.  ``dp``:
    the tp group's token set is one dp rank's rows of the microbatch, and
    the route exchanges its counts over dp alone (``route``)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    r = route(p, cfg, xt, capacity_factor,
              aux_rows=(tpc.rank * T // tpc.size, (tpc.rank + 1) * T // tpc.size), dp=dp)
    partial = is_partial(p, cfg)
    El = p["w_gate"].shape[0]
    split = El != E
    e0 = tpc.rank * El if split else 0
    if not split and partial and tpc.rank:
        El = 0                                          # rank 0 adds the routed part
    w = {k: p[k][:El] for k in ("w_gate", "w_up", "w_down")}
    C, n = r.depth, El * r.depth
    e = r.expert.reshape(-1)
    mine = r.keep & (e >= e0) & (e < e0 + El)
    slot = torch.where(mine, (e - e0) * C + r.slot, n)                  # n: no slot
    token = torch.arange(T, device=x.device).repeat_interleave(K)
    tok_of = torch.full((n + 1,), T, dtype=torch.long, device=x.device).scatter_(
        0, slot, token)[:n]                                              # T: an empty slot
    gates = r.gate.reshape(-1)
    gate_of = gates.new_zeros(n + 1).scatter(0, slot, gates)[:n]
    buf = torch.cat([xt, xt.new_zeros(1, D)])[tok_of].view(El, C, D)
    with torch.profiler.record_function("moe_experts"):
        if cfg.act == "swiglu":
            h = F.silu(torch.bmm(buf, w["w_gate"])) * torch.bmm(buf, w["w_up"])
        else:
            h = F.gelu(torch.bmm(buf, w["w_up"]), approximate="tanh")
        out_buf = torch.bmm(h, w["w_down"]).view(n, D)
    out = torch.zeros(T + 1, D, dtype=torch.float32, device=x.device).index_add(
        0, tok_of, out_buf.float() * gate_of[:, None])[:T].to(x.dtype)
    if cfg.shared_expert:
        s = p["shared"]
        if not partial or s["w_down"].shape[0] != cfg.d_ff or tpc.rank == 0:
            out = out + (F.silu(xt @ s["w_gate"]) * (xt @ s["w_up"])) @ s["w_down"]
    return out.reshape(B, S, D), r.aux
