"""Mamba-2-style selective SSM branch, the parallel SSM heads of Hymba.

The port of the reference's ``models/ssm.py``.  Per head (state size N,
head dim P):

    h_t = a_t · h_{t−1} + (dt_t x_t) B_tᵀ        h ∈ R^{N×P}
    y_t = C_t h_t + D ⊙ x_t

with a scalar decay a_t = exp(−dt_t · exp(A_log)) a head (dt through a
softplus), computed by chunks in the SSD "attention form"
(arXiv:2405.21060): within a chunk of c positions the pairwise decays
form a (c × c) matrix a head.

The reference has no Pallas kernel here (its chunked scan is plain jnp),
so the branch is plain PyTorch with the reference's casts: the
projections, the causal depthwise conv of width 4 (summed in
``_conv1d``'s order) and the silu in the model dtype; x, B, C, dt and
log a in float32.  Three changes from the reference:

- :func:`ssm_chunked` does the work inside the chunks (the attention form
  and each chunk's own share of the state) for every chunk at once, and
  carries the states from chunk to chunk in Mamba-2's segment-sum form:
  one (nc + 1) × nc matrix of decays a (batch, head), from the chunks'
  total log-decays, and one product, with no loop.  The reference scans
  chunk by chunk.
- With ``return_state``, :func:`ssm_chunked` also returns the terminal
  state from that product, and :func:`ssm_branch` the state and the conv
  tail that the decode cache holds.  The reference takes them in a second
  pass over the sequence (``models/lm._ssm_final_state``), which clips
  each position's decay to the end at exp(−60); here the decay across
  whole chunks is clipped there instead, the decay inside a chunk not.
- :func:`ssm_step` sums the conv's four products in ``_conv1d``'s order
  and dtype, so that a bf16 decode step rounds as the prefill does; the
  reference's step contracts them in one einsum.

On a tp rank (``distributed/tp.py``) the branch runs on the rank's H/tp
heads where tp divides them (:func:`local_view`): ``wx`` and ``conv`` hold
its d_inner/tp columns, ``wB`` and ``wC`` its H/tp·N, ``wo`` its rows, and
``wdt``'s columns, ``dt_bias``, ``A_log`` and ``Dskip`` are cut to its
heads; the conv and the chunked scan run over the whole sequence, the
decode state holds the rank's heads and columns, and the output is a
partial sum over tp.  Elsewhere every rank runs every head.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _dense_init

CONV = 4                            # the causal conv's width


def _heads(cfg: ModelConfig) -> int:
    return cfg.ssm_heads or cfg.n_heads


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, d_inner: int,
             device=None):
    D, N, H = cfg.d_model, cfg.ssm_state, _heads(cfg)
    dev = device or gen.device
    dense = lambda shape, scale=1.0: _dense_init(gen, shape, dtype, scale, device=device)
    return {
        "wx": dense((D, d_inner)),
        "wB": dense((D, H * N)),
        "wC": dense((D, H * N)),
        "wdt": dense((D, H)),
        "dt_bias": torch.zeros(H, dtype=torch.float32, device=dev),
        "A_log": torch.zeros(H, dtype=torch.float32, device=dev),
        "Dskip": torch.ones(H, d_inner // H, dtype=torch.float32, device=dev),
        "wo": dense((d_inner, D), 1.0 / math.sqrt(2 * cfg.n_layers)),
        "conv": (torch.randn((CONV, d_inner), generator=gen, device=gen.device) * 0.1).to(
            device=dev, dtype=dtype),
    }


def local_view(p, cfg: ModelConfig, tpc=None):
    """(``p`` for a tp rank's SSM heads, whether the branch's output is then
    a partial sum over tp): where ``wx`` holds the rank's columns only (a
    whole number of heads of P), ``wdt``'s columns, ``dt_bias``, ``A_log``
    and ``Dskip`` cut to its heads; else ``p`` and False (every head on
    every rank)."""
    H, (_, P) = _heads(cfg), p["Dskip"].shape
    n = p["wx"].shape[1] // P
    if tpc is None or n == H:
        return p, False
    h0 = tpc.rank * n
    return {**p, "wdt": p["wdt"][:, h0:h0 + n], "dt_bias": p["dt_bias"][h0:h0 + n],
            "A_log": p["A_log"][h0:h0 + n], "Dskip": p["Dskip"][h0:h0 + n]}, True


def _conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of x (B, S, D) with w (K, D):
    out_t = Σ_k w[K − 1 − k] · x_{t−k}, summed in k's order in x's dtype."""
    K, S = w.shape[0], x.shape[1]
    out = None
    for k in range(K):
        term = F.pad(x, (0, 0, k, 0))[:, :S] * w[K - 1 - k]
        out = term if out is None else out + term
    return out


def _project(p, cfg: ModelConfig, u: torch.Tensor):
    """The conv's raw input u·wx (B, S, d_inner) in u's dtype, and the
    scan's inputs: x (B, S, H, P), B and C (B, S, H, N), dt and log a
    (B, S, H), float32 (the reference's ``_inputs``); H the heads of ``p``
    (a tp rank's, :func:`local_view`)."""
    B, S, _ = u.shape
    H, N = p["A_log"].shape[0], cfg.ssm_state
    xin = u @ p["wx"]
    x = F.silu(_conv1d(xin, p["conv"]))
    x = x.reshape(B, S, H, x.shape[-1] // H).float()
    Bm = (u @ p["wB"]).reshape(B, S, H, N).float()
    Cm = (u @ p["wC"]).reshape(B, S, H, N).float()
    dt = F.softplus((u @ p["wdt"]).float() + p["dt_bias"])
    loga = -dt * torch.exp(p["A_log"])                 # (B, S, H) ≤ 0
    return xin, (x, Bm, Cm, dt, loga)


def ssm_chunked(x, Bm, Cm, dt, loga, Dskip, chunk: int, return_state: bool = False):
    """x (B, S, H, P), Bm and Cm (B, S, H, N), dt and loga (B, S, H), S a
    multiple of ``chunk``, from a zero state → y (B, S, H, P); with
    ``return_state``, (y, the state after position S − 1 (B, H, N, P))."""
    B, S, H, P = x.shape
    if S % chunk:
        raise ValueError(f"ssm_chunked: S = {S} is not a multiple of the chunk {chunk}")
    nc, c = S // chunk, chunk
    r = lambda t: t.reshape(B, nc, c, *t.shape[2:])
    xc, Bc, Cc, dc, lc = r(x), r(Bm), r(Cm), r(dt), r(loga)
    cum = torch.cumsum(lc, 2)                                        # (B, nc, c, H) ≤ 0
    # inside each chunk: L_ij = e^{cum_i − cum_j} for j ≤ i (clipped at −60 as the reference)
    L = torch.exp(torch.clamp(cum[:, :, :, None] - cum[:, :, None], -60.0, 0.0))
    causal = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    A = torch.einsum("bzihn,bzjhn->bzijh", Cc, Bc) * L
    A = A.masked_fill(~causal[:, :, None], 0.0) * dc[:, :, None]      # dt_j folded in
    y = torch.einsum("bzijh,bzjhp->bzihp", A, xc)
    # each chunk's own share of the state it hands on
    to_end = torch.exp(cum[:, :, -1:] - cum)                         # (B, nc, c, H)
    local = torch.einsum("bzjhn,bzjhp->bzhnp", Bc * (dc * to_end)[..., None], xc)
    # the state entering chunk z (z = nc: after the last) is Σ_{j<z} e^{g_{j+1} + … + g_{z−1}}
    # local_j, g_m chunk m's total log decay: seg[i, e] = Σ_{e<d≤i} g'_d over g' = (0, g_0, …),
    # a masked cumsum (a difference of cumsums would lose float32 precision far from 0), and
    # column e = j + 1 holds chunk j's exponent (column 0, a zero initial state, is dropped)
    n = nc + 1
    g = F.pad(cum[:, :, -1].transpose(1, 2), (1, 0))                  # (B, H, nc + 1)
    below = torch.ones(n, n, dtype=torch.bool, device=x.device).tril(-1)
    seg = torch.cumsum(g[..., None].expand(B, H, n, n).masked_fill(~below, 0.0), 2)
    decay = torch.exp(seg.clamp(min=-60.0)).tril()                    # i ≥ e, clipped as L is
    hs = torch.einsum("bhzj,bjhnp->bzhnp", decay[..., 1:], local)     # (B, nc + 1, H, N, P)
    y = y + torch.einsum("bzihn,bzhnp->bzihp", Cc * torch.exp(cum)[..., None], hs[:, :nc])
    y = y.reshape(B, S, H, P) + x * Dskip
    return (y, hs[:, nc]) if return_state else y


class _Edge(torch.autograd.Function):
    """The identity, whose backward marks the moment the gradient passes
    with an empty ``record_function`` range ``name``: at the branch's output
    it marks where the branch's backward starts, at its input where it
    ends (every gradient of the branch has then reached its input)."""

    @staticmethod
    def forward(ctx, x, name: str):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function(ctx.name):
            pass
        return g, None


def ssm_branch(p, cfg: ModelConfig, u: torch.Tensor, chunk=None, return_state: bool = False):
    """Prefill (or a training forward): u (B, S, D) → (B, S, D) in u's
    dtype; with ``return_state``, (out, {"h" (B, H, N, P) float32, "conv"
    (B, 4, d_inner) the last four raw conv inputs, zeros before position
    0}), the decode cache after position S − 1.  S is padded to the chunk
    with zeros, which neither decay nor feed the state.

    The forward runs inside a ``record_function`` range ``ssm_branch``;
    where a gradient is wanted, the backward is marked by the empty ranges
    ``ssm_branch.bwd_begin`` and ``ssm_branch.bwd_end`` (:class:`_Edge`), so
    a profile counts both passes as the branch's."""
    marked = torch.is_grad_enabled() and u.requires_grad
    if marked:
        u = _Edge.apply(u, "ssm_branch.bwd_end")
    with torch.profiler.record_function("ssm_branch"):
        B, S, _ = u.shape
        chunk = chunk or cfg.ssm_chunk
        xin, ins = _project(p, cfg, u)
        pad = (-S) % chunk
        if pad:
            ins = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in ins]
        y = ssm_chunked(*ins, p["Dskip"], chunk, return_state)
        y, h = y if return_state else (y, None)
        y = y[:, :S]
        out = y.reshape(B, S, -1).to(u.dtype) @ p["wo"]
        if not return_state:
            return _Edge.apply(out, "ssm_branch.bwd_begin") if marked else out
        tail = xin[:, -CONV:]
        return out, {"h": h, "conv": F.pad(tail, (0, 0, CONV - tail.shape[1], 0))}


def ssm_step(p, cfg: ModelConfig, u: torch.Tensor, state):
    """Decode: u (B, 1, D) and state {"h" (B, H, N, P), "conv" (B, 4,
    d_inner)} → (out (B, 1, D), the state after this position); on a tp
    rank's heads (:func:`local_view`) the state holds them and their
    columns."""
    B = u.shape[0]
    H, N = p["A_log"].shape[0], cfg.ssm_state
    xin = (u @ p["wx"])[:, 0]                                        # (B, d_inner)
    conv_buf = torch.cat([state["conv"][:, 1:], xin[:, None]], 1)
    # _conv1d's out_t = Σ_k w[K − 1 − k] · x_{t−k}, conv_buf[j] = x_{t−(K−1)+j}: the
    # same products summed in the same order (the reference's einsum rounds once in
    # bf16, where the prefill rounds each term, so its decode step drifts from its prefill)
    K = conv_buf.shape[1]
    x = None
    for k in range(K):
        term = conv_buf[:, K - 1 - k] * p["conv"][K - 1 - k]
        x = term if x is None else x + term
    x = F.silu(x)
    x = x.reshape(B, H, x.shape[-1] // H).float()
    Bm = (u @ p["wB"])[:, 0].reshape(B, H, N).float()
    Cm = (u @ p["wC"])[:, 0].reshape(B, H, N).float()
    dt = F.softplus((u @ p["wdt"])[:, 0].float() + p["dt_bias"])
    a = torch.exp(-dt * torch.exp(p["A_log"]))                       # (B, H)
    h1 = a[..., None, None] * state["h"] + torch.einsum("bhn,bh,bhp->bhnp", Bm, dt, x)
    y = torch.einsum("bhn,bhnp->bhp", Cm, h1) + x * p["Dskip"]
    out = y.reshape(B, 1, -1).to(u.dtype) @ p["wo"]
    return out, {"h": h1, "conv": conv_buf}
