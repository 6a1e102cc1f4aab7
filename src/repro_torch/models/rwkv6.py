"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free, data-dependent decay.

Recurrence per head (k-dim = v-dim = head_size):
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
    o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)

The port of the reference's ``models/rwkv6.py``.  Training and the
prefill compute the WKV in the chunked form through
``kernels/rwkv6_chunk``: the hand-written CUDA kernel for a CUDA tensor,
the plain chunked version (``kernels/rwkv6_chunk/ref.py``) for a CPU
tensor.  Where a gradient is wanted (training, from a zero state), that
call carries it through the kernel's ``autograd.Function``, whose
backward is the hand-written backward kernel (its plain version on the
CPU).  Decode is the O(1) recurrent step in plain torch.  On a tp rank
(``distributed/tp.py``; :func:`local_view`) the time mix runs on the
rank's H/tp heads, the WKV through the same kernels, ``ln_x``'s mean
square summed over tp, and ``wo`` row-parallel; the channel mix on the
rank's d_ff slice, its gate on the rank's sequence slice.  Casts follow
the reference: the weights and the token mixes are in the model dtype,
the decay and the WKV in float32, and the WKV output is normed in float32
and cast back before the gate and ``wo``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed import tp as TP
from ..kernels.rwkv6_chunk import rwkv6_chunk
from .config import ModelConfig
from .layers import _dense_init, rmsnorm

LORA = 64           # rank of the decay's data-dependent term


def init_rwkv_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, device=None):
    D = cfg.d_model
    hs = cfg.rwkv_head_size
    H = D // hs
    dev = device or gen.device
    rand = lambda *shape: torch.rand(shape, generator=gen, device=gen.device)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=gen.device)
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    dense = lambda shape, scale=1.0: _dense_init(gen, shape, dtype, scale, device=dev)
    return {
        # token-shift data-dependent lerp (5 targets: w, k, v, r, g)
        "mu": (rand(5, D) * 0.5 + 0.25).to(dev, dtype),
        # decay: w_t = exp(-exp(w0 + tanh(x @ A) @ B))
        "w0": torch.full((D,), -4.0, dtype=torch.float32, device=dev),
        "wA": dense((D, LORA)),
        "wB": (randn(LORA, D) * 0.01).to(dev, dtype),
        "u": (randn(H, hs) * 0.1).to(dev, torch.float32),
        "wr": dense((D, D)),
        "wk": dense((D, D)),
        "wv": dense((D, D)),
        "wg": dense((D, D)),
        "wo": dense((D, D), out_scale),
        "ln_x": torch.ones(D, dtype=dtype, device=dev),
        # channel mix
        "mu_c": (rand(2, D) * 0.5 + 0.25).to(dev, dtype),
        "ck": dense((D, cfg.d_ff)),
        "cv": dense((cfg.d_ff, D), out_scale),
        "cr": dense((D, D)),
    }


def _shift(x: torch.Tensor, last=None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros / supplied state at t=0)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _projections(p, cfg: ModelConfig, x, x_prev):
    """Shared by prefill and decode: r, k, v, g, logw from (B, S, D) inputs."""
    dx = x_prev - x
    mu = p["mu"].to(x.dtype)                        # (5, D)
    xw, xk, xv, xr, xg = [x + dx * mu[i] for i in range(5)]
    logw = -torch.exp(p["w0"] + (torch.tanh(xw @ p["wA"]) @ p["wB"]).float())   # ≤ 0
    r = xr @ p["wr"]
    k = xk @ p["wk"]
    v = xv @ p["wv"]
    g = F.silu(xg @ p["wg"])
    return r, k, v, g, logw


def _heads(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    B, S, D = t.shape
    hs = cfg.rwkv_head_size
    return t.reshape(B, S, D // hs, hs)


def wkv_inputs(p, cfg: ModelConfig, x):
    """The WKV's float32 (B, S, H, hs) heads (r, k, v, logw) of a whole
    sequence, and the gate g."""
    r, k, v, g, logw = _projections(p, cfg, x, _shift(x))
    heads = tuple(_heads(cfg, t).float() for t in (r, k, v, logw))
    return heads, g


def local_view(p, cfg: ModelConfig, tpc=None):
    """(``p`` for a tp rank's heads, the tp context of its ``ln_x`` sum):
    where ``wr`` holds the rank's columns only (its H/tp heads), ``w0``,
    ``u`` and ``ln_x`` cut to them and ``tpc``; else ``p`` and None (every
    head on every rank)."""
    n = p["wr"].shape[1]
    if tpc is None or n == cfg.d_model:
        return p, None
    c0, hs = tpc.rank * n, cfg.rwkv_head_size
    return {**p, "w0": p["w0"][c0:c0 + n], "u": p["u"][c0 // hs:(c0 + n) // hs],
            "ln_x": p["ln_x"][c0:c0 + n]}, tpc


def _norm_x(out, ln_x, tpc=None):
    """``ln_x``, an RMS norm over all of D in float32: on a tp rank's heads
    the sum of squares of its columns is summed over tp (the sum's
    backward sums over tp too: every rank's columns read it)."""
    if tpc is None:
        return rmsnorm(out, ln_x.float(), 1e-5)
    ss = TP.all_reduce(torch.square(out).sum(-1, keepdim=True), tpc, grad_sum=True)
    return out * torch.rsqrt(ss / (out.shape[-1] * tpc.size) + 1e-5) * ln_x.float()


def time_mix_out(p, cfg: ModelConfig, x, heads, g, return_state: bool = False, tpc=None):
    """The time-mix output of x (B, S, D) from its WKV inputs: S is
    zero-padded to a multiple of the chunk for the WKV and cut back.  With
    ``return_state``, also the WKV state after token S, (B, H, hs, hs)
    float32, from the same call: a padded token has logw = 0 and k = 0, so
    it decays nothing and adds nothing.  On a tp rank's heads (``p`` and
    ``tpc`` from :func:`local_view`) the state holds its H/tp heads and the
    output is a partial sum over tp (``wo``'s rows)."""
    B, S = x.shape[:2]
    chunk = cfg.ssm_chunk
    pad = (-S) % chunk
    if pad:
        heads = tuple(F.pad(t, (0, 0, 0, 0, 0, pad)) for t in heads)
    wkv = rwkv6_chunk(*heads, p["u"], chunk, return_state=return_state)
    out, state = wkv if return_state else (wkv, None)
    out = _norm_x(out[:, :S].reshape(B, S, -1), p["ln_x"], tpc)
    out = (out.to(x.dtype) * g) @ p["wo"]
    return (out, state) if return_state else out


def time_mix(p, cfg: ModelConfig, x, tpc=None):
    """Training and prefill path.  x: (B, S, D); ``p``, ``tpc`` as
    :func:`time_mix_out`'s."""
    heads, g = wkv_inputs(p, cfg, x)
    return time_mix_out(p, cfg, x, heads, g, tpc=tpc)


def time_mix_step(p, cfg: ModelConfig, x, state, tpc=None):
    """Decode: x (B, 1, D); state dict {S: (B, H, hs, hs), x_last: (B, D)};
    ``p``, ``tpc`` as :func:`time_mix_out`'s (S then the rank's heads)."""
    B = x.shape[0]
    r, k, v, g, logw = _projections(p, cfg, x, state["x_last"][:, None])
    rh = _heads(cfg, r)[:, 0].float()               # (B, H, hs)
    kh = _heads(cfg, k)[:, 0].float()
    vh = _heads(cfg, v)[:, 0].float()
    wh = torch.exp(_heads(cfg, logw)[:, 0])
    S0 = state["S"]
    kv = torch.einsum("bhk,bhd->bhkd", kh, vh)
    out = torch.einsum("bhk,bhkd->bhd", rh, S0 + p["u"][None, :, :, None] * kv)
    S1 = wh[..., None] * S0 + kv
    out = _norm_x(out.reshape(B, 1, -1), p["ln_x"], tpc)
    out = (out.to(x.dtype) * g) @ p["wo"]
    return out, {"S": S1, "x_last": x[:, 0]}


def channel_mix(p, cfg: ModelConfig, x, x_last=None, tpc=None, sp: bool = False):
    """The channel mix of x (B, S, D).  On a tp rank (``tpc``) x is the
    whole sequence and ``ck``, ``cv`` the rank's d_ff slice: ``k @ cv``,
    a partial sum, is reduced to the residual stream's layout (the rank's
    sequence slice under sequence parallelism, ``sp``) and gated there by
    ``cr``, read whole, on that slice; the output is in that layout."""
    xp = _shift(x, x_last)
    dx = xp - x
    mu = p["mu_c"].to(x.dtype)
    xk = x + dx * mu[0]
    xr = x + dx * mu[1]
    kv = torch.square(torch.relu(xk @ p["ck"])) @ p["cv"]
    if tpc is not None:
        kv = TP.leave(kv, tpc, sp, p["cv"].shape[0] != cfg.d_ff)
        if sp:
            xr = TP.local_slice(xr, tpc, 1)
    return torch.sigmoid(xr @ p["cr"]) * kv
