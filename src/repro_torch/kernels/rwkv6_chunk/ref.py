"""Plain PyTorch version of the rwkv6_chunk kernel.

The chunked RWKV-6 WKV of the reference's ``models/rwkv6.rwkv_chunked``:
within a chunk of c tokens a decayed c × c score matrix (strictly lower,
every exponent clipped to [−60, 0]) plus the bonus u on its diagonal;
across chunks an hs × hs state per (batch, head), carried by a Python
loop over the chunks.  The wrapper uses it for CPU tensors.  With
``dtype=torch.float64`` it computes in float64, which makes it the
comparison oracle on the card.  With ``return_state=True`` it also
returns the state its loop carries after the last chunk, (B, H, hs, hs).

:func:`rwkv6_chunk_bwd_ref` is the plain version of the backward kernel
(``csrc/rwkv6_chunk_bwd.cu``): the gradients of that function, from the
same chunked formulas the kernel evaluates (see its docstring), and
:func:`rwkv6_chunk_bwd_scale` the same formulas on |r|, |k|, |v|, |u|,
|do| with the decays' gradient as a sum of magnitudes, the scale of the
comparisons' tolerances.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rwkv6_chunk_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                    u: torch.Tensor, chunk: int,
                    dtype: Optional[torch.dtype] = None, return_state: bool = False):
    """r, k, v, logw (≤ 0): (B, S, H, hs); u: (H, hs); S % chunk == 0.
    Returns the (B, S, H, hs) output in ``dtype`` (default: r's dtype),
    with a zero state at the start of each sequence, and with
    ``return_state`` also the state after the last token, (B, H, hs, hs)
    as S[b, h, key, value]."""
    work = dtype or r.dtype
    B, S, H, hs = r.shape
    nc = S // chunk
    # (B, S, H, hs) → (nc, B, H, c, hs)
    fold = lambda t: t.to(work).reshape(B, nc, chunk, H, hs).permute(1, 0, 3, 2, 4)
    rc, kc, vc, wc = fold(r), fold(k), fold(v), fold(logw)
    uu = u.to(work)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=r.device), -1)
    state = torch.zeros(B, H, hs, hs, dtype=work, device=r.device)
    outs = []
    for c in range(nc):
        rr, kk, vv, ww = rc[c], kc[c], vc[c], wc[c]          # (B, H, c, hs)
        cum = torch.cumsum(ww, dim=2)                        # inclusive, ≤ 0
        cum_excl = cum - ww
        # A_ij = Σ_d r_id k_jd e^{cum_excl_id − cum_jd}  (j < i)
        E = torch.exp(torch.clamp(cum_excl[:, :, :, None, :] - cum[:, :, None, :, :],
                                  -60.0, 0.0))               # (B, H, c, c, hs)
        A = torch.einsum("bhid,bhjd,bhijd->bhij", rr, kk, E)
        A = torch.where(mask, A, torch.zeros((), dtype=work, device=r.device))
        diag = torch.einsum("bhid,hd,bhid->bhi", rr, uu, kk)
        out = torch.einsum("bhij,bhjd->bhid", A, vv) + diag[..., None] * vv
        out = out + torch.einsum("bhik,bhkd->bhid", rr * torch.exp(cum_excl), state)
        kW = kk * torch.exp(cum[:, :, -1:, :] - cum)
        state = torch.exp(cum[:, :, -1, :])[..., None] * state + torch.einsum(
            "bhjk,bhjd->bhkd", kW, vv)
        outs.append(out)
    out = torch.stack(outs, 0).permute(1, 0, 3, 2, 4).reshape(B, S, H, hs)
    return (out, state) if return_state else out


def _fold(t: torch.Tensor, work: torch.dtype, chunk: int) -> torch.Tensor:
    """(B, S, H, hs) → (n_chunks, B, H, c, hs) in ``work``."""
    B, S, H, hs = t.shape
    return t.to(work).reshape(B, S // chunk, chunk, H, hs).permute(1, 0, 3, 2, 4)


def _unfold(chunks) -> torch.Tensor:
    """A list of (B, H, c, hs) chunks → (B, S, H, hs)."""
    x = torch.stack(chunks, 0)
    nc, B, H, c, hs = x.shape
    return x.permute(1, 0, 3, 2, 4).reshape(B, nc * c, H, hs)


def _bwd_parts(r, k, v, logw, u, do, chunk: int, work: torch.dtype):
    """dr, dk, dv (B, S, H, hs), du (H, hs), and the two terms of the
    decays' gradient, a = r ⊙ dr' and b = k ⊙ dk' (B, S, H, hs), in
    ``work`` (see :func:`rwkv6_chunk_bwd_ref`)."""
    B, S, H, hs = r.shape
    nc = S // chunk
    rc, kc, vc, wc, dc = (_fold(t, work, chunk) for t in (r, k, v, logw, do))
    uu = u.to(work)
    dev = r.device
    lower = torch.tril(torch.ones(chunk, chunk, dtype=work, device=dev), -1)
    # forward: the state at each chunk's start
    starts, state = [], torch.zeros(B, H, hs, hs, dtype=work, device=dev)
    for c in range(nc):
        cum = torch.cumsum(wc[c], dim=2)
        starts.append(state)
        kW = kc[c] * torch.exp(cum[:, :, -1:, :] - cum)
        state = torch.exp(cum[:, :, -1, :])[..., None] * state + torch.einsum(
            "bhjk,bhjd->bhkd", kW, vc[c])
    # backward: G = dL/d(state after the chunk), carried in reverse
    G = torch.zeros(B, H, hs, hs, dtype=work, device=dev)
    du = torch.zeros(H, hs, dtype=work, device=dev)
    dr, dk, dv, a, b = ([None] * nc for _ in range(5))
    for c in reversed(range(nc)):
        rr, kk, vv, dd = rc[c], kc[c], vc[c], dc[c]
        cum = torch.cumsum(wc[c], dim=2)
        cum_excl = cum - wc[c]
        last = cum[:, :, -1:, :]
        E = torch.exp(torch.clamp(cum_excl[:, :, :, None, :] - cum[:, :, None, :, :],
                                  -60.0, 0.0)) * lower[:, :, None]        # (B, H, i, j, hs)
        Q = torch.einsum("bhie,bhje->bhij", dd, vv)                       # do_i · v_j
        Qd = torch.diagonal(Q, dim1=2, dim2=3)                            # (B, H, c)
        A = torch.einsum("bhid,bhjd,bhijd->bhij", rr, kk, E) + torch.diag_embed(
            torch.einsum("bhid,hd,bhid->bhi", rr, uu, kk))
        drp = (torch.einsum("bhij,bhjd,bhijd->bhid", Q, kk, E)
               + torch.exp(cum_excl) * torch.einsum("bhde,bhie->bhid", starts[c], dd))
        dkp = (torch.einsum("bhij,bhid,bhijd->bhjd", Q, rr, E)
               + torch.exp(last - cum) * torch.einsum("bhde,bhje->bhjd", G, vv))
        kW = kk * torch.exp(last - cum)
        dr[c] = drp + uu[:, None, :] * kk * Qd[..., None]
        dk[c] = dkp + uu[:, None, :] * rr * Qd[..., None]
        dv[c] = torch.einsum("bhij,bhid->bhjd", A, dd) + torch.einsum("bhjd,bhde->bhje", kW, G)
        du = du + torch.einsum("bhid,bhid,bhi->hd", rr, kk, Qd)
        a[c], b[c] = rr * drp, kk * dkp
        G = torch.exp(last[:, :, 0, :])[..., None] * G + torch.einsum(
            "bhid,bhie->bhde", rr * torch.exp(cum_excl), dd)
    return _unfold(dr), _unfold(dk), _unfold(dv), du, _unfold(a), _unfold(b)


def _after(x: torch.Tensor) -> torch.Tensor:
    """Σ_{i>t} x_i over the sequence axis (1) of (B, S, H, hs)."""
    total = torch.flip(torch.cumsum(torch.flip(x, [1]), 1), [1])
    return total - x


def rwkv6_chunk_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        logw: torch.Tensor, u: torch.Tensor, do: torch.Tensor, chunk: int,
                        dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, ...]:
    """Gradients (dr, dk, dv, dlogw (B, S, H, hs), du (H, hs)) of
    :func:`rwkv6_chunk_ref`'s output, zero initial state, against ``do``
    (B, S, H, hs), computed in ``dtype`` (default r's).

    Per chunk, with Q_ij = do_i · v_j, the intra-chunk decays E_ijd =
    e^{clip(cum_excl_id − cum_jd, −60, 0)} (j < i), the state S0 at the
    chunk's start (a forward walk) and G = dL/d(state after the chunk)
    (carried in reverse, G ← e^{cum_last} ⊙ G + (r ⊙ e^{cum_excl})ᵀ·do):

    - dr_i = Σ_{j<i} Q_ij k_j ⊙ E_ij + e^{cum_excl_i} ⊙ (S0·do_i) + u ⊙ k_i Q_ii;
    - dk_j = Σ_{i>j} Q_ij r_i ⊙ E_ij + e^{cum_last − cum_j} ⊙ (G·v_j) + u ⊙ r_j Q_jj;
    - dv_j = Σ_{i≥j} A_ij do_i + (k_j ⊙ e^{cum_last − cum_j})·G, A the
      forward's intra-chunk matrix with u on its diagonal;
    - du = Σ_{b,t} r_t ⊙ k_t Q_tt;
    - dlogw_t = Σ_{i>t} r_i ⊙ dr'_i − Σ_{p≥t} k_p ⊙ dk'_p over the whole
      sequence, dr' and dk' without their u terms: every pair j < i whose
      decay passes through t adds once to the first sum and not to the
      second.  (Where the forward clips, its own gradient is 0 and this
      one below e^{−60} of the pair's term.)"""
    work = dtype or r.dtype
    dr, dk, dv, du, a, b = _bwd_parts(r, k, v, logw, u, do, chunk, work)
    return dr, dk, dv, _after(a - b) - b, du


def rwkv6_chunk_bwd_scale(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          logw: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                          chunk: int) -> Tuple[torch.Tensor, ...]:
    """The float64 scale of each gradient's rounding: the same formulas on
    |r|, |k|, |v|, |u| and |do| (the decays as given), with dlogw_t the sum
    of the two terms' magnitudes, Σ_{i>t} |a_i| + Σ_{p≥t} |b_p| (the
    kernel and the reference both reach it through that cancellation)."""
    dr, dk, dv, du, a, b = _bwd_parts(r.abs(), k.abs(), v.abs(), logw, u.abs(), do.abs(),
                                      chunk, torch.float64)
    return dr, dk, dv, _after(a) + _after(b) + b, du
