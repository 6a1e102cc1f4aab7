"""Plain PyTorch version of the rwkv6_chunk kernel.

The chunked RWKV-6 WKV of the reference's ``models/rwkv6.rwkv_chunked``:
within a chunk of c tokens a decayed c × c score matrix (strictly lower,
every exponent clipped to [−60, 0]) plus the bonus u on its diagonal;
across chunks an hs × hs state per (batch, head), carried by a Python
loop over the chunks.  The wrapper uses it for CPU tensors.  With
``dtype=torch.float64`` it computes in float64, which makes it the
comparison oracle on the card.  With ``return_state=True`` it also
returns the state its loop carries after the last chunk, (B, H, hs, hs).
"""
from __future__ import annotations

from typing import Optional

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
