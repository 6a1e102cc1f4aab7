"""Plain PyTorch versions of the flash_attention kernel.

:func:`block_attn_fwd` is the port of the reference's
``models/layers._block_attn_fwd``, the model's own blockwise twin of the
kernel: online softmax over (q_chunk × kv_chunk) blocks at absolute
positions, with the reference's padding (−1 for padded queries, INT32_MAX
for padded keys), causal and window masks at −1e30, and its dtype
promotions (q·scale and the scores in float32; p rounded to v's dtype
before P·V, whose blocks are summed in float32; the output divided by
max(l, 1e-30)).  It visits every kv block and masks the ones outside a
window, where the reference gathers only the band: the masked blocks
add zeros, so the result is the same.

:func:`block_attn_bwd` is the port of the reference's backward
(``_block_attn_vjp_bwd``): it scans kv blocks, recomputes p = exp(s −
lse) and accumulates dq, dk and dv in float32; with a window, each kv
block meets only the query rows of its band, as the reference's
static-window branch.

:func:`flash_attention_ref` is the forward at query positions 0..S−1
and key positions 0..Sk−1, causal or not, with an optional window (query
i sees keys j ≤ i with i − j < w, the w keys (i − w, i]), at the
reference's default chunks: the kernel's plain version (the wrapper uses
it for CPU tensors).  Sk ≠ S only without causality (cross-attention).
:func:`attention_dense` is a dense softmax in float64, the comparison
oracle on the card, and :func:`attention_limit` gives it with the
tolerance a kernel output is held to; :func:`attention_lse_dense` is the
float64 oracle of the kernel's log-sum-exp output.  All three take the
same window.

Layouts: q (B, S, N, dh), k and v (B, Sk, Kh, dh) with N % Kh == 0; query
head n reads K/V head n // (N // Kh).  Outputs are (B, S, N·dh).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

INT32_MAX = 2 ** 31 - 1
GLOBAL_WINDOW = 1 << 29            # a window this wide or wider is full attention
KERNEL_TILE = {torch.float32: 64, torch.bfloat16: 128}   # the kernel's query tile, by dtype
Q_CHUNK, KV_CHUNK = 512, 1024      # ModelConfig's default q_chunk and kv_chunk
DENSE_ROWS = 512                   # queries a step of the dense oracle
F32_RTOL = 2e-5                    # float32 kernel: |err| ≤ F32_RTOL · max|v|
BF16_ROUND = 2.0 ** -7             # bf16 kernel: twice the bf16 unit roundoff


def attn_mask(qp: torch.Tensor, kp: torch.Tensor, causal: bool, window) -> torch.Tensor:
    """(B, Sq, Sk) validity mask from absolute positions (padding −1 for
    queries, INT32_MAX for keys); ``window`` ≥ GLOBAL_WINDOW is unrestricted."""
    qp, kp = qp.long()[:, :, None], kp.long()[:, None, :]
    mask = (qp >= 0) & (kp >= 0) & (kp < INT32_MAX)
    if causal:
        mask &= qp >= kp
    return mask & (qp - kp < window)


def block_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                   kv_pos: torch.Tensor, causal: bool, window: Optional[int], q_chunk: int,
                   kv_chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, N, dh); k, v: (B, Sk, Kh, dh); positions (B, Sq), (B, Sk).
    Returns (out (B, Sq, N·dh) float32 — float64 for float64 inputs —,
    lse (B, Kh, G, Sq))."""
    B, Sq, N, dh = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = N // Kh
    acc_t = torch.float64 if q.dtype == torch.float64 else torch.float32
    win = GLOBAL_WINDOW if window is None else window
    q = (q.to(acc_t) * (1.0 / math.sqrt(dh))).reshape(B, Sq, Kh, G, dh)

    nq = max(1, -(-Sq // q_chunk))
    qc = -(-Sq // nq)
    nk = max(1, -(-Sk // kv_chunk))
    kc = -(-Sk // nk)
    pad_q, pad_k = nq * qc - Sq, nk * kc - Sk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad_q), value=-1)
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad_k), value=INT32_MAX)
    neg = torch.tensor(-1e30, dtype=acc_t, device=q.device)

    outs, lses = [], []
    for i in range(nq):
        qi, qp = q[:, i * qc:(i + 1) * qc], q_pos[:, i * qc:(i + 1) * qc]
        acc = torch.zeros(B, Kh, G, qc, dh, dtype=acc_t, device=q.device)
        m = torch.full((B, Kh, G, qc), -math.inf, dtype=acc_t, device=q.device)
        l = torch.zeros(B, Kh, G, qc, dtype=acc_t, device=q.device)
        for j in range(nk):
            kj, vj = k[:, j * kc:(j + 1) * kc], v[:, j * kc:(j + 1) * kc]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kj.to(acc_t))
            mask = attn_mask(qp, kv_pos[:, j * kc:(j + 1) * kc], causal, win)
            s = torch.where(mask[:, None, None], s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vj.dtype), vj).to(acc_t)
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).permute(0, 3, 1, 2, 4))
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.cat(outs, 1).reshape(B, nq * qc, N * dh)[:, :Sq]
    return out, torch.cat(lses, -1)[..., :Sq]


def block_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                   lse: torch.Tensor, dout: torch.Tensor, q_pos: torch.Tensor,
                   kv_pos: torch.Tensor, causal: bool, window: Optional[int],
                   kv_chunk: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of :func:`block_attn_fwd`'s output, given
    its out (B, Sq, N·dh) and lse (B, Kh, G, Sq) and the cotangent dout of
    out.  As the reference: q·scale, k, v, dout and out in float32 (float64
    for float64 inputs), D = Σ dout·out per row, kv blocks scanned and
    masked by position, the results cast back to the inputs' dtypes.  Here
    ``out`` is the forward's output in q's dtype, where the reference keeps
    its float32 output: in bf16, D then sees the output rounded to bf16.

    With a causal ``window`` w, kv block j (keys [j·kc, (j + 1)·kc)) meets
    only the query rows [j·kc, min(Sq, j·kc + kc + w − 1)): the band of the
    reference's static-window branch, whose span is rounded up and clamped
    where this one stops at Sq.  The rows outside it hold exact zeros of
    p, so the gradients are the same as over every row.  The band counts
    rows, so it takes query row i at the position of key row i (the
    self-attention of a prefill or a training step, the only caller)."""
    B, Sq, N, dh = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = N // Kh
    acc_t = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / math.sqrt(dh)
    win = GLOBAL_WINDOW if window is None else window
    banded = causal and window is not None and window < GLOBAL_WINDOW
    qg = (q.to(acc_t) * scale).reshape(B, Sq, Kh, G, dh)
    dog = dout.to(acc_t).reshape(B, Sq, Kh, G, dh)
    D = (dog * out.to(acc_t).reshape(B, Sq, Kh, G, dh)).sum(-1)        # (B, Sq, Kh, G)
    Dt = D.permute(0, 2, 3, 1)[..., None]                               # (B, Kh, G, Sq, 1)
    lse = lse.to(acc_t)[..., None]

    nk = max(1, -(-Sk // kv_chunk))
    kc = -(-Sk // nk)
    pad_k = nk * kc - Sk
    kf, vf = k.to(acc_t), v.to(acc_t)
    if pad_k:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, pad_k))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad_k))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad_k), value=INT32_MAX)
    neg = torch.tensor(-1e30, dtype=acc_t, device=q.device)

    dq = torch.zeros(B, Sq, Kh, G, dh, dtype=acc_t, device=q.device)
    dks, dvs = [], []
    for j in range(nk):
        kj, vj = kf[:, j * kc:(j + 1) * kc], vf[:, j * kc:(j + 1) * kc]
        r0, r1 = (j * kc, min(Sq, j * kc + kc + window - 1)) if banded else (0, Sq)
        qs, ds_o = qg[:, r0:r1], dog[:, r0:r1]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qs, kj)
        mask = attn_mask(q_pos[:, r0:r1], kv_pos[:, j * kc:(j + 1) * kc], causal, win)
        p = torch.exp(torch.where(mask[:, None, None], s, neg) - lse[..., r0:r1, :])
        dvs.append(torch.einsum("bhgqk,bqhgd->bkhd", p, ds_o))           # p (B, Kh, G, rows, kc)
        ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", ds_o, vj) - Dt[..., r0:r1, :])
        dq[:, r0:r1] += torch.einsum("bhgqk,bkhd->bqhgd", ds, kj)
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, qs))             # qg pre-scaled
    dq = (dq * scale).reshape(B, Sq, N, dh).to(q.dtype)
    dk = torch.cat(dks, 1)[:, :Sk].to(k.dtype)
    dv = torch.cat(dvs, 1)[:, :Sk].to(v.dtype)
    return dq, dk, dv


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """The kernel's function by :func:`block_attn_fwd` at query positions
    0..S−1 and key positions 0..Sk−1, with ``window`` (None: none), in the
    reference model's default chunks (in bf16 each kv block's P·V is
    rounded to bf16, so the chunks set the rounding, as in the reference);
    (B, S, N·dh) in q's dtype."""
    B, S, Sk = q.shape[0], q.shape[1], k.shape[1]
    pos = lambda n: torch.arange(n, dtype=torch.int32, device=q.device).expand(B, n)
    out, _ = block_attn_fwd(q, k, v, pos(S), pos(Sk), causal, window, Q_CHUNK, KV_CHUNK)
    return out.to(q.dtype)


def _dense_mask(r0: int, rows: int, S: int, Sk: int, causal: bool, window: Optional[int],
                device) -> Optional[torch.Tensor]:
    """(rows, Sk) True where query r0 + r (of S) must not see key j: j >
    r0 + r when causal, and r0 + r − j ≥ window; None where nothing is
    masked."""
    if not causal and window is None:
        return None
    qi = torch.arange(r0, min(r0 + rows, S), device=device)[:, None]
    kj = torch.arange(Sk, device=device)[None, :]
    mask = kj > qi if causal else torch.zeros(qi.shape[0], Sk, dtype=torch.bool, device=device)
    return mask if window is None else mask | (qi - kj >= window)


def attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q·kᵀ/√dh)·v computed densely in float64 (scores of
    DENSE_ROWS queries of one batch row at a time against every one of
    the Sk keys, K/V heads repeated per group; keys outside the causal
    mask and the window at −1e30), (B, S, N·dh), and each row's ‖p‖₂ (its
    probabilities sum to 1), (B, S, N)."""
    rows, dt = DENSE_ROWS, torch.float64
    B, S, N, dh = q.shape
    Sk, G = k.shape[1], N // k.shape[2]
    out = torch.empty(B, S, N * dh, dtype=dt, device=q.device)
    norms = torch.empty(B, S, N, dtype=dt, device=q.device)
    for b in range(B):
        kd = k[b].to(dt).transpose(0, 1).repeat_interleave(G, dim=0)         # (N, S, dh)
        vd = v[b].to(dt).transpose(0, 1).repeat_interleave(G, dim=0)
        for r0 in range(0, S, rows):
            qd = q[b, r0:r0 + rows].to(dt).transpose(0, 1)                    # (N, R, dh)
            s = qd @ kd.transpose(1, 2) / math.sqrt(dh)                      # (N, R, Sk)
            mask = _dense_mask(r0, rows, S, Sk, causal, window, q.device)
            if mask is not None:
                s = s.masked_fill(mask, -1e30)
            p = torch.softmax(s, -1)
            out[b, r0:r0 + rows] = (p @ vd).transpose(0, 1).reshape(-1, N * dh)
            norms[b, r0:r0 + rows] = torch.linalg.vector_norm(p, dim=-1).T
    return out, norms


def attention_lse_dense(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Each query row's log-sum-exp of its scores q·kᵀ/√dh over the keys it
    sees (of Sk), in float64, (B, N, S): the oracle of the kernel's ``lse``
    output."""
    rows, dt = DENSE_ROWS, torch.float64
    B, S, N, dh = q.shape
    Sk, G = k.shape[1], N // k.shape[2]
    out = torch.empty(B, N, S, dtype=dt, device=q.device)
    for b in range(B):
        kd = k[b].to(dt).transpose(0, 1).repeat_interleave(G, dim=0)         # (N, S, dh)
        for r0 in range(0, S, rows):
            s = q[b, r0:r0 + rows].to(dt).transpose(0, 1) @ kd.transpose(1, 2) / math.sqrt(dh)
            mask = _dense_mask(r0, rows, S, Sk, causal, window, q.device)
            if mask is not None:
                s = s.masked_fill(mask, -math.inf)
            out[b, :, r0:r0 + rows] = torch.logsumexp(s, -1)
    return out


def attention_limit(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float64 oracle of a kernel output in q's dtype and the largest
    |kernel − oracle| allowed per element, with V = max|v|:

    - float32: F32_RTOL · V (float32 sums of up to S terms whose weights
      sum to 1);
    - bfloat16: 2⁻⁷ · (|o| + ‖p‖₂ · V) for output o of a row with
      probabilities p.  Rounding the output to bf16 moves it by 2⁻⁸·|o| at
      most; rounding each p_j to bf16 before P·V, as the reference does,
      adds Σ_j δ_j p_j v_j with |δ_j| ≤ 2⁻⁸, whose spread is at most
      2⁻⁸ · ‖p‖₂ · V.  So a row that averages many keys (‖p‖₂ ≈ 1/√keys)
      is held as tightly as its own small output, not to 2⁻⁷ · V.

    A window leaves both bounds as they are: p and ‖p‖₂ are the band's; so
    do Sk ≠ S keys (cross-attention): p and ‖p‖₂ are over them.

    Returns (oracle (B, S, N·dh), limit broadcastable to it), float64."""
    vmax = float(v.abs().max())
    want, norms = attention_dense(q, k, v, causal, window)
    if q.dtype != torch.bfloat16:
        return want, torch.tensor(F32_RTOL * vmax, dtype=torch.float64, device=q.device)
    B, S, N, dh = q.shape
    spread = norms[..., None].expand(B, S, N, dh).reshape(B, S, N * dh)
    return want, BF16_ROUND * (want.abs() + spread * vmax)
