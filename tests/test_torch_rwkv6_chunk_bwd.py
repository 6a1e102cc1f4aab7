"""The WKV backward kernel's algorithm (``csrc/rwkv6_chunk_bwd.cu``) on the
CPU.

The kernel cannot run here, so this file writes its algorithm in float64
torch (:func:`kernel_algorithm`) and holds it to the plain backward
``ref.rwkv6_chunk_bwd_ref`` and to ``jax.grad`` of the reference's
``rwkv_chunked``:

- per chunk, the factored intra-chunk terms (Rw = r ⊙ e^{cum_excl},
  Ki = k ⊙ e^{−cum}: A = Rw·Kiᵀ, X = Q_lower·Ki, Y = Q_lowerᵀ·Rw), or the
  pairwise form with every exponent clipped to [−60, 0] where any column
  of the chunk decays by more than 60;
- the state terms S0·do and G·v as ``split`` partials over value columns
  (one a CTA of the kernel's cluster), summed in rank order;
- the decays' gradient dw_t = D_t − b_t with D carried per key column over
  the whole sequence in reverse.

Tolerances: against the plain backward in float64, 1e-10 of the gradients'
scale (``ref.rwkv6_chunk_bwd_scale``: the same formulas on |r|, |k|, |v|,
|u|, |do|); float32 inputs against ``jax.grad`` of the reference's scan,
1e-4 of that scale (``tests/test_torch_rwkv_train.py``'s GRAD_RTOL: float32
sums in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv6 import rwkv_chunked
from repro_torch.kernels.rwkv6_chunk import ops
from repro_torch.kernels.rwkv6_chunk.ref import rwkv6_chunk_bwd_ref, rwkv6_chunk_bwd_scale

F64_RTOL = 1e-10
GRAD_RTOL = 1e-4
BIG_DECAY = -60.0
NAMES = ("dr", "dk", "dv", "dlogw", "du")
# CTAs a (b, h) as the kernel compiles them (its split_for; the card test
# holds ops.bwd_info to it): a CTA's hs / split value columns fill two 4 × 4
# tiles
KERNEL_SPLIT = {16: 2, 32: 4, 64: 4}


def kernel_algorithm(r, k, v, logw, u, do, chunk: int, split: int):
    """(dr, dk, dv, dlogw, du) in float64 by the kernel's algorithm (module
    docstring): a forward walk for each chunk's starting state S0, then a
    reverse walk carrying G = dL/d(state after the chunk)."""
    B, S, H, hs = r.shape
    nc, nv = S // chunk, hs // split
    fold = lambda t: t.double().reshape(B, nc, chunk, H, hs).permute(0, 3, 1, 2, 4)
    rc, kc, vc, wc, dc = (fold(t) for t in (r, k, v, logw, do))      # (B, H, nc, c, hs)
    uu = u.double()
    cum = torch.cumsum(wc, dim=3)
    cum_excl = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]], dim=3)
    last = cum[..., -1, :]                                             # (B, H, nc, hs)
    kw = kc * torch.exp(last[..., None, :] - cum)
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.float64), -1)
    # forward walk: the state at each chunk's start, [key, value]
    starts, state = [], torch.zeros(B, H, hs, hs, dtype=torch.float64)
    for c in range(nc):
        starts.append(state)
        state = torch.exp(last[:, :, c])[..., None] * state + torch.einsum(
            "bhjd,bhje->bhde", kw[:, :, c], vc[:, :, c])
    G = torch.zeros(B, H, hs, hs, dtype=torch.float64)
    carry = torch.zeros(B, H, hs, dtype=torch.float64)
    du = torch.zeros(H, hs, dtype=torch.float64)
    out = {n: [None] * nc for n in ("dr", "dk", "dv", "dw")}
    for c in reversed(range(nc)):
        r_, k_, v_, d_ = rc[:, :, c], kc[:, :, c], vc[:, :, c], dc[:, :, c]
        ce, cm, ls = cum_excl[:, :, c], cum[:, :, c], last[:, :, c]
        big = (ls < BIG_DECAY).any(-1)[:, :, None, None]              # per (b, h): the chunk
        q = torch.einsum("bhie,bhje->bhij", d_, v_)
        ql, qd = q * lower, torch.diagonal(q, dim1=2, dim2=3)
        rw, ki = r_ * torch.exp(ce), k_ * torch.exp(-cm)
        # factored: each factor finite while no column decays past −60
        a_f = torch.einsum("bhid,bhjd->bhij", rw, ki) * lower
        x_f = torch.einsum("bhij,bhjd->bhid", ql, ki)
        y_f = torch.einsum("bhij,bhid->bhjd", ql, rw)
        # pairwise, every exponent clipped as the reference clips it
        e = torch.exp(torch.clamp(ce[:, :, :, None, :] - cm[:, :, None, :, :], -60.0, 0.0))
        e = e * lower[:, :, None]
        a_p = torch.einsum("bhid,bhjd,bhijd->bhij", r_, k_, e)
        x_p = torch.einsum("bhij,bhjd,bhijd->bhid", ql, k_, e)
        y_p = torch.einsum("bhij,bhid,bhijd->bhjd", ql, r_, e)
        A = torch.where(big, a_p, a_f) + torch.diag_embed(
            torch.einsum("bhid,hd,bhid->bhi", r_, uu, k_))
        # the state terms: one partial a CTA's value columns, in rank order
        pr = pk = 0.0
        for g in range(split):
            cols = slice(g * nv, (g + 1) * nv)
            pr = pr + torch.einsum("bhie,bhde->bhid", d_[..., cols], starts[c][..., cols])
            pk = pk + torch.einsum("bhje,bhde->bhjd", v_[..., cols], G[..., cols])
        ecx, elc, emc = torch.exp(ce), torch.exp(ls[:, :, None, :] - cm), torch.exp(-cm)
        drp = torch.where(big, x_p + ecx * pr, ecx * (x_f + pr))
        dkp = torch.where(big, y_p + elc * pk, emc * y_f + elc * pk)
        out["dr"][c] = drp + uu[:, None, :] * k_ * qd[..., None]
        out["dk"][c] = dkp + uu[:, None, :] * r_ * qd[..., None]
        out["dv"][c] = (torch.einsum("bhij,bhie->bhje", A, d_)
                        + torch.einsum("bhjd,bhde->bhje", kw[:, :, c], G))
        du = du + torch.einsum("bhid,bhid,bhi->hd", r_, k_, qd)
        a, b = r_ * drp, k_ * dkp
        dw = torch.empty_like(a)
        for t in reversed(range(chunk)):                               # D, a key column each
            dw[:, :, t] = carry - b[:, :, t]
            carry = carry + a[:, :, t] - b[:, :, t]
        out["dw"][c] = dw
        G = torch.exp(ls)[..., None] * G + torch.einsum("bhid,bhie->bhde", rw, d_)
    unfold = lambda xs: torch.stack(xs, 2).permute(0, 2, 3, 1, 4).reshape(B, S, H, hs)
    return (*(unfold(out[n]) for n in ("dr", "dk", "dv", "dw")), du)


def decays(kind: str, B, S, H, hs, chunk, rng):
    """Log-decays (≤ 0) a token: 'mild' 0.01-2; 'inside' every chunk's total
    53-59 (just inside the switch); 'past' 80-96 (past it); 'mixed' chunks
    alternating mild and past; 'one_column' mild but for one key column
    that decays past −60 in every chunk."""
    per = 16 / chunk
    if kind == "mild":
        return -rng.uniform(0.01, 2.0, (B, S, H, hs))
    if kind == "inside":
        return -rng.uniform(3.3, 3.7, (B, S, H, hs)) * per
    if kind == "past":
        return -rng.uniform(5.0, 6.0, (B, S, H, hs)) * per
    w = -rng.uniform(0.01, 2.0, (B, S, H, hs))
    if kind == "mixed":
        strong = (np.arange(S) // chunk) % 2 == 1
        w[:, strong] = -rng.uniform(5.0, 6.0, (B, int(strong.sum()), H, hs)) * per
    elif kind == "one_column":
        w[..., hs // 3] = -rng.uniform(5.0, 6.0, (B, S, H)) * per
    else:
        raise ValueError(kind)
    return w


def _inputs(B, S, H, hs, chunk, kind, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((B, S, H, hs)) for _ in range(4))
    logw = decays(kind, B, S, H, hs, chunk, rng)
    u = rng.standard_normal((H, hs))
    return [torch.from_numpy(x.astype(dtype)) for x in (r, k, v, logw, u, do)]


def _within(got, want, scale, rtol, what):
    err = (got.double() - want.double()).abs()
    bad = err > rtol * scale
    assert not bool(bad.any()), (f"{what}: {int(bad.sum())} elements off, max |err|/scale "
                                 f"{float((err / scale.clamp_min(1e-300)).max())}")


KINDS = ("mild", "inside", "past", "mixed", "one_column")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("hs", [16, 32, 64])
def test_kernel_algorithm_matches_plain_backward(hs, chunk, kind):
    args = _inputs(1, 4 * chunk, 2, hs, chunk, kind, seed=hs + chunk)
    got = kernel_algorithm(*args, chunk, KERNEL_SPLIT[hs])
    want = rwkv6_chunk_bwd_ref(*args, chunk, torch.float64)
    scale = rwkv6_chunk_bwd_scale(*args, chunk)
    for name, g, w, s in zip(NAMES, got, want, scale):
        assert g.shape == w.shape, name
        _within(g, w, s, F64_RTOL, f"{kind} hs {hs} c {chunk}: {name}")


def test_the_switch_is_taken_per_chunk_and_per_batch_row():
    """Two batch rows whose chunks switch form at different places: the
    first row mixed, the second mild; B·H odd."""
    a = _inputs(1, 64, 3, 32, 16, "mixed", seed=5)
    b = _inputs(1, 64, 3, 32, 16, "mild", seed=6)
    args = [torch.cat([x, y]) if x.dim() == 4 else x for x, y in zip(a, b)]
    got = kernel_algorithm(*args, 16, KERNEL_SPLIT[32])
    want = rwkv6_chunk_bwd_ref(*args, 16, torch.float64)
    scale = rwkv6_chunk_bwd_scale(*args, 16)
    for name, g, w, s in zip(NAMES, got, want, scale):
        _within(g, w, s, F64_RTOL, name)


@pytest.mark.parametrize("B,S,H,hs,chunk,kind", [
    (2, 64, 2, 32, 16, "mild"),
    (1, 48, 2, 16, 8, "mixed"),
    (1, 64, 1, 64, 16, "one_column"),
])
def test_kernel_algorithm_matches_jax_grad(B, S, H, hs, chunk, kind):
    """float32 inputs: the algorithm in float64 against ``jax.grad`` of the
    reference's chunked scan, as ``tests/test_torch_rwkv_train.py`` runs it."""
    args = _inputs(B, S, H, hs, chunk, kind, seed=B + S + hs, dtype=np.float32)
    r, k, v, logw, u, do = (x.numpy() for x in args)
    want = jax.grad(lambda *a: jnp.sum(rwkv_chunked(*a, chunk) * do), argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(x) for x in (r, k, v, logw, u)))
    got = kernel_algorithm(*args, chunk, KERNEL_SPLIT[hs])
    scale = rwkv6_chunk_bwd_scale(*args, chunk)
    for name, g, w, s in zip(NAMES, got, want, scale):
        _within(g, torch.from_numpy(np.array(w)), s, GRAD_RTOL, name)


@pytest.mark.parametrize("hs,split", [(16, 1), (16, 4), (32, 2), (32, 8), (64, 2), (64, 8),
                                      (64, 16)])
def test_any_split_of_the_value_columns_gives_the_same_gradients(hs, split):
    """The state terms' partials summed in rank order give the plain
    backward whatever the split, so its choice is one of speed alone."""
    args = _inputs(1, 32, 3, hs, 8, "mixed", seed=hs * split)
    got = kernel_algorithm(*args, 8, split)
    want = rwkv6_chunk_bwd_ref(*args, 8, torch.float64)
    scale = rwkv6_chunk_bwd_scale(*args, 8)
    for name, g, w, s in zip(NAMES, got, want, scale):
        _within(g, w, s, F64_RTOL, f"split {split}: {name}")


def test_backward_refuses_what_the_kernel_does_not_take():
    r, k, v, logw, u, do = _inputs(1, 32, 2, 16, 8, "mild", seed=1, dtype=np.float32)
    with pytest.raises(ValueError, match="do of r's shape"):
        ops.rwkv6_chunk_bwd(r, k, v, logw, u, do[:, :16], 8)
    with pytest.raises(ValueError, match="do of r's shape"):
        ops.rwkv6_chunk_bwd(r, k, v, logw, u, do.double(), 8)
    with pytest.raises(ValueError, match="hs in"):
        ops.rwkv6_chunk_bwd(*(x[..., :8] for x in (r, k, v, logw, u, do)), 8)
    with pytest.raises(ValueError, match="chunk in"):
        ops.rwkv6_chunk_bwd(r, k, v, logw, u, do, 4)
    with pytest.raises(TypeError):
        ops.rwkv6_chunk_bwd(r.double(), k, v, logw, u, do, 8)
    meta = [t.to("meta") for t in (r, k, v, logw, u, do)]
    got = ops.rwkv6_chunk_bwd(*meta, 8)                 # meta: the kernel's shapes, no launch
    assert [g.shape for g in got] == [r.shape] * 4 + [u.shape]


def test_cpu_route_is_the_plain_backward():
    args = _inputs(2, 32, 2, 16, 8, "mild", seed=2, dtype=np.float32)
    got = ops.rwkv6_chunk_bwd(*args, 8)
    want = rwkv6_chunk_bwd_ref(*args, 8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
