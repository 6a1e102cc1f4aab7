"""The port's SSM branch (``models/ssm.py``) on the CPU against the JAX
reference (``repro.models.ssm``), piece by piece.

Weights: the reference's ``init_ssm`` at Hymba's smoke config (d 128, 4
heads of 32, state 4, chunk 8) carried across with ``convert``, with
``A_log`` and ``dt_bias`` drawn from numpy (the reference initialises
them to zero), one head's ``A_log`` large enough that a chunk's
cumulative decay passes −60 (the reference clips its in-chunk decays
there; the port clips them the same way).  Inputs come from numpy seeds.

Tolerances:
- float32: within 1e-5 of the compared field's largest magnitude;
- bfloat16 weights and inputs: the reference's own band
  (``tests/test_archs.py``: atol 0.08, rtol 0.05), elementwise: the two
  frameworks round the projections and the conv at other places;
- the terminal state against the reference's ``_ssm_final_state``:
  1e-5 of its largest magnitude plus e⁻⁶⁰ · Σ_s |B_s| dt_s |x_s|: the
  reference clips each position's decay to the end at exp(−60), the port
  the decay across whole chunks, and both factors lie between the exact
  decay and max(it, e⁻⁶⁰), so they differ by no more than that;
- gradients through ``ssm_chunked`` against ``jax.grad`` of the
  reference's: 1e-4 of each gradient's largest magnitude.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro.models import ssm as ref_ssm
from repro_torch import configs, convert
from repro_torch.models import ssm

ARCH = "hymba_1_5b"
BAND = dict(atol=0.08, rtol=0.05)
STRONG_A = math.log(20.0)            # a head decaying by ~20·dt a position


def _params(dtype="float32", seed=0):
    cfg = ref_configs.get_smoke(ARCH).replace(dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    d_inner = cfg.n_heads * cfg.head_dim
    p = dict(ref_ssm.init_ssm(jax.random.PRNGKey(seed), cfg, jdt, d_inner))
    rng = np.random.default_rng(seed + 1)
    H = cfg.ssm_heads
    a_log = rng.uniform(-1.0, 0.5, H).astype(np.float32)
    a_log[-1] = STRONG_A
    p["A_log"] = jnp.asarray(a_log)
    p["dt_bias"] = jnp.asarray(rng.uniform(-1.0, 1.0, H).astype(np.float32))
    p["Dskip"] = jnp.asarray(rng.standard_normal((H, d_inner // H)).astype(np.float32))
    return cfg, p, convert.lm_stacked(p, device="cpu")


def _u(cfg, B, S, seed, dtype="float32"):
    u = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(u, jdt), convert._tensor(jnp.asarray(u, jdt), "cpu")


def _close(got: torch.Tensor, want, f32: bool, what: str, extra=0.0):
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, what
    if f32:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max() + extra, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, **BAND, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_and_inputs_match_reference(dtype):
    cfg, rp, p = _params(dtype)
    f32 = dtype == "float32"
    ju, u = _u(cfg, 2, 21, 3, dtype)
    xin = ju @ rp["wx"]
    _close(ssm._conv1d(convert._tensor(xin, "cpu"), p["conv"]),
           ref_ssm._conv1d(xin, rp["conv"]), f32, "_conv1d")
    want = ref_ssm._inputs(rp, cfg, ju)
    got = ssm._project(p, cfg, u)[1]
    for name, g, w in zip(("x", "B", "C", "dt", "loga"), got, want):
        assert g.dtype == torch.float32, name
        _close(g, w, f32, name)


def _scan_inputs(cfg, B, S, seed, strong: bool):
    rng = np.random.default_rng(seed)
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.head_dim
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, H, N)).astype(np.float32) for _ in range(2))
    dt = rng.uniform(0.05, 1.0, (B, S, H)).astype(np.float32)
    loga = -dt * rng.uniform(0.1, 2.0, H).astype(np.float32)
    if strong:
        loga[..., -1] = -dt[..., -1] * 20.0            # a chunk of 8 decays by up to ~160
    D = rng.standard_normal((H, P)).astype(np.float32)
    return x, Bm, Cm, dt, loga, D


@pytest.mark.parametrize("S,strong", [(64, False), (64, True), (8, False)])
def test_ssm_chunked_matches_reference(S, strong):
    """S a multiple of the chunk (the reference's ``ssm_chunked`` takes no
    other); every chunk at once against the reference's scan."""
    cfg = ref_configs.get_smoke(ARCH)
    arrs = _scan_inputs(cfg, 2, S, 5 + S, strong)
    if strong:
        assert float(np.cumsum(arrs[4].reshape(2, -1, 8, cfg.ssm_heads), 2).min()) < -60
    want = ref_ssm.ssm_chunked(*map(jnp.asarray, arrs), cfg.ssm_chunk)
    got, h = ssm.ssm_chunked(*map(torch.from_numpy, arrs), cfg.ssm_chunk, return_state=True)
    _close(got, want, True, "y")
    assert torch.equal(got, ssm.ssm_chunked(*map(torch.from_numpy, arrs), cfg.ssm_chunk))
    # the state after the last position, by a plain loop over positions in float64
    x, Bm, _, dt, loga, _ = (torch.from_numpy(a).double() for a in arrs)
    hh = torch.zeros(h.shape, dtype=torch.float64)
    for s in range(S):
        hh = torch.exp(loga[:, s])[..., None, None] * hh + torch.einsum(
            "bhn,bh,bhp->bhnp", Bm[:, s], dt[:, s], x[:, s])
    _close(h, hh.numpy(), True, "terminal state")
    with pytest.raises(ValueError, match="multiple"):
        ssm.ssm_chunked(*(torch.from_numpy(a[:, :S - 1]) if a.ndim > 2 else torch.from_numpy(a)
                          for a in arrs), cfg.ssm_chunk)


@pytest.mark.parametrize("strong", [False, True])
def test_ssm_chunked_gradient_matches_reference(strong):
    """The chunk-to-chunk pass is one product, so autograd carries the
    gradient of every input through it (Hymba training will need it)."""
    cfg = ref_configs.get_smoke(ARCH)
    arrs = _scan_inputs(cfg, 2, 32, 21, strong)
    wy = np.random.default_rng(22).standard_normal(arrs[0].shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(ref_ssm.ssm_chunked(*a, cfg.ssm_chunk) * wy),
                    argnums=tuple(range(6)))(*map(jnp.asarray, arrs))
    ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
    (ssm.ssm_chunked(*ins, cfg.ssm_chunk) * torch.from_numpy(wy)).sum().backward()
    for name, t, w in zip(("x", "B", "C", "dt", "loga", "D"), ins, want):
        got, w = t.grad.numpy(), np.asarray(w)
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("S", [40, 37, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_branch_and_final_state_match_reference(dtype, S):
    """S a multiple of the chunk (40), ragged (37) and shorter than the
    conv (3): the branch's output, and its terminal state and conv tail
    against the reference's ``_ssm_final_state``."""
    cfg, rp, p = _params(dtype, seed=S)
    f32 = dtype == "float32"
    ju, u = _u(cfg, 2, S, 7 + S, dtype)
    want = ref_ssm.ssm_branch(rp, cfg, ju)
    got, st = ssm.ssm_branch(p, cfg, u, return_state=True)
    assert got.dtype == u.dtype
    _close(got, want, f32, "ssm_branch")
    assert torch.equal(got, ssm.ssm_branch(p, cfg, u))
    ref_st = ref_lm._ssm_final_state(rp, cfg, ju)
    x, Bm, _, dt, _ = (np.abs(np.asarray(t, np.float64)) for t in ref_ssm._inputs(rp, cfg, ju))
    clip = math.exp(-60.0) * float(np.einsum("bshn,bsh,bshp->bhnp", Bm, dt, x).max())
    _close(st["h"], ref_st["h"], f32, "terminal state", extra=clip)
    assert st["conv"].shape == ref_st["conv"].shape and st["conv"].dtype == u.dtype
    _close(st["conv"], ref_st["conv"], f32, "conv tail")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_step_matches_reference(dtype):
    cfg, rp, p = _params(dtype, seed=4)
    f32 = dtype == "float32"
    ju, u = _u(cfg, 3, 1, 11, dtype)
    rng = np.random.default_rng(12)
    H, d_inner = cfg.ssm_heads, cfg.n_heads * cfg.head_dim
    h0 = rng.standard_normal((3, H, cfg.ssm_state, d_inner // H)).astype(np.float32)
    conv = rng.standard_normal((3, 4, d_inner)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref_state = {"h": jnp.asarray(h0), "conv": jnp.asarray(conv, jdt)}
    state = {"h": torch.from_numpy(h0), "conv": convert._tensor(ref_state["conv"], "cpu")}
    want, want_st = ref_ssm.ssm_step(rp, cfg, ju, ref_state)
    got, st = ssm.ssm_step(p, cfg, u, state)
    _close(got, want, f32, "ssm_step")
    _close(st["h"], want_st["h"], f32, "h")
    assert torch.equal(st["conv"], convert._tensor(want_st["conv"], "cpu"))


def test_step_continues_the_branch():
    """Float32: the branch over S + 1 positions ends where the branch over S
    and one step from its state end (the state is the decode cache)."""
    cfg, _, p = _params("float32", seed=9)
    _, u = _u(cfg, 2, 25, 13)
    full = ssm.ssm_branch(p, cfg, u)
    _, st = ssm.ssm_branch(p, cfg, u[:, :24], return_state=True)
    last, _ = ssm.ssm_step(p, cfg, u[:, 24:], st)
    _close(last, full[:, 24:].numpy(), True, "step after the branch")
