"""The port's chunked RWKV-6 WKV on the CPU against the JAX reference.

The port's plain version (``kernels/rwkv6_chunk/ref.py``, which its
wrapper takes for CPU tensors) is held against the reference's Pallas
kernel in interpret mode and against its ``models/rwkv6.rwkv_chunked``,
on the shapes of ``tests/test_kernels.py``, and against the step-by-step
recurrence.  Tolerance: the reference's own for these comparisons, atol
2e-4 and rtol 2e-3 (float32 sums over chunks in another order).  The
terminal state (``return_state``, the prefill's cache) is held to a
float64 recurrence within 2e-5 per entry of the state of |k| and |v|, as
is the reference's ``_rwkv_final_state``; the segment plan of the
kernel's wrapper is checked as a pure function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels.rwkv6_chunk.ops import rwkv6_chunk as ref_kernel
from repro.models import Model as RefModel
from repro.models import lm as ref_lm
from repro.models import rwkv6 as ref_rwkv6
from repro_torch import configs, convert
from repro_torch.kernels.rwkv6_chunk import ops, rwkv6_chunk_ref
from repro_torch.models import rwkv6

TOL = dict(atol=2e-4, rtol=2e-3)


def _inputs(B, S, H, hs, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hs)).astype(np.float32) for _ in range(3))
    logw = -rng.uniform(0.01, 2.0, (B, S, H, hs)).astype(np.float32)
    u = rng.standard_normal((H, hs)).astype(np.float32)
    return r, k, v, logw, u


@pytest.mark.parametrize("B,S,H,hs,chunk", [(2, 64, 2, 32, 16), (1, 128, 4, 64, 16),
                                            (3, 48, 1, 16, 8)])
def test_plain_matches_pallas_and_reference(B, S, H, hs, chunk):
    arrs = _inputs(B, S, H, hs, seed=B * S + hs)
    before = ops.launches
    got = ops.rwkv6_chunk(*map(torch.from_numpy, arrs), chunk).numpy()
    assert ops.launches == before                     # the CPU takes the plain version
    pallas = np.asarray(ref_kernel(*map(jnp.asarray, arrs), chunk=chunk))    # interpret mode
    chunked = np.asarray(ref_rwkv6.rwkv_chunked(*map(jnp.asarray, arrs), chunk))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, chunked, **TOL)
    f64 = rwkv6_chunk_ref(*map(torch.from_numpy, arrs), chunk, dtype=torch.float64)
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(got, f64.numpy(), **TOL)


def test_plain_equals_step_recurrence():
    """Chunked WKV == step-by-step recurrence (the reference's own check)."""
    B, S, H, hs = 2, 32, 3, 8
    r, k, v, logw, u = _inputs(B, S, H, hs, seed=0)
    got = rwkv6_chunk_ref(*map(torch.from_numpy, (r, k, v, logw, u)), 8).numpy()
    state = np.zeros((B, H, hs, hs), np.float32)
    w = np.exp(logw)
    want = np.zeros((B, S, H, hs), np.float32)
    for t in range(S):
        kv = np.einsum("bhk,bhd->bhkd", k[:, t], v[:, t])
        want[:, t] = np.einsum("bhk,bhkd->bhd", r[:, t], state + u[None, :, :, None] * kv)
        state = w[:, t][..., None] * state + kv
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_time_mix_pads_a_ragged_sequence(use_kernel):
    """S = 21 is not a multiple of the smoke chunk (8): time_mix pads it
    for the WKV and cuts it back, as the reference does."""
    cfg = ref_configs.get_smoke("rwkv6_1_6b").replace(dtype="float32")
    ref_params = RefModel(cfg).init(jax.random.PRNGKey(0))
    p_ref = jax.tree.map(lambda a: a[0], ref_params["layers"])["mix"]
    p = convert.lm_params(ref_params, device="cpu")["layers"][0]["mix"]
    x = np.random.default_rng(3).standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    want = np.asarray(ref_rwkv6.time_mix(p_ref, cfg, jnp.asarray(x), use_kernel=use_kernel))
    pcfg = configs.get_smoke("rwkv6_1_6b").replace(dtype="float32")
    got = rwkv6.time_mix(p, pcfg, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 21, cfg.d_model)
    np.testing.assert_allclose(got, want, **TOL)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    r, k, v, logw, u = map(torch.from_numpy, _inputs(1, 32, 2, 16, seed=1))
    with pytest.raises(TypeError):
        ops.rwkv6_chunk(r.double(), k, v, logw, u, 8)
    with pytest.raises(TypeError):
        ops.rwkv6_chunk(r, k, v, logw, u.bfloat16(), 8)
    with pytest.raises(ValueError, match="S % chunk"):
        ops.rwkv6_chunk(r[:, :20], k[:, :20], v[:, :20], logw[:, :20], u, 8)
    with pytest.raises(ValueError, match="hs in"):
        ops.rwkv6_chunk(r[..., :8], k[..., :8], v[..., :8], logw[..., :8], u[:, :8], 8)
    with pytest.raises(ValueError, match="chunk in"):
        ops.rwkv6_chunk(r, k, v, logw, u, 4)
    with pytest.raises(ValueError, match="u of shape"):
        ops.rwkv6_chunk(r, k, v, logw, u[:1], 8)
    with pytest.raises(ValueError, match="one \\(B, S, H, hs\\) shape"):
        ops.rwkv6_chunk(r, k[:, :16], v, logw, u, 8)
    meta = [t.to("meta") for t in (r, k, v, logw, u)]
    out, state = ops.rwkv6_chunk(*meta, 8, return_state=True)   # meta: shapes, no launch
    assert out.shape == r.shape and state.shape == (1, 2, 16, 16) and out.device.type == "meta"


def _state_f64(k, v, logw):
    """The WKV state after the whole sequence by the step recurrence in
    float64, S_t = diag(e^{w_t}) S_{t-1} + k_tᵀ v_t, and the same state of
    |k| and |v| (its magnitude W)."""
    k, v, w = (np.asarray(a, np.float64) for a in (k, v, logw))
    B, S, H, hs = k.shape
    state, mag = np.zeros((B, H, hs, hs)), np.zeros((B, H, hs, hs))
    for t in range(S):
        d = np.exp(w[:, t])[..., None]
        state = d * state + np.einsum("bhk,bhd->bhkd", k[:, t], v[:, t])
        mag = d * mag + np.einsum("bhk,bhd->bhkd", np.abs(k[:, t]), np.abs(v[:, t]))
    return state, mag


STATE_RTOL = 2e-5                  # of W per entry, as the card's gate (float32 sums)


@pytest.mark.parametrize("B,S,H,hs,chunk", [(2, 64, 2, 32, 16), (1, 128, 4, 64, 16),
                                            (3, 48, 1, 16, 8)])
def test_plain_state_matches_reference_final_state(B, S, H, hs, chunk):
    """The state the plain chunked loop carries equals the float64
    recurrence within 2e-5·W per entry, as does the reference's
    ``_rwkv_final_state`` (one cumsum over the sequence); so the two are
    within 4e-5·W of each other."""
    r, k, v, logw, u = _inputs(B, S, H, hs, seed=7 * S + hs)
    out, state = rwkv6_chunk_ref(*map(torch.from_numpy, (r, k, v, logw, u)), chunk,
                                 return_state=True)
    assert state.shape == (B, H, hs, hs) and state.dtype == torch.float32
    want, mag = _state_f64(k, v, logw)
    ref = np.asarray(ref_lm._rwkv_final_state(*map(jnp.asarray, (r, k, v, logw))))
    assert np.all(np.abs(state.numpy() - want) <= STATE_RTOL * mag)
    assert np.all(np.abs(ref - want) <= STATE_RTOL * mag)
    assert np.all(np.abs(state.numpy() - ref) <= 2 * STATE_RTOL * mag)
    got_out, got_state = ops.rwkv6_chunk(*map(torch.from_numpy, (r, k, v, logw, u)), chunk,
                                         return_state=True)          # the CPU wrapper's route
    assert torch.equal(got_out, out) and torch.equal(got_state, state)
    assert torch.equal(ops.rwkv6_chunk(*map(torch.from_numpy, (r, k, v, logw, u)), chunk), out)


def test_strong_decay_state_within_the_clip_bound():
    """Decays down to −30 a token, so total − cum passes −60 for most
    tokens: the reference clips that exponent at −60 and the chunked loop
    does not.  Each entry of the two states differs by at most
    e^{−60}·Σ_t |k_t||v_t| (the clip) plus their float32 rounding, and the
    port is within 2e-5·W of the float64 recurrence."""
    B, S, H, hs, chunk = 2, 64, 2, 16, 8
    r, k, v, _, u = _inputs(B, S, H, hs, seed=11)
    logw = -np.random.default_rng(12).uniform(0.0, 30.0, (B, S, H, hs)).astype(np.float32)
    _, state = rwkv6_chunk_ref(*map(torch.from_numpy, (r, k, v, logw, u)), chunk,
                               return_state=True)
    want, mag = _state_f64(k, v, logw)
    ref = np.asarray(ref_lm._rwkv_final_state(*map(jnp.asarray, (r, k, v, logw))))
    clip = np.exp(-60.0) * np.einsum("bshk,bshd->bhkd", np.abs(k).astype(np.float64),
                                     np.abs(v).astype(np.float64))
    assert np.all(np.abs(state.numpy() - want) <= STATE_RTOL * mag)
    assert np.all(np.abs(state.numpy() - ref) <= clip + 2 * STATE_RTOL * mag)


def test_time_mix_state_of_a_ragged_sequence_is_the_state_at_s():
    """S = 21 is padded to 24 (chunk 8) for the WKV: the padded tokens have
    logw = 0 and k = 0, so they neither decay nor add, and the state the
    call returns is the state after token 21 of the unpadded heads."""
    cfg = ref_configs.get_smoke("rwkv6_1_6b").replace(dtype="float32")
    p = convert.lm_params(RefModel(cfg).init(jax.random.PRNGKey(0)), device="cpu")
    p = p["layers"][0]["mix"]
    pcfg = configs.get_smoke("rwkv6_1_6b").replace(dtype="float32")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 21, cfg.d_model))
                         .astype(np.float32))
    heads, g = rwkv6.wkv_inputs(p, pcfg, x)
    out, state = rwkv6.time_mix_out(p, pcfg, x, heads, g, return_state=True)
    assert out.shape == (2, 21, cfg.d_model)
    assert torch.equal(out, rwkv6.time_mix_out(p, pcfg, x, heads, g))
    want, mag = _state_f64(heads[1].numpy(), heads[2].numpy(), heads[3].numpy())
    assert state.shape == want.shape
    assert np.all(np.abs(state.numpy() - want) <= STATE_RTOL * mag)


@pytest.mark.parametrize("B,H,n_chunks,want", [
    (8, 32, 64, 1),     # the prefill's batch fills the card in one walk
    (4, 32, 64, 2), (2, 32, 64, 4), (1, 32, 64, 8), (1, 32, 256, 8),
    (1, 32, 15, 1),     # segments of fewer than MIN_SEGMENT chunks are not cut
    (1, 2, 32, 4), (3, 1, 6, 1), (1, 1, 1, 1)])
def test_segment_plan(B, H, n_chunks, want):
    p = ops.segments(B, H, n_chunks)
    assert p == want
    assert B * H * p <= 2 * ops.SMS or p == 1
    seg = -(-n_chunks // p)                       # the kernel's segment length
    assert (p - 1) * seg < n_chunks               # no segment is empty
