"""rwkv6_chunk kernel on the card against its plain version.

These tests need a CUDA device and the CUDA toolkit; on a host without
one they skip.  The file imports no JAX, so on the GPU machine it runs
without the shared fixtures:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_rwkv6_chunk_cuda.py

Tolerance against the plain version computed in float64:
|kernel − plain_f64| ≤ 2e-5 · W per element, where W is the plain WKV of
|r|, |k|, |v| and |u| with the same decays, the magnitude of the summed
terms (float32 sums of up to c + hs products a chunk, carried through
the state); the terminal state likewise within 2e-5 per entry of the
state of |k| and |v| with the same decays.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6_chunk import ops
from repro_torch.kernels.rwkv6_chunk.ref import rwkv6_chunk_ref

WKV_RTOL = 2e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return "cuda"


def _inputs(B, S, H, hs, seed, dev):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hs), dtype=np.float32) for _ in range(3))
    logw = -rng.uniform(0.01, 2.0, (B, S, H, hs)).astype(np.float32)
    u = rng.standard_normal((H, hs), dtype=np.float32)
    return [torch.from_numpy(x).to(dev) for x in (r, k, v, logw, u)]


def _within(got, r, k, v, logw, u, chunk, state=None):
    want, want_st = rwkv6_chunk_ref(r, k, v, logw, u, chunk, torch.float64, return_state=True)
    mag, mag_st = rwkv6_chunk_ref(r.abs(), k.abs(), v.abs(), logw, u.abs(), chunk, torch.float64,
                                  return_state=True)
    err = (got.double() - want).abs()
    assert bool((err <= WKV_RTOL * mag).all()), float((err / mag).max())
    if state is not None:
        assert state.shape == want_st.shape and state.dtype == torch.float32
        err = (state.double() - want_st).abs()
        assert bool((err <= WKV_RTOL * mag_st).all()), float((err / mag_st).max())


SHAPES = [(8, 1024, 32, 64, 16), (1, 4096, 32, 64, 16), (2, 64, 2, 32, 16), (3, 48, 1, 16, 8),
          (1, 128, 4, 64, 16), (2, 40, 3, 64, 8), (1, 32, 5, 32, 8), (4, 16, 2, 16, 16)]


@pytest.mark.parametrize("B,S,H,hs,chunk", SHAPES)
def test_kernel_matches_plain(dev, B, S, H, hs, chunk):
    args = _inputs(B, S, H, hs, B * S + hs, dev)
    before = ops.launches
    got = ops.rwkv6_chunk(*args, chunk)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert got.shape == (B, S, H, hs) and got.dtype == torch.float32
    assert torch.equal(got, ops.rwkv6_chunk(*args, chunk))        # deterministic
    out, state = ops.rwkv6_chunk(*args, chunk, return_state=True)
    assert torch.equal(out, got)
    assert torch.equal(state, ops.rwkv6_chunk(*args, chunk, return_state=True)[1])
    _within(got, *args, chunk, state=state)


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("hs,chunk", [(16, 8), (16, 16), (32, 8), (32, 16), (64, 8), (64, 16)])
@pytest.mark.parametrize("segments", [1, 2, 3, 4, 8])
def test_state_and_output_at_every_segment_count(dev, B, hs, chunk, segments):
    """Every (hs, c) the kernel takes, cut into 1 to 8 sequence segments
    (the state-only pass, then the walk from the combined state), with
    decays that are mostly mild and now and then past the factored
    form's limit (a chunk's cumulative decay below −60)."""
    H, S = 2, 16 * chunk
    r, k, v, logw, u = _inputs(B, S, H, hs, 100 * hs + chunk + segments, dev)
    gen = torch.Generator(device=dev).manual_seed(segments)
    logw = torch.where(torch.rand(logw.shape, generator=gen, device=dev) < 0.02, logw * 40, logw)
    args = [x.contiguous() for x in (r, k, v, logw, u)]
    out, state = ops._launch(args, chunk, segments, True)
    _within(out, *args, chunk, state=state)
    again = ops._launch(args, chunk, segments, True)
    assert torch.equal(out, again[0]) and torch.equal(state, again[1])


@pytest.mark.parametrize("hs,chunk", [(16, 8), (16, 16), (32, 8), (32, 16), (64, 8), (64, 16)])
@pytest.mark.parametrize("segments", [1, 4])
def test_decay_just_inside_the_factored_form(dev, hs, chunk, segments):
    """Log-decays of −3.3 to −3.7 a token at c 16 (twice that at c 8) put
    every chunk's cumulative decay in [−59.2, −52.8], just above the −60
    below which the pairwise form takes over: the factored A's and state's
    exponentials are e^{±56} or so here, the largest they get."""
    H, S = 2, 16 * chunk
    r, k, v, _, u = _inputs(1, S, H, hs, 7 * hs + chunk + segments, dev)
    gen = torch.Generator(device=dev).manual_seed(hs + chunk)
    logw = -(3.3 + 0.4 * torch.rand(r.shape, generator=gen, device=dev)) * (16 / chunk)
    cum_last = logw.view(1, S // chunk, chunk, H, hs).sum(2)
    assert bool((cum_last > -60).all()) and bool((cum_last < -52).all())
    args = [x.contiguous() for x in (r, k, v, logw, u)]
    out, state = ops._launch(args, chunk, segments, True)
    _within(out, *args, chunk, state=state)


def test_segment_plan_gives_the_one_walk_result(dev):
    """The wrapper's own choice of segments at B = 1 and the same call in
    one walk agree within the tolerance (their sums differ in order)."""
    args = [x.contiguous() for x in _inputs(1, 1024, 32, 64, 9, dev)]
    assert ops.segments(1, 32, 64) == 8
    out, state = ops.rwkv6_chunk(*args, 16, return_state=True)
    _within(out, *args, 16, state=state)
    one, one_state = ops._launch(args, 16, 1, True)
    _within(one, *args, 16, state=one_state)


def test_kernel_takes_non_contiguous_inputs(dev):
    """Inputs that are not contiguous (a slice of a wider tensor) give the
    same result as their contiguous copies."""
    r, k, v, logw, u = _inputs(2, 64, 4, 32, 5, dev)
    wide = [torch.cat([x, x], dim=2)[:, :, :4] for x in (r, k, v, logw)]
    assert not wide[0].is_contiguous()
    assert torch.equal(ops.rwkv6_chunk(*wide, u, 16), ops.rwkv6_chunk(r, k, v, logw, u, 16))


def test_kernel_strong_decay_stays_finite(dev):
    """Decays down to −30 a step: every chunk takes the pairwise form, whose
    exponents are ≤ 0 (clipped at −60), so nothing overflows; at B = 1 the
    sequence is cut into segments too."""
    for B, S in ((1, 64), (1, 1024), (8, 256)):
        r, k, v, _, u = _inputs(B, S, 2, 64, 6, dev)
        logw = -torch.rand(r.shape, generator=torch.Generator(device=dev).manual_seed(0),
                           device=dev) * 30
        got, state = ops.rwkv6_chunk(r, k, v, logw, u, 16, return_state=True)
        assert torch.isfinite(got).all() and torch.isfinite(state).all()
        _within(got, r, k, v, logw, u, 16, state=state)


def test_kernel_refuses_unsupported(dev):
    r, k, v, logw, u = _inputs(1, 32, 2, 16, 7, dev)
    with pytest.raises(ValueError):
        ops.rwkv6_chunk(r, k, v, logw, u, 32)
    with pytest.raises(TypeError):
        ops.rwkv6_chunk(r.half(), k, v, logw, u, 16)
    with pytest.raises(ValueError):
        ops.rwkv6_chunk(r, k, v, logw, u.cpu(), 16)
