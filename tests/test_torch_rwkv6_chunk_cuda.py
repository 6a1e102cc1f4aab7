"""rwkv6_chunk kernel on the card against its plain version.

These tests need a CUDA device and the CUDA toolkit; on a host without
one they skip.  The file imports no JAX, so on the GPU machine it runs
without the shared fixtures:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_rwkv6_chunk_cuda.py

Tolerance against the plain version computed in float64:
|kernel − plain_f64| ≤ 2e-5 · W per element, where W is the plain WKV of
|r|, |k|, |v| and |u| with the same decays, the magnitude of the summed
terms (float32 sums of up to c + hs products a chunk, carried through
the state).
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


def _within(got, r, k, v, logw, u, chunk):
    want = rwkv6_chunk_ref(r, k, v, logw, u, chunk, torch.float64)
    mag = rwkv6_chunk_ref(r.abs(), k.abs(), v.abs(), logw, u.abs(), chunk, torch.float64)
    err = (got.double() - want).abs()
    assert bool((err <= WKV_RTOL * mag).all()), float((err / mag).max())


@pytest.mark.parametrize("B,S,H,hs,chunk", [
    (8, 1024, 32, 64, 16), (1, 4096, 32, 64, 16), (2, 64, 2, 32, 16), (3, 48, 1, 16, 8),
    (1, 128, 4, 64, 16), (2, 40, 3, 64, 8), (1, 32, 5, 32, 8), (4, 16, 2, 16, 16)])
def test_kernel_matches_plain(dev, B, S, H, hs, chunk):
    args = _inputs(B, S, H, hs, B * S + hs, dev)
    before = ops.launches
    got = ops.rwkv6_chunk(*args, chunk)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert got.shape == (B, S, H, hs) and got.dtype == torch.float32
    assert torch.equal(got, ops.rwkv6_chunk(*args, chunk))        # deterministic
    _within(got, *args, chunk)


def test_kernel_takes_non_contiguous_inputs(dev):
    """Inputs that are not contiguous (a slice of a wider tensor) give the
    same result as their contiguous copies."""
    r, k, v, logw, u = _inputs(2, 64, 4, 32, 5, dev)
    wide = [torch.cat([x, x], dim=2)[:, :, :4] for x in (r, k, v, logw)]
    assert not wide[0].is_contiguous()
    assert torch.equal(ops.rwkv6_chunk(*wide, u, 16), ops.rwkv6_chunk(r, k, v, logw, u, 16))


def test_kernel_strong_decay_stays_finite(dev):
    """Decays down to −30 a step: every exponent of the chunked form is
    ≤ 0 (clipped at −60), so nothing overflows."""
    r, k, v, _, u = _inputs(1, 64, 2, 64, 6, dev)
    logw = -torch.rand(r.shape, generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev) * 30
    got = ops.rwkv6_chunk(r, k, v, logw, u, 16)
    assert torch.isfinite(got).all()
    _within(got, r, k, v, logw, u, 16)


def test_kernel_refuses_unsupported(dev):
    r, k, v, logw, u = _inputs(1, 32, 2, 16, 7, dev)
    with pytest.raises(ValueError):
        ops.rwkv6_chunk(r, k, v, logw, u, 32)
    with pytest.raises(TypeError):
        ops.rwkv6_chunk(r.half(), k, v, logw, u, 16)
    with pytest.raises(ValueError):
        ops.rwkv6_chunk(r, k, v, logw, u.cpu(), 16)
