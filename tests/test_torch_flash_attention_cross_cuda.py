"""The flash_attention kernel on a non-causal call whose keys are not its
queries (Sk ≠ S: an encoder–decoder's cross-attention), on the card,
against its plain version and a float64 softmax.

These tests need a CUDA device and the CUDA toolkit; on a host without
one they skip.  The file imports no JAX, so on the GPU machine it runs
without the shared fixtures:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_flash_attention_cross_cuda.py

The K/V lengths: one key; fewer keys than a tile (37: the first K/V tile
is the last, and the bf16 kernel's TMA hands it zero rows past Sk, which
must be masked before the row max); a length off both tiles (1,000 and
70); far more keys than queries (5,000 against 40); and the shapes of
``chip_smoke.py`` phase 1's rows, seamless-M4T's cross-attention (8, 512
queries, 2,048 keys, 16 heads of 64) in bf16 and (Sq 40, Sk 70) in
float32.  Tolerances, as ``tests/test_torch_flash_attention_cuda.py``'s:
against the float64 softmax (``ref.attention_limit``) per element, 2e-5 ·
max|v| in float32 and 2⁻⁷ · (|o| + ‖p‖₂ · max|v|) in bf16; against the
plain blockwise version twice that; the log-sum-exp within 1e-4 + 1e-5 ·
|lse| of float64's; ``attention_train``'s gradients (the kernel's forward,
the plain backward) within 1e-4 · max|g| of the plain forward's, in
float32.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_limit, attention_lse_dense,
                                                      block_attn_bwd, block_attn_fwd,
                                                      flash_attention_ref)

LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
LENGTHS = [(200, 1), (200, 37), (130, 1000), (40, 70), (40, 5000), (1000, 130)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return "cuda"


def _inputs(B, S, Sk, N, Kh, dh, dtype, seed, dev):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, N, dh), dtype=np.float32)
    k, v = (rng.standard_normal((B, Sk, Kh, dh), dtype=np.float32) for _ in range(2))
    return [torch.from_numpy(x).to(dev, dtype) for x in (q, k, v)]


def _check(q, k, v):
    B, S, N, dh = q.shape
    before = ops.launches
    out, lse = ops.flash_attention_gqa(q, k, v, False, return_lse=True)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert out.shape == (B, S, N * dh) and out.dtype == q.dtype and lse.shape == (B, N, S)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    out2, lse2 = ops.flash_attention_gqa(q, k, v, False, return_lse=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)                  # deterministic
    assert torch.equal(out, ops.flash_attention_gqa(q, k, v, False))
    want, lim = attention_limit(q, k, v, False)
    assert float(((out.double() - want).abs() / lim).max()) <= 1
    plain = flash_attention_ref(q, k, v, False).double()
    assert float(((out.double() - plain).abs() / lim).max()) <= 2
    want_l = attention_lse_dense(q, k, False)
    assert float(((lse.double() - want_l).abs() / (LSE_ATOL + LSE_RTOL * want_l.abs())).max()) <= 1


@pytest.mark.parametrize("S,Sk", LENGTHS)
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cross_kernel_matches_plain_and_float64(dev, dtype, dh, G, S, Sk):
    Kh = 2
    _check(*_inputs(2, S, Sk, G * Kh, Kh, dh, dtype, S + 7 * Sk + dh + G, dev))


@pytest.mark.parametrize("shape,dtype", [((8, 512, 2048, 16, 16, 64), torch.bfloat16),
                                         ((8, 1024, 1024, 16, 16, 64), torch.bfloat16),
                                         ((2, 40, 70, 8, 2, 32), torch.float32)],
                         ids=["seamless_cross_bf16", "seamless_encoder_bf16", "odd_f32"])
def test_phase_one_shapes(dev, shape, dtype):
    B, S, Sk, N, Kh, dh = shape
    _check(*_inputs(B, S, Sk, N, Kh, dh, dtype, 11, dev))


def test_attention_train_gradients_with_other_key_count(dev):
    """``attention_train(..., causal=False)`` with Sk ≠ S: the kernel's
    forward and lse feed the plain backward, whose gradients match those
    of the plain forward's lse in float32."""
    B, S, Sk, Kh, G, dh = 2, 90, 300, 2, 3, 64
    q, k, v = _inputs(B, S, Sk, Kh * G, Kh, dh, torch.float32, 5, dev)
    dout = torch.randn(B, S, Kh * G * dh, device=dev, generator=torch.Generator(dev).manual_seed(1))
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    out = ops.attention_train(tq, tk, tv, False, 64)
    got = torch.autograd.grad(out, (tq, tk, tv), dout)
    qp = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    kp = torch.arange(Sk, dtype=torch.int32, device=dev).expand(B, Sk)
    o, lse = block_attn_fwd(q, k, v, qp, kp, False, None, 512, 64)
    want = block_attn_bwd(q, k, v, o, lse, dout, qp, kp, False, None, 64)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_causal_call_with_other_key_count_raises_before_a_launch(dev):
    q, k, v = _inputs(1, 64, 96, 4, 2, 64, torch.bfloat16, 0, dev)
    before = ops.launches
    with pytest.raises(ValueError, match="causal call takes as many keys"):
        ops.flash_attention_gqa(q, k, v, True)
    assert ops.launches == before
