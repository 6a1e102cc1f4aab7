"""The flash_attention kernel with a sliding window, on the card, against
its plain version and a float64 softmax.

These tests need a CUDA device and the CUDA toolkit; on a host without
one they skip.  The file imports no JAX, so on the GPU machine it runs
without the shared fixtures:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_flash_attention_window_cuda.py

A window w lets query i see the keys (i − w, i]: the w keys up to and
including its own.  Tolerances, as ``tests/test_torch_flash_attention_cuda.py``'s:
against the float64 softmax over the band (``ref.attention_limit`` with
the window), per element, 2e-5 · max|v| in float32 and 2⁻⁷ · (|o| +
‖p‖₂ · max|v|) in bf16; against the plain blockwise version (which rounds
in bf16 at other places) twice that; the log-sum-exp over the band within
1e-4 + 1e-5 · |lse| of float64's, and within twice that of the plain
version's.  S = 1,200 is ragged against both tiles (128 rows in bf16, 64
in float32) and puts rows with no key in their band's first tile (the
kernel's mask value would otherwise meet itself in the exponent) in the
windows from 64 to 1,024.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_limit, attention_lse_dense,
                                                      block_attn_fwd, flash_attention_ref)

S = 1200
WINDOWS = (1, 63, 64, 127, 128, 129, 1000, 1024, S + 5)
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return "cuda"


def _inputs(B, S, N, Kh, dh, dtype, seed, dev):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, N, dh), dtype=np.float32)
    k, v = (rng.standard_normal((B, S, Kh, dh), dtype=np.float32) for _ in range(2))
    return [torch.from_numpy(x).to(dev, dtype) for x in (q, k, v)]


def _plain_lse(q, k, v, window):
    B, S, N, _ = q.shape
    pos = torch.arange(S, dtype=torch.int32, device=q.device).expand(B, S)
    return block_attn_fwd(q, k, v, pos, pos, True, window, 512, 1024)[1].reshape(B, N, S)


@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_windowed_kernel_matches_plain_and_float64(dev, dtype, dh, window, G):
    B, Kh = 2, 2
    q, k, v = _inputs(B, S, G * Kh, Kh, dh, dtype, 7 * window + dh + G, dev)
    before = ops.launches
    out, lse = ops.flash_attention_gqa(q, k, v, True, return_lse=True, window=window)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert out.shape == (B, S, G * Kh * dh) and out.dtype == dtype
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    out2, lse2 = ops.flash_attention_gqa(q, k, v, True, return_lse=True, window=window)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)                  # deterministic
    assert torch.equal(out, ops.flash_attention_gqa(q, k, v, True, window=window))
    want, lim = attention_limit(q, k, v, True, window)
    err = (out.double() - want).abs()
    assert float((err / lim).max()) <= 1
    plain = flash_attention_ref(q, k, v, True, window).double()
    assert float(((out.double() - plain).abs() / lim).max()) <= 2
    want_l = attention_lse_dense(q, k, True, window)
    lse_lim = LSE_ATOL + LSE_RTOL * want_l.abs()
    assert float(((lse.double() - want_l).abs() / lse_lim).max()) <= 1
    assert float(((lse.double() - _plain_lse(q, k, v, window).double()).abs()
                  / lse_lim).max()) <= 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rows_without_a_key_in_their_first_band_tile(dev, dtype):
    """w 1,024 at S 2,176 (Hymba's prefill with its meta tokens): from row
    1,024 on, the band's first K/V tile holds no key of a query tile's
    last row (rows 1,151, 1,279, .. in bf16; 1,087, 1,151, .. in float32).
    Every row is finite and those rows are within the float64 limit, the
    lse of every row too."""
    w, Sh = 1024, 2176
    q, k, v = _inputs(1, Sh, 5, 1, 64, dtype, 3, dev)
    out, lse = ops.flash_attention_gqa(q, k, v, True, return_lse=True, window=w)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    want, lim = attention_limit(q, k, v, True, w)
    rows = [1087, 1151, 1279, 2175]
    assert float(((out.double() - want).abs() / lim)[:, rows].max()) <= 1
    want_l = attention_lse_dense(q, k, True, w)
    assert float(((lse.double() - want_l).abs() / (LSE_ATOL + LSE_RTOL * want_l.abs())).max()) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_full_width_window_is_causal(dev, dtype):
    """None and w ≥ 2²⁹ (the reference's full-attention convention) run the
    causal kernel: the same bits; w ≥ S runs the band and agrees within
    float64's limit."""
    q, k, v = _inputs(2, 300, 10, 2, 64, dtype, 5, dev)
    causal = ops.flash_attention_gqa(q, k, v, True)
    assert torch.equal(causal, ops.flash_attention_gqa(q, k, v, True, window=1 << 30))
    assert torch.equal(causal, ops.flash_attention_gqa(q, k, v, True, window=1 << 29))
    want, lim = attention_limit(q, k, v, True)
    got = ops.flash_attention_gqa(q, k, v, True, window=300)
    assert float(((got.double() - want).abs() / lim).max()) <= 1


def test_window_refusals(dev):
    q, k, v = _inputs(1, 64, 4, 2, 64, torch.bfloat16, 1, dev)
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention_gqa(q, k, v, False, window=16)
    with pytest.raises(ValueError, match="at least 1"):
        ops.flash_attention_gqa(q, k, v, True, window=0)
