"""flash_attention kernel on the card against its plain versions.

These tests need a CUDA device and the CUDA toolkit; on a host without
one they skip.  The file imports no JAX, so on the GPU machine it runs
without the shared fixtures:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_flash_attention_cuda.py

Tolerances against a dense softmax in float64 over the same inputs
(``ref.attention_limit``), per element, with V = max|v|:
- float32 (plain FMA, no TF32): 2e-5 · V — float32 sums of up to S
  terms whose weights sum to 1;
- bfloat16: 2⁻⁷ · (|o| + ‖p‖₂ · V) for an output o of a row whose
  probabilities are p — the output's rounding (2⁻⁸ · |o|) and the
  probabilities' rounding to bf16 before P·V (2⁻⁸ of each weight), as the
  reference rounds them, whose sum over a row spreads as ‖p‖₂ · V, with a
  factor 2 to spare.  A late causal row that averages many keys is held
  to about its own output's size, not to 2⁻⁷ · V.
The log-sum-exp output within 1e-4 + 1e-5 · |lse| of a float64 one (its
float32 sums and the base-2 exponent's rounding).
Where the scores are large (``test_large_scores_stay_finite``), the
float32 sum of a score is itself off by about an ulp of C = max_ij Σ_d
|q_id k_jd| / √dh, and an error δ in the scores moves the output by up
to 2δ · V: the float32 limit there adds 2⁻²³ · C · V (δ = 2⁻²⁴ · C).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_limit, attention_lse_dense,
                                                      flash_attention_ref)


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


def _within(got, q, k, v, causal, score_rounding=False):
    want, lim = attention_limit(q, k, v, causal)
    if score_rounding:
        lim = lim + 2.0 ** -23 * _score_magnitude(q, k) * float(v.abs().max())
    ratio = float(((got.double() - want).abs() / lim).max())
    assert ratio <= 1, ratio


def _score_magnitude(q, k) -> float:
    """C = max_ij Σ_d |q_id k_jd| / √dh over the query heads and their K/V heads."""
    G = q.shape[2] // k.shape[2]
    qa = q.abs().double().permute(0, 2, 1, 3)
    ka = k.abs().double().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    return float((qa @ ka.transpose(-1, -2)).max()) / math.sqrt(q.shape[-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,N,Kh,dh,causal", [
    (2, 128, 4, 4, 16, True), (2, 128, 8, 2, 32, True), (1, 256, 8, 1, 64, True),
    (2, 192, 16, 2, 128, True), (3, 100, 8, 2, 32, True), (1, 1000, 8, 2, 32, True),
    (2, 77, 4, 1, 64, False), (2, 256, 16, 16, 64, False), (1, 130, 8, 8, 128, False),
    (2, 1, 8, 2, 64, True), (1, 65, 4, 4, 16, False)])
def test_kernel_matches_dense(dev, dtype, B, S, N, Kh, dh, causal):
    """dh ∈ {16, 32, 64, 128}, G ∈ {1, 4, 8}, ragged S, causal and not."""
    q, k, v = _inputs(B, S, N, Kh, dh, dtype, S + dh + N, dev)
    before = ops.launches
    got = ops.flash_attention_gqa(q, k, v, causal)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert got.shape == (B, S, N * dh) and got.dtype == dtype
    assert torch.equal(got, ops.flash_attention_gqa(q, k, v, causal))     # deterministic
    _within(got, q, k, v, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_blockwise_plain(dev, dtype):
    """Against the port of the model's blockwise twin on the card."""
    q, k, v = _inputs(2, 300, 8, 2, 64, dtype, 11, dev)
    got = ops.flash_attention_gqa(q, k, v, True).double()
    want = flash_attention_ref(q, k, v, True).double()
    _, lim = attention_limit(q, k, v, True)
    assert float(((got - want).abs() / lim).max()) <= 2


def test_kernel_reads_strided_operands(dev):
    """q, k and v as views of one fused (B, S, N + 2Kh, dh) projection
    (not contiguous) give the same result as contiguous copies."""
    B, S, N, Kh, dh = 2, 96, 8, 2, 64
    qkv = torch.randn(B, S, N + 2 * Kh, dh, device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, :N], qkv[:, :, N:N + Kh], qkv[:, :, N + Kh:]
    assert not q.is_contiguous()
    got = ops.flash_attention_gqa(q, k, v, True)
    assert torch.equal(got, ops.flash_attention_gqa(q.contiguous(), k.contiguous(),
                                                    v.contiguous(), True))


def test_large_scores_stay_finite(dev):
    """Scores of several hundred: the running max keeps every exponent ≤ 0."""
    q, k, v = _inputs(1, 256, 4, 2, 64, torch.float32, 3, dev)
    got = ops.flash_attention_gqa(q * 30, k * 30, v, True)
    assert torch.isfinite(got).all()
    _within(got, q * 30, k * 30, v, True, score_rounding=True)


def test_kernel_refuses_unsupported(dev):
    q, k, v = _inputs(1, 32, 4, 2, 64, torch.float32, 7, dev)
    with pytest.raises(TypeError):
        ops.flash_attention_gqa(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        ops.flash_attention_gqa(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        ops.flash_attention_gqa(q, k.cpu(), v)
    with pytest.raises(ValueError):                                   # dh 48
        ops.flash_attention_gqa(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError):                                   # N % Kh != 0
        ops.flash_attention_gqa(q[:, :, :3], k, v)
    with pytest.raises(ValueError):                                   # Sk != Sq
        ops.flash_attention_gqa(q, k[:, :16], v[:, :16])


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("S", [1000, 200, 24, 1])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_bf16_kernel_on_fused_qkv_views(dev, dh, causal, S, G):
    """The bf16 kernel (TMA loads, wgmma, 128-row tiles) at every head width,
    causal and full, S ragged against the tile (1000, 200) and shorter than
    it (24, 1), G ∈ {1, 4, 8}, with q, k and v strided views of one fused
    (B, S, N + 2Kh, dh) projection: within ``ref.attention_limit`` of a
    float64 softmax, the lse within 1e-4 + 1e-5 · |lse|, two runs bit-equal
    and equal to the run on contiguous copies."""
    B, Kh = 2, 2
    N = G * Kh
    rng = np.random.default_rng(1000 * dh + 10 * S + G)
    fused = torch.from_numpy(rng.standard_normal((B, S, N + 2 * Kh, dh), dtype=np.float32))
    fused = fused.to(dev, torch.bfloat16)
    q, k, v = fused[:, :, :N], fused[:, :, N:N + Kh], fused[:, :, N + Kh:]
    out, lse = ops.flash_attention_gqa(q, k, v, causal, return_lse=True)
    out2, lse2 = ops.flash_attention_gqa(q, k, v, causal, return_lse=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(out, ops.flash_attention_gqa(q.contiguous(), k.contiguous(),
                                                    v.contiguous(), causal))
    _within(out, q, k, v, causal)
    want = attention_lse_dense(q, k, causal)
    assert float(((lse.double() - want).abs() / (1e-4 + 1e-5 * want.abs())).max()) <= 1


def test_raw_stream_is_the_current_stream(dev):
    """The wrapper's stream handle is the public current stream's, on the
    default stream and on a side stream, and a launch on the side stream
    gives the default stream's result."""
    d = torch.device(dev, torch.cuda.current_device())
    assert _build.raw_stream(d) == torch.cuda.current_stream(d).cuda_stream
    q, k, v = _inputs(2, 200, 8, 2, 64, torch.bfloat16, 5, dev)
    want = ops.flash_attention_gqa(q, k, v, True)
    side = torch.cuda.Stream(d)
    side.wait_stream(torch.cuda.current_stream(d))
    with torch.cuda.stream(side):
        assert _build.raw_stream(d) == side.cuda_stream
        got = ops.flash_attention_gqa(q, k, v, True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_spin_limit_build_gives_the_same_bits(dev, monkeypatch):
    """The debug build whose barrier waits trap after SM90_SPIN_LIMIT polls
    (``csrc/sm90.cuh``) compiles, launches and gives the default build's
    bits."""
    q, k, v = _inputs(2, 300, 8, 2, 128, torch.bfloat16, 9, dev)
    want = ops.flash_attention_gqa(q, k, v, True)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-DSM90_SPIN_LIMIT=4194304",))
    monkeypatch.setattr(ops, "_lib", None)
    got = ops.flash_attention_gqa(q, k, v, True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
