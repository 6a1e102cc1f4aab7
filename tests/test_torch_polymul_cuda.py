"""Polymul kernel on the card against its plain version.

These tests need a CUDA device and the CUDA toolkit; on a host without
one they skip.  The file imports no JAX, so on the GPU machine it runs
without the shared fixtures:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_polymul_cuda.py

Tolerances against the plain version computed in float64: integer-valued
inputs exactly (after rounding the float64 FFT to the integers it
approximates); float32 within 2e-5·(|a| ⊛ |b|) per coefficient (k f32
products summed in f32); bfloat16 within 2^-8·|exact| (the output's
rounding) plus the same f32 sum term.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import semiring as psem
from repro_torch.kernels.polymul import ops
from repro_torch.kernels.polymul.ref import poly_mul_ref

F32_RTOL = 2e-5
BF16_ULP = 2.0 ** -8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return "cuda"


def _within(got, a, b):
    want = poly_mul_ref(a, b, torch.float64)
    mag = poly_mul_ref(a.abs(), b.abs(), torch.float64)
    tol = F32_RTOL * mag + 1e-6
    if got.dtype == torch.bfloat16:
        tol = tol + BF16_ULP * want.abs()
    err = (got.double() - want).abs()
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.parametrize("B,k", [(4, 64), (32, 128), (7, 256), (128, 64), (3, 1024),
                                 (1027, 256), (5, 2), (9, 3), (6, 100), (4, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(dev, B, k, dtype):
    gen = torch.Generator(device=dev).manual_seed(B * k)
    ints = [torch.randint(-2, 3, (B, k), generator=gen, device=dev).float() for _ in "ab"]
    before = ops.launches
    got = ops.poly_mul(*ints)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = poly_mul_ref(*ints, torch.float64)
    assert float((want - want.round()).abs().max()) < 1e-6
    assert torch.equal(got.double(), want.round())
    a, b = (torch.randn((B, k), generator=gen, device=dev).to(dtype) for _ in "ab")
    got = ops.poly_mul(a, b)
    assert got.dtype == dtype and got.shape == (B, k)
    assert torch.equal(got, ops.poly_mul(a, b))                 # deterministic
    _within(got, a, b)


def test_main_path_shape(dev):
    """The coefficient fit's largest ⊗ at k = 256, cut to 2^16 rows per
    node: (K, n, k) factor ⊗ gathered message, and a one-node level's
    (1, n, k) factor broadcast against K messages."""
    K, n, k = 4, 1 << 16, 256
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((K, n, k), generator=gen, device=dev)
    b = torch.randn((K, n, k), generator=gen, device=dev)
    got = ops.poly_mul(a, b)
    _within(got, a, b)
    got1 = ops.poly_mul(a[:1], b)
    _within(got1, a[:1].expand_as(b), b)
    sem = psem.PolyCoeff(k)
    assert torch.equal(sem.mul(a, b), got)                      # PolyCoeff ⊗ is the kernel


def test_kernel_rejects_what_it_does_not_take(dev):
    with pytest.raises(ValueError):
        ops.poly_mul(torch.zeros(2, 2048, device=dev), torch.zeros(2, 2048, device=dev))
    with pytest.raises(TypeError):
        ops.poly_mul(torch.zeros(2, 8, dtype=torch.float64, device=dev),
                     torch.zeros(2, 8, dtype=torch.float64, device=dev))
    with pytest.raises(TypeError):
        ops.poly_mul(torch.zeros(2, 8, device=dev),
                     torch.zeros(2, 8, dtype=torch.bfloat16, device=dev))
    with pytest.raises(ValueError):
        ops.poly_mul(torch.zeros(2, 8, device=dev), torch.zeros(2, 8))


@pytest.mark.parametrize("k", [2, 6, 8, 16, 48, 64, 144, 250, 256, 512, 768, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_both_paths_broadcast_monomials_and_rerun(dev, k, dtype):
    """The tensor-core path (k a multiple of 16 up to 128, and 256, 512
    and 1024: each of its four m-tile counts) and the direct path (other
    k, multiples of 16 such as 144 and 768 too): fit B's broadcast form, a (1, n, k) factor against (K, n, k)
    messages, within the limit of the plain version; monomial ⊗ monomial
    exactly zero off its one coefficient; two runs bit-equal."""
    K, n = 3, 300
    gen = torch.Generator(device=dev).manual_seed(k)
    a = torch.randn((1, n, k), generator=gen, device=dev).to(dtype)
    b = torch.randn((K, n, k), generator=gen, device=dev).to(dtype)
    got = ops.poly_mul(a, b)
    assert got.shape == (K, n, k) and got.dtype == dtype
    assert torch.equal(got, ops.poly_mul(a, b))
    _within(got, a.expand_as(b), b)
    ma = torch.zeros((4, k), device=dev, dtype=dtype)
    mb = torch.zeros((4, k), device=dev, dtype=dtype)
    ma[:, 1], mb[:, k - 1] = 1.5, -2.25                        # z · z^(k−1) = z^k ≡ 1
    mono = ops.poly_mul(ma, mb)
    want = torch.zeros_like(mono)
    want[:, 0] = -3.375
    assert torch.equal(mono, want)
