"""Polymul of the port (plain version, the CPU route of the wrapper)
against the JAX package's Pallas kernel (``interpret=True``, as
tests/test_kernels.py runs it) and its ``poly_mul_ref``.

Tolerances, those of tests/test_kernels.py: rtol 1e-4 for float32 and
0.15 for bfloat16, atol the same scaled by √k.  Integer-valued inputs in
{−2..2}: the float64 plain version rounds to exactly the Pallas kernel's
integers (its distance to them is FFT rounding, below 1e-9).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import semiring as rsem
from repro.kernels.polymul.ops import poly_mul_op, poly_mul_ref as rpoly_mul_ref

from repro_torch.core import semiring as psem
from repro_torch.kernels.polymul import poly_mul, poly_mul_ref

SWEEP = [(4, 64), (32, 128), (7, 256), (128, 64)]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 0.15)}


def _pair(rng, shape, dtype_name):
    jdt, tdt, _ = DTYPES[dtype_name]
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    # the same rounded values on both sides
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(tdt)
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).to(tdt)
    return ja, jb, ta, tb


@pytest.mark.parametrize("B,k", SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_pallas_kernel(B, k, dtype):
    tol = DTYPES[dtype][2]
    ja, jb, ta, tb = _pair(np.random.default_rng(B * k), (B, k), dtype)
    got = poly_mul(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (B, k)
    got = got.float().numpy()
    kernel = np.asarray(poly_mul_op(ja, jb), np.float32)
    oracle = np.asarray(rpoly_mul_ref(ja.astype(jnp.float32), jb.astype(jnp.float32)))
    for want in (kernel, oracle):
        np.testing.assert_allclose(got, want, atol=tol * k ** 0.5, rtol=tol)


@pytest.mark.parametrize("B,k", SWEEP)
def test_integer_inputs_exact(B, k):
    rng = np.random.default_rng(B + k)
    a = rng.integers(-2, 3, (B, k)).astype(np.float32)
    b = rng.integers(-2, 3, (B, k)).astype(np.float32)
    kernel = np.asarray(poly_mul_op(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(kernel, np.rint(kernel))          # the direct sums are exact
    plain = poly_mul_ref(torch.from_numpy(a), torch.from_numpy(b), torch.float64).numpy()
    assert np.abs(plain - np.rint(plain)).max() < 1e-9
    np.testing.assert_array_equal(np.rint(plain).astype(np.float32), kernel)


def test_leading_dims_broadcast():
    """(1, n, k) ⊗ (K, n, k), a one-node level's factor against K
    messages, and a single row against a batch, as the reference
    wrapper broadcasts them."""
    rng = np.random.default_rng(1)
    K, n, k = 3, 5, 64
    for sa, sb in (((1, n, k), (K, n, k)), ((K, n, k), (1, n, k)), ((k,), (K, n, k)),
                   ((K, 1, k), (K, n, k))):
        a = rng.standard_normal(sa).astype(np.float32)
        b = rng.standard_normal(sb).astype(np.float32)
        got = poly_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        want = np.asarray(poly_mul_op(jnp.asarray(a), jnp.asarray(b)))
        assert got.shape == want.shape == (K, n, k)
        np.testing.assert_allclose(got, want, atol=1e-4 * k ** 0.5, rtol=1e-4)


def test_semiring_product_matches_reference():
    """The port's PolyCoeff.mul (through the wrapper) equals the
    reference's PolyCoeff.mul, as test_poly_mul_is_semiring_product
    holds the Pallas kernel to it."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 64)).astype(np.float32)
    b = rng.standard_normal((5, 64)).astype(np.float32)
    want = np.asarray(rsem.PolyCoeff(64).mul(jnp.asarray(a), jnp.asarray(b)))
    got = psem.PolyCoeff(64).mul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(poly_mul_op(jnp.asarray(a),
                                                                   jnp.asarray(b))),
                               atol=1e-4)


def test_wrapper_refusals():
    x = torch.zeros(2, 2048)
    with pytest.raises(ValueError, match="k"):
        poly_mul(x, x)                                       # k > 1024
    with pytest.raises(ValueError, match="k"):
        poly_mul(torch.zeros(2, 1), torch.zeros(2, 1))       # k < 2
    with pytest.raises(TypeError):
        poly_mul(torch.zeros(2, 8, dtype=torch.int32), torch.zeros(2, 8, dtype=torch.int32))
    with pytest.raises(TypeError):
        poly_mul(torch.zeros(2, 8), torch.zeros(2, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        poly_mul(torch.zeros(2, 8), torch.zeros(2, 16))
    m = torch.zeros(2, 8, device="meta")
    with pytest.raises(RuntimeError, match="no route"):
        poly_mul(m, m)


# ------------------------------------------- the kernel's block-Toeplitz form --

def _toeplitz_form(a, b, m, dtype=np.float64):
    """The tensor-core path's product in numpy: k = m·p and
    out[u·m + t] = Σ_{(d, s)} L[t, (d, s)] · R[(d, s), u] with
    L[t, (d, s)] = b[(d·m + t − s) mod k] and R[(d, s), u] =
    a[((u − d) mod p)·m + s], one (m × k)·(k × p) einsum a row."""
    k = a.shape[-1]
    p = k // m
    t, d, s = np.arange(m)[:, None, None], np.arange(p)[None, :, None], np.arange(m)[None, None, :]
    lhs = b[..., (d * m + t - s) % k].reshape(*b.shape[:-1], m, k).astype(dtype)
    u = np.arange(p)[None, None, :]
    rhs = a[..., ((u - d.reshape(p, 1, 1)) % p) * m + np.arange(m)[None, :, None]]
    rhs = rhs.reshape(*a.shape[:-1], k, p).astype(dtype)
    out = np.einsum("...tj,...ju->...ut", lhs, rhs)
    return out.reshape(*out.shape[:-2], k)


def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits, ties away from zero),
    as the kernel rounds its hi parts."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_truncated(x):
    """x with its low 13 mantissa bits dropped, as the MMA reads the
    kernel's lo parts."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _three_tf32(a, b, m):
    """A model of the f32 path's 3xTF32 product: x = x_hi + x_lo, hi
    rounded to TF32 and lo truncated to it, and a_lo·b_hi + a_hi·b_lo +
    a_hi·b_hi summed in float32.  The tensor core sums the products in an
    order of its own; the card test holds the kernel itself to float64."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32_truncated(a - a_hi), _tf32_truncated(b - b_hi)
    return (_toeplitz_form(a_lo, b_hi, m, np.float32) + _toeplitz_form(a_hi, b_lo, m, np.float32)
            + _toeplitz_form(a_hi, b_hi, m, np.float32))


def _splits(k):
    """Every m = 16·2^j dividing k: the kernel's choice (the largest that
    leaves p ≥ 8) among them, and m = 16, the bf16 MMA's K width."""
    return [m for m in (16, 32, 64, 128, 256, 512, 1024) if m <= k and k % m == 0]


@pytest.mark.parametrize("k", [16, 64, 256, 1024])
def test_block_toeplitz_form_is_the_circular_product(k):
    """The (m × k)·(k × p) form equals the JAX poly_mul (interpret mode):
    exactly on integers, within 2e-5·(|a| ⊛ |b|) on floats, in float32 and
    with the bf16-rounded inputs the bf16 path multiplies exactly."""
    rng = np.random.default_rng(k)
    ia, ib = (rng.integers(-2, 3, (3, k)).astype(np.float32) for _ in "ab")
    fa, fb = (rng.standard_normal((3, k)).astype(np.float32) for _ in "ab")
    want_int = np.asarray(poly_mul_op(jnp.asarray(ia), jnp.asarray(ib)))
    want = np.asarray(poly_mul_op(jnp.asarray(fa), jnp.asarray(fb)), np.float64)
    limit = 2e-5 * _toeplitz_form(np.abs(fa), np.abs(fb), k) + 1e-6
    ha, hb = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (fa, fb))
    want_bf16 = np.asarray(poly_mul_op(jnp.asarray(ha, jnp.bfloat16),
                                       jnp.asarray(hb, jnp.bfloat16)).astype(jnp.float32))
    for m in _splits(k):
        np.testing.assert_array_equal(_toeplitz_form(ia, ib, m), want_int)
        assert np.all(np.abs(_toeplitz_form(fa, fb, m, np.float32) - want) <= limit)
        exact = _toeplitz_form(ha, hb, m)              # bf16 products are exact in TF32
        assert np.all(np.abs(want_bf16 - exact) <= limit + 2.0 ** -8 * np.abs(exact))


@pytest.mark.parametrize("k", [16, 64, 256, 1024])
def test_three_tf32_products_hold_the_per_element_limit(k):
    """The f32 path's 3xTF32 sums stay within 2e-5·(|a| ⊛ |b|) of the
    exact product, keep integers exact, and keep monomial ⊗ monomial's
    zeros exactly zero (which an FFT does not)."""
    rng = np.random.default_rng(k + 1)
    m = next((m for m in (128, 64, 32) if k % m == 0 and k // m >= 8), 16)   # the kernel's
    a, b = (rng.standard_normal((4, k)).astype(np.float32) * 10.0 ** rng.integers(-3, 4, (4, 1))
            for _ in "ab")
    exact = _toeplitz_form(a, b, k)
    limit = 2e-5 * _toeplitz_form(np.abs(a), np.abs(b), k)
    assert np.all(np.abs(_three_tf32(a, b, m) - exact) <= limit)
    ia, ib = (rng.integers(-2, 3, (4, k)).astype(np.float32) for _ in "ab")
    np.testing.assert_array_equal(_three_tf32(ia, ib, m), _toeplitz_form(ia, ib, k))
    ma, mb = np.zeros((1, k), np.float32), np.zeros((1, k), np.float32)
    ma[0, 3], mb[0, k - 5] = 1.7, -0.3
    got, exact = _three_tf32(ma, mb, m), _toeplitz_form(ma, mb, k)
    assert np.count_nonzero(got) == 1 and np.count_nonzero(exact) == 1
    assert abs(got[0, k - 2] - exact[0, k - 2]) <= 2e-5 * abs(exact[0, k - 2])
