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
