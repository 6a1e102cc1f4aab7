"""Dense sketches and the sketch domains' transforms in the port, on the CPU
against the JAX reference: ``core/sketch.count_sketch_dense`` and
``tensor_sketch_dense`` under hashes carried across with
``convert.hash2``, and ``PolyCoeff.to_freq`` / ``PolyFreq.to_coeff``.

Tolerances: integer-valued inputs exact (every partial sum is an integer
below 2²⁴); float inputs within 1e-5 · Σ|v| (float32 sums in other
orders; for the tensor sketch Σ|v| is the product of the factors' sums
of magnitudes); the transforms the reference test's atol 1e-4 and rtol
1e-4 (Parseval).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.semiring import PolyCoeff as RPolyCoeff
from repro.core.semiring import PolyFreq as RPolyFreq
from repro.core.sketch import Hash2 as RHash2
from repro.core.sketch import count_sketch_dense as ref_count_sketch_dense
from repro.core.sketch import tensor_sketch_dense as ref_tensor_sketch_dense
from repro_torch import convert
from repro_torch.core.semiring import PolyCoeff, PolyFreq
from repro_torch.core.sketch import count_sketch_dense, tensor_sketch_dense

FLOAT_RTOL = 1e-5


def _hash(seed, k):
    ref = RHash2.make(jax.random.PRNGKey(seed), k)
    return ref, convert.hash2(ref)


def _vec(rng, n, integer):
    if integer:
        return rng.integers(-50, 51, n).astype(np.float32)
    return rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("n,k", [(100, 16), (1000, 64), (5000, 256), (512, 128), (3, 2)])
def test_count_sketch_dense_matches_reference(n, k, integer):
    rng = np.random.default_rng(n + k)
    x = _vec(rng, n, integer)
    ref_h, h = _hash(n, k)
    want = np.asarray(ref_count_sketch_dense(jnp.asarray(x), ref_h))
    got = count_sketch_dense(torch.from_numpy(x), h)
    assert got.dtype == torch.float32 and got.shape == (k,)
    if integer:
        assert np.array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOAT_RTOL * np.abs(x).sum())


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("sizes,k", [((7, 5), 16), ((30, 20, 10), 64), ((64, 3), 256)])
def test_tensor_sketch_dense_matches_reference(sizes, k, integer):
    rng = np.random.default_rng(sum(sizes) + k)
    vecs = [_vec(rng, n, integer) for n in sizes]
    pairs = [_hash(10 * i + k, k) for i in range(len(sizes))]
    want = np.asarray(ref_tensor_sketch_dense([jnp.asarray(v) for v in vecs],
                                              [p[0] for p in pairs], k))
    got = tensor_sketch_dense([torch.from_numpy(v) for v in vecs], [p[1] for p in pairs], k)
    assert got.shape == (k,)
    mag = float(np.prod([np.abs(v).sum(dtype=np.float64) for v in vecs]))
    if integer:
        # the FFT product of integer sketches: exact up to its float32 rounding,
        # which both round to the same integer
        np.testing.assert_array_equal(np.rint(got.numpy()), np.rint(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOAT_RTOL * mag)


def test_tensor_sketch_of_one_factor_is_its_count_sketch():
    """With one factor the FFT round trip gives the count sketch back, and
    both equal the Kronecker coordinates hashed one by one."""
    rng = np.random.default_rng(1)
    x = _vec(rng, 200, True)
    _, h = _hash(3, 32)
    got = tensor_sketch_dense([torch.from_numpy(x)], [h], 32)
    want = np.zeros(32)
    idx = torch.arange(200)
    np.add.at(want, h.bucket(idx).numpy(), h.sign(idx).numpy() * x)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    assert np.array_equal(count_sketch_dense(torch.from_numpy(x), h).numpy(), want)
    with pytest.raises(ValueError, match="buckets"):
        tensor_sketch_dense([torch.from_numpy(x)], [h], 64)


@pytest.mark.parametrize("k", [16, 64, 256])
def test_coeff_freq_equivalence(k):
    """The reference's ``test_coeff_freq_equivalence`` through the port's
    transforms, on the reference's own inputs, against the reference."""
    a = np.array(jax.random.normal(jax.random.PRNGKey(0), (7, k)))
    b = np.array(jax.random.normal(jax.random.PRNGKey(1), (7, k)))
    pc, pf = PolyCoeff(k), PolyFreq(k)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    prod = pf.to_coeff(pf.mul(pc.to_freq(ta), pc.to_freq(tb)))
    np.testing.assert_allclose(prod.numpy(), pc.mul(ta, tb).numpy(), atol=1e-4)
    rpc, rpf = RPolyCoeff(k), RPolyFreq(k)
    np.testing.assert_allclose(pc.to_freq(ta).numpy(), np.asarray(rpc.to_freq(jnp.asarray(a))),
                               atol=1e-4)
    f = np.array(rpc.to_freq(jnp.asarray(b)))
    np.testing.assert_allclose(pf.to_coeff(torch.from_numpy(f)).numpy(),
                               np.asarray(rpf.to_coeff(jnp.asarray(f))), atol=1e-4)
    # Parseval
    np.testing.assert_allclose(pf.norm_sq(pc.to_freq(ta)).numpy(), pc.norm_sq(ta).numpy(),
                               rtol=1e-4)
