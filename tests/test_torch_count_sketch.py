"""The port's count_sketch (plain versions, as the CPU runs them) against
the JAX reference.

- ``count_sketch`` (buckets and signs as arrays) against the reference's
  Pallas kernel in interpret mode and against its ``count_sketch_ref``,
  on ``tests/test_kernels.py``'s four (n, k): within 1e-5 of the largest
  bucket magnitude Σ|x| (float32 sums of n/k terms in another order);
- ``count_sketch_op`` / ``count_sketch_hashed`` (the hashes of a
  ``Hash2``) against the reference's ``count_sketch_op`` with the same
  constants (``convert.hash2``), the same limit;
- ``Hash2`` buckets and signs equal to the reference's, integer for
  integer, for t up to 2³¹ − 1 (the reference's words are uint32; the
  port's int64 emulation must wrap the same way);
- ``unsketch``: est = s(t)·sk[h(t)]·scale and the error-feedback state
  x − est equal to the reference compressor's formulas, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sketch import Hash2 as RefHash2
from repro.kernels.count_sketch.count_sketch import count_sketch as ref_pallas
from repro.kernels.count_sketch.ops import count_sketch_op as ref_op
from repro.kernels.count_sketch.ref import count_sketch_ref as ref_plain
from repro_torch import convert
from repro_torch.kernels.count_sketch import (count_sketch, count_sketch_hashed, count_sketch_op,
                                              count_sketch_ref, unsketch)

SHAPES = [(100, 16), (1000, 64), (5000, 256), (512, 128)]
RTOL = 1e-5                       # of the largest bucket magnitude Σ|x|


def _inputs(n, k, seed=None):
    rng = np.random.default_rng(n + k if seed is None else seed)
    x = rng.standard_normal(n).astype(np.float32)
    h = RefHash2.make(jax.random.PRNGKey(3), k)
    idx = jnp.arange(n)
    return x, h, np.array(h.bucket(idx)), np.array(h.sign(idx))


def _close(got, want, x, buckets, k):
    mag = np.bincount(buckets, weights=np.abs(x).astype(np.float64), minlength=k)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=RTOL * mag.max())


@pytest.mark.parametrize("n,k", SHAPES)
def test_count_sketch_matches_pallas_and_plain(n, k):
    x, _, b, s = _inputs(n, k)
    got = count_sketch(torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(s), k)
    assert got.dtype == torch.float32 and got.shape == (k,)
    pallas = ref_pallas(jnp.asarray(x), jnp.asarray(b), jnp.asarray(s), k, interpret=True)
    _close(got.numpy(), pallas, x, b, k)
    _close(got.numpy(), ref_plain(jnp.asarray(x), jnp.asarray(b), jnp.asarray(s), k), x, b, k)


@pytest.mark.parametrize("n,k", SHAPES)
def test_hashed_forms_match_reference_op(n, k):
    x, h, b, _ = _inputs(n, k)
    want = ref_op(jnp.asarray(x), h)
    port_h = convert.hash2(h)
    xt = torch.from_numpy(x)
    _close(count_sketch_op(xt, port_h).numpy(), want, x, b, k)
    _close(count_sketch_hashed(xt, port_h).numpy(), want, x, b, k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_words_match_reference_up_to_2_31(seed):
    h = RefHash2.make(jax.random.PRNGKey(seed), 1 << 25)
    port_h = convert.hash2(h)
    rng = np.random.default_rng(seed)
    t = np.concatenate([np.arange(64), 2 ** 31 - 1 - np.arange(64), [2 ** 30, 2 ** 31 - 2],
                        rng.integers(0, 2 ** 31, 4096)]).astype(np.int64)
    tj = jnp.asarray(t.astype(np.uint32))
    np.testing.assert_array_equal(port_h.bucket(torch.from_numpy(t)).numpy(),
                                  np.asarray(h.bucket(tj)))
    np.testing.assert_array_equal(port_h.sign(torch.from_numpy(t)).numpy(),
                                  np.asarray(h.sign(tj)))


@pytest.mark.parametrize("n,k,scale", [(1000, 64, None), (5000, 256, None), (5000, 256, 1.0)])
def test_unsketch_matches_compressor_formulas(n, k, scale):
    x, h, b, s = _inputs(n, k)
    sk = np.array(ref_plain(jnp.asarray(x), jnp.asarray(b), jnp.asarray(s), k))
    scale = h.k / n if scale is None else scale
    est_ref = jnp.asarray(s) * jnp.take(jnp.asarray(sk), jnp.asarray(b))
    if scale != 1.0:
        est_ref = est_ref * scale
    state_ref = jnp.asarray(x) - est_ref
    xt = torch.from_numpy(x.copy())
    state = torch.empty_like(xt)
    est = unsketch(xt, torch.from_numpy(sk), convert.hash2(h), scale, state=state)
    np.testing.assert_array_equal(est.numpy(), np.asarray(est_ref))
    np.testing.assert_array_equal(state.numpy(), np.asarray(state_ref))
    # in place, as the compressor calls it: est over one buffer, state over x
    g = torch.zeros_like(xt)
    unsketch(xt, torch.from_numpy(sk), convert.hash2(h), scale, est=g, state=xt)
    np.testing.assert_array_equal(g.numpy(), np.asarray(est_ref))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(state_ref))


def test_plain_sums_in_float64():
    x = torch.tensor([1.0, 1e-8, -1.0, 3.0], dtype=torch.float32)
    got = count_sketch_ref(x, torch.tensor([0, 0, 0, 1]), torch.ones(4), 2)
    assert got.tolist() == [np.float32(1e-8), 3.0]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.ones(8)
    b, s = torch.zeros(8, dtype=torch.int32), torch.ones(8)
    with pytest.raises(ValueError):
        count_sketch(x, b, s, 6)                                       # k not a power of two
    with pytest.raises(ValueError):
        count_sketch(x, b + 4, s, 4)                                   # bucket out of range
    with pytest.raises(TypeError):
        count_sketch(x.double(), b, s, 4)
    with pytest.raises(TypeError):
        count_sketch(x, b.long(), s, 4)
    with pytest.raises(ValueError):
        count_sketch(torch.ones(2, 4), b, s, 4)
    with pytest.raises(ValueError):
        count_sketch(x, b[:4], s[:4], 4)


# (n, k, hashed) → the route, its partial sketches and slabs, and the scratch it allocates
PLANS = [
    ((2_048, 1 << 9, True), ("smem", 1, 1, 0)),                 # ln_f: one block, no memset
    ((45_056, 1 << 13, True), ("smem", 1, 1, 0)),               # ln1, ln2
    (((1 << 20) + 3, 1 << 12, True), ("smem", 17, 1, 17 << 12)),    # partials, summed in order
    ((2 ** 31 - 1, 16, True), ("smem", 264, 1, 264 * 16)),      # at most SMEM_MAX_PARTS
    (((1 << 20) + 3, 1 << 15, True), ("slabs", 1, 1, 0)),
    ((11_534_336, 1 << 21, True), ("slabs", 1, 1, 0)),          # wk, wv: the sketch fits L2
    ((66_060_288, 1 << 23, True), ("bins", 1, 1, 2 * 66_060_288 + 3 * 256 + 1)),
    ((92_274_688, 1 << 24, True), ("bins", 1, 1, 2 * 92_274_688 + 3 * 512 + 1)),
    ((253_755_392, 1 << 25, True), ("bins", 1, 1, 2 * 253_755_392 + 3 * 1024 + 1)),
    ((253_755_392, 1 << 25, False), ("slabs", 1, 4, 0)),        # the arrays form: no bins
    ((1 << 27, 1 << 26, True), ("slabs", 1, 8, 0)),             # past the bins' 1,024
]


@pytest.mark.parametrize("args,want", PLANS)
def test_plan_routes_by_sketch_size(args, want):
    from repro_torch.kernels.count_sketch import ops
    n, k, hashed = args
    p = ops.plan(n, k, hashed)
    assert (p.route, p.parts, p.slabs, ops.scratch_words(p, n, k)) == want
    if p.route == "smem":                          # the blocks' tiles cover x, none empty
        assert p.parts * p.tile >= n > (p.parts - 1) * p.tile
        assert p.parts == min(ops.SMEM_MAX_PARTS, -(-n // ops.SMEM_TILE))   # tiles ~SMEM_TILE
    else:                                          # the C interface's slab shift: 2^shift a slab
        assert ops._route(p, k)[2] == (k // p.slabs).bit_length() - 1
        assert k // p.slabs <= ops.SLAB_BUCKETS or p.route == "bins"


def test_plan_takes_every_leaf_of_the_compressor():
    """Every sketch size the compressor makes for TinyLlama's twelve
    leaves has a route, and only the norm leaves take shared memory."""
    from repro_torch.kernels.count_sketch import ops
    from repro_torch.optim.grad_compress import CountSketchCompressor
    comp = CountSketchCompressor(ratio=8)
    leaves = {"ln_f": 2_048, "ln": 45_056, "wk": 11_534_336, "embed": 66_060_288,
              "wq": 92_274_688, "mlp": 253_755_392}
    routes = {name: ops.plan(n, comp.sketch_size(n)).route for name, n in leaves.items()}
    assert routes == {"ln_f": "smem", "ln": "smem", "wk": "slabs", "embed": "bins",
                      "wq": "bins", "mlp": "bins"}
