"""count_sketch kernel on the card against its plain versions.

These tests need a CUDA device and the CUDA toolkit; on a host without
one they skip.  The file imports no JAX, so on the GPU machine it runs
without the shared fixtures:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_count_sketch_cuda.py

Every route of the kernel (``ops.plan``: shared memory, bins, slabs)
adds with atomics, so a bucket's float32 sum runs in no fixed order.  Each bucket j is held to 2⁻²³ · m_j · W_j of the float64 sum,
m_j its count of terms and W_j = Σ|x_t| over them (each of the m_j − 1
float32 additions rounds by at most 2⁻²⁴ of a partial sum ≤ W_j, doubled
to spare).  The unsketch does the reference's two float32 products in
order, so it equals the plain version bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.sketch import Hash2
from repro_torch.kernels import _build
from repro_torch.kernels.count_sketch import ops
from repro_torch.kernels.count_sketch.ref import count_sketch_op, count_sketch_ref, unsketch_ref


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return "cuda"


def _within(got, x, buckets, signs, k):
    want = torch.zeros(k, dtype=torch.float64, device=x.device).index_add_(
        0, buckets.long(), x.double() * signs.double())
    w = torch.zeros(k, dtype=torch.float64, device=x.device).index_add_(
        0, buckets.long(), x.double().abs())
    m = torch.bincount(buckets.long(), minlength=k).double()
    err = (got.double() - want).abs()
    assert bool((err <= 2.0 ** -23 * m * w).all()), float((err / (m * w + 1e-300)).max())


def _case(n, k, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, generator=gen, device=dev)
    h = Hash2.make(np.random.default_rng(seed), k)
    idx = torch.arange(n, device=dev)
    return x, h, h.bucket(idx).int(), h.sign(idx)


@pytest.mark.parametrize("n,k", [(100, 16), (1000, 64), (5000, 256), (512, 128),
                                 (45_056, 1 << 13), ((1 << 22) + 3, 1 << 19)])
def test_both_forms_within_their_limit(dev, n, k):
    x, h, b, s = _case(n, k, n + k, dev)
    ops.reset_launches()
    _within(ops.count_sketch(x, b, s, k), x, b, s, k)
    _within(ops.count_sketch_hashed(x, h), x, b, s, k)
    torch.cuda.synchronize()
    assert ops.launches == 2


def test_misaligned_inputs(dev):
    """x, est and state 4 bytes off a 16-byte boundary."""
    x, h, b, s = _case((1 << 20) + 5, 1 << 12, 7, dev)
    xs = x[1:]
    idx = torch.arange(xs.shape[0], device=dev)
    sk = ops.count_sketch_hashed(xs, h)
    _within(sk, xs, h.bucket(idx).int(), h.sign(idx), h.k)
    state = torch.empty_like(x)[1:]
    est = ops.unsketch(xs, sk, h, 0.25, state=state)
    want = unsketch_ref(sk, h, xs.shape[0], 0.25)
    assert torch.equal(est, want) and torch.equal(state, xs - want)


def test_hash_words_wrap_like_uint32_up_to_the_largest_leaf(dev):
    n, k = 2 ** 31 - 1, 1 << 20
    x = torch.zeros(n, device=dev)
    t = torch.tensor([0, 1, 2 ** 30, 2 ** 31 - 70, 2 ** 31 - 3, n - 1], device=dev)
    x[t] = torch.arange(1, 7, dtype=torch.float32, device=dev) * 2.0 ** torch.arange(
        0, 12, 2, dtype=torch.float32, device=dev)      # distinct powers: no two sums collide
    h = Hash2.make(np.random.default_rng(3), k)
    got = ops.count_sketch_hashed(x, h)
    del x
    want = torch.zeros(k, device=dev).index_add_(
        0, h.bucket(t), h.sign(t) * (torch.arange(1, 7, dtype=torch.float32, device=dev)
                                     * 2.0 ** torch.arange(0, 12, 2, dtype=torch.float32,
                                                           device=dev)))
    assert torch.equal(got, want)


@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_unsketch_equals_plain_bit_for_bit(dev, scale):
    x, h, b, s = _case((1 << 21) + 1, 1 << 18, 11, dev)
    sk = count_sketch_ref(x, b, s, h.k)
    ops.reset_launches()
    state = torch.empty_like(x)
    est = ops.unsketch(x, sk, h, scale, state=state)
    want = unsketch_ref(sk, h, x.shape[0], scale)
    assert torch.equal(est, want) and torch.equal(state, x - want)
    g, xx = torch.zeros_like(x), x.clone()                 # the compressor's in-place call
    ops.unsketch(xx, sk, h, scale, est=g, state=xx)
    assert torch.equal(g, want) and torch.equal(xx, x - want)
    assert ops.unsketch_launches == 2 and ops.launches == 0


def test_plain_op_matches_kernel_on_the_card(dev):
    x, h, b, s = _case(300_001, 1 << 15, 5, dev)
    _within(count_sketch_op(x, h), x, b, s, h.k)


def test_wrapper_rejects_mixed_devices_and_dtypes(dev):
    x = torch.ones(64, device=dev)
    b, s = torch.zeros(64, dtype=torch.int32, device=dev), torch.ones(64, device=dev)
    with pytest.raises(ValueError):
        ops.count_sketch(x, b.cpu(), s, 8)
    with pytest.raises(TypeError):
        ops.count_sketch_hashed(x.half(), Hash2.make(np.random.default_rng(0), 8))
    with pytest.raises(ValueError):
        ops.count_sketch_hashed(torch.ones(4, 4, device=dev), Hash2.make(np.random.default_rng(0), 8))


# each route at a k on each side of its crossover, the path's largest leaves included
ROUTES = [(45_056, 1 << 13, "smem"), ((1 << 20) + 3, 1 << 14, "smem"),
          ((1 << 20) + 3, 1 << 15, "slabs"), (11_534_336, 1 << 21, "slabs"),
          ((1 << 22) + 9, 1 << 22, "slabs"), ((1 << 23) + 7, 1 << 23, "bins"),
          (253_755_392, 1 << 25, "bins")]


@pytest.mark.parametrize("n,k,route", ROUTES)
def test_each_route_within_its_limit(dev, n, k, route):
    x, h, b, s = _case(n, k, n % 1000 + k, dev)
    assert ops.plan(n, k).route == route
    ops.reset_launches()
    _within(ops.count_sketch_hashed(x, h), x, b, s, k)
    assert ops.launches == 1                            # one a call, whatever the route launches
    if route == "smem":                                 # the arrays form takes the same route
        _within(ops.count_sketch(x, b, s, k), x, b, s, k)


@pytest.mark.parametrize("n,k,plan", [
    (11_534_336, 1 << 21, ops.Plan("bins")),
    (253_755_392, 1 << 25, ops.Plan("slabs", slabs=4)),
    (253_755_392, 1 << 25, ops.Plan("slabs", slabs=8)),
    ((1 << 20) + 3, 1 << 12, ops.Plan("smem", tile=1 << 15, parts=33))])
def test_the_routes_not_taken_are_right_too(dev, n, k, plan):
    """The routes the plan passes over at these sizes (chip_smoke.py times
    them beside the chosen one) give the same sums."""
    x, h, b, s = _case(n, k, 17, dev)
    _within(ops._hashed(x, h, plan), x, b, s, k)


def test_raw_stream_is_the_current_stream(dev):
    """The wrapper's stream handle is the public current stream's, and a
    sketch on a side stream equals the default stream's."""
    d = torch.device(dev, torch.cuda.current_device())
    assert _build.raw_stream(d) == torch.cuda.current_stream(d).cuda_stream
    x, h, b, s = _case(45_056, 1 << 13, 3, dev)
    want = ops.count_sketch_hashed(x, h)
    side = torch.cuda.Stream(d)
    side.wait_stream(torch.cuda.current_stream(d))
    with torch.cuda.stream(side):
        assert _build.raw_stream(d) == side.cuda_stream
        got = ops.count_sketch_hashed(x, h)
    torch.cuda.synchronize()
    _within(got, x, b, s, h.k)
    _within(want, x, b, s, h.k)


def test_small_k_route_launches_no_memset(dev):
    """On the shared-memory route one block writes every bucket: the call
    launches the sketch kernel alone, no zero fill and no second kernel."""
    from torch.profiler import ProfilerActivity, profile

    x, h, _, _ = _case(45_056, 1 << 13, 4, dev)
    ops.count_sketch_hashed(x, h)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.count_sketch_hashed(x, h)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "count_sketch_smem_kernel" in names[0], names
