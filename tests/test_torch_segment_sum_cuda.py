"""Segment-⊕ kernel on the card against its plain version.

These tests need a CUDA device and the CUDA toolkit; on a host without
one they skip.  The file imports no JAX, so on the GPU machine it runs
without the shared fixtures:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_segment_sum_cuda.py

Integer-valued inputs must match the plain version exactly; float
inputs within 1e-5·Σ|v| of it computed in float64.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.segment_sum import ops
from repro_torch.kernels.segment_sum.ref import segment_sum_ref


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return "cuda"


@pytest.mark.parametrize("K,n,C,dtype,dist", [
    (1, 5000, 3, torch.float32, "uniform"),
    (4, 5000, 3, torch.float32, "even"),
    (1, 70000, 40, torch.float32, "zipf"),
    (2, 9000, 40, torch.bfloat16, "uniform"),
    (4, 3000, 258, torch.float32, "uniform"),
    (1, 100, 8, torch.float32, "uniform"),
    (1, 100, 9, torch.float32, "uniform"),
])
def test_kernel_matches_plain(dev, K, n, C, dtype, dist):
    rng = np.random.default_rng(n + C)
    keys = 257
    if dist == "zipf":
        ids = np.minimum(rng.zipf(1.3, n) - 1, keys - 1)
    elif dist == "even":
        ids = 2 * rng.integers(0, keys // 2, n)
    else:
        ids = rng.integers(0, keys, n)
    seg = ops.Segments.from_ids(ids, keys, dev)
    ints = torch.from_numpy(rng.integers(-3, 4, (K, n, C)).astype(np.float32)).to(dev, dtype)
    before = ops.launches
    got = ops.segment_sum(ints, seg)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = segment_sum_ref(ints, seg.order, seg.offsets, torch.float64)
    assert torch.equal(got.double(), want)
    vals = torch.from_numpy(rng.standard_normal((K, n, C)).astype(np.float32)).to(dev, dtype)
    got = ops.segment_sum(vals, seg)
    assert torch.equal(got, ops.segment_sum(vals, seg))         # deterministic
    want = segment_sum_ref(vals, seg.order, seg.offsets, torch.float64)
    mag = segment_sum_ref(vals.abs(), seg.order, seg.offsets, torch.float64)
    assert bool(((got.double() - want).abs() <= 1e-5 * mag + 1e-30).all())


def test_kernel_rejects_what_it_does_not_take(dev):
    seg = ops.Segments.from_ids(np.array([0, 1, 1]), 2, dev)
    with pytest.raises(TypeError):
        ops.segment_sum(torch.zeros(1, 3, 2, dtype=torch.float64, device=dev), seg)
    with pytest.raises(ValueError):
        ops.segment_sum(torch.zeros(1, 2, 3, device=dev).transpose(1, 2), seg)
    cpu_seg = ops.Segments.from_ids(np.array([0, 1, 1]), 2, "cpu")
    with pytest.raises(ValueError):
        ops.segment_sum(torch.zeros(1, 3, 2, device=dev), cpu_seg)


@pytest.mark.parametrize("C", [3, 40])
@pytest.mark.parametrize("case", ["zipf", "one_key", "run_L-1", "run_L", "run_L+1"])
def test_kernel_splits_long_keys(dev, case, C):
    """Keys longer than ops.ITEM_ROWS entries, cut into work items whose
    partials a second pass sums: exact on integers, bit-equal across two
    runs, within 1e-5·Σ|v| on floats, one launch counted a call."""
    L = ops.ITEM_ROWS
    rng = np.random.default_rng(C + len(case))
    if case == "zipf":
        keys, ids = 257, np.minimum(rng.zipf(1.3, 200_000) - 1, 256)
    elif case == "one_key":
        keys, ids = 3, np.full(3 * L + 5, 1)
    else:
        length = L + {"run_L-1": -1, "run_L": 0, "run_L+1": 1}[case]
        keys, ids = 9, np.concatenate([np.full(length, 4), rng.integers(5, 9, 500)])
    seg = ops.Segments.from_ids(ids, keys, dev)
    assert (seg.plan.n_split > 0) == (case in ("zipf", "one_key", "run_L+1"))
    for dtype in (torch.float32, torch.bfloat16):
        ints = torch.from_numpy(rng.integers(-3, 4, (2, len(ids), C)).astype(np.float32))
        ints = ints.to(dev, dtype)
        before = ops.launches
        got = ops.segment_sum(ints, seg)
        torch.cuda.synchronize()
        assert ops.launches == before + 1
        assert torch.equal(got.double(), segment_sum_ref(ints, seg.order, seg.offsets,
                                                         torch.float64))
        vals = torch.from_numpy(rng.standard_normal((2, len(ids), C)).astype(np.float32))
        vals = vals.to(dev, dtype)
        got = ops.segment_sum(vals, seg)
        assert torch.equal(got, ops.segment_sum(vals, seg))
        want = segment_sum_ref(vals, seg.order, seg.offsets, torch.float64)
        mag = segment_sum_ref(vals.abs(), seg.order, seg.offsets, torch.float64)
        assert bool(((got.double() - want).abs() <= 1e-5 * mag + 1e-30).all())
