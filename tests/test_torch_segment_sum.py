"""Segment-⊕ of the port (plain version, the CPU route of the wrapper)
against the JAX package's Pallas kernel (``interpret=True``) and
``jax.ops.segment_sum``, and each semiring's ``segment_add`` against the
reference semiring's.

Tolerances: integer-valued inputs must match exactly; float inputs
within rtol 1e-5 (the sums are taken in another order)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import semiring as rsem
from repro.kernels.segment_sum.ops import segment_sum_op

from repro_torch.core import semiring as psem
from repro_torch.kernels.segment_sum import (ITEM_ROWS, Segments, WorkPlan, segment_sum,
                                             segment_sum_ref)


def _ids(rng, n, keys, empty):
    """Key ids; ``empty`` leaves every odd key and the last key unused."""
    if empty:
        return 2 * rng.integers(0, max(1, (keys - 1) // 2), n)
    return rng.integers(0, keys, n)


def _vals(rng, shape, integer):
    if integer:
        return rng.integers(-3, 4, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _check(got, want, integer):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("empty", [False, True], ids=["dense", "empty_segments"])
@pytest.mark.parametrize("n,keys,c", [(100, 16, 8), (1000, 64, 32), (513, 40, 1), (300, 7, 3)])
def test_plain_matches_pallas_2d(n, keys, c, empty, integer):
    rng = np.random.default_rng(n + keys + c)
    ids = _ids(rng, n, keys, empty)
    vals = _vals(rng, (n, c), integer)
    seg = Segments.from_ids(ids, keys, "cpu")
    got = segment_sum(torch.from_numpy(vals)[None], seg)[0]
    pallas = segment_sum_op(jnp.asarray(vals), jnp.asarray(ids, jnp.int32), keys,
                            interpret=True)
    ref = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids), num_segments=keys)
    _check(got, pallas, integer)
    _check(got, ref, integer)
    if empty:
        used = np.bincount(ids, minlength=keys) > 0
        assert not used.all()
        assert np.all(got.numpy()[~used] == 0)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_plain_matches_pallas_1d(integer):
    """The Arithmetic layout: (n,) values through the semiring."""
    rng = np.random.default_rng(7)
    ids = _ids(rng, 513, 40, empty=True)
    vals = _vals(rng, (513,), integer)
    seg = Segments.from_ids(ids, 40, "cpu")
    got = psem.Arithmetic().segment_add(torch.from_numpy(vals), seg)
    pallas = segment_sum_op(jnp.asarray(vals), jnp.asarray(ids, jnp.int32), 40)
    _check(got, pallas, integer)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("K", [1, 4])
def test_plain_matches_pallas_k_batched(K, integer):
    """A K-batched family (the trainer's node queries) equals K separate
    reference calls."""
    rng = np.random.default_rng(K)
    n, keys, c = 700, 50, 3
    ids = _ids(rng, n, keys, empty=K == 4)
    vals = _vals(rng, (K, n, c), integer)
    seg = Segments.from_ids(ids, keys, "cpu")
    got = segment_sum(torch.from_numpy(vals), seg)
    assert got.shape == (K, keys, c) and got.dtype == torch.float32
    for k in range(K):
        pallas = segment_sum_op(jnp.asarray(vals[k]), jnp.asarray(ids, jnp.int32), keys)
        _check(got[k], pallas, integer)
    # the semiring route flattens the same batch into the wrapper's K
    via_sem = psem.Channels(c).segment_add(torch.from_numpy(vals), seg)
    np.testing.assert_array_equal(via_sem.numpy(), got.numpy())


def test_segments_csr():
    ids = np.array([3, 0, 3, 1, 0, 3])
    seg = Segments.from_ids(ids, 5, "cpu")
    assert seg.order.dtype == torch.int32 and seg.offsets.dtype == torch.int32
    assert seg.order.tolist() == [1, 4, 3, 0, 2, 5]        # stable within a key
    assert seg.offsets.tolist() == [0, 2, 3, 3, 6, 6]      # keys 2 and 4 empty
    assert seg.ids.tolist() == ids.tolist()


def test_wrapper_checks_shapes_and_devices():
    seg = Segments.from_ids(np.array([0, 1, 1]), 2, "cpu")
    with pytest.raises(ValueError):
        segment_sum(torch.zeros(3, 2), seg)                 # not (K, n, C)
    with pytest.raises(ValueError):
        segment_sum(torch.zeros(1, 4, 2), seg)              # wrong row count
    meta = segment_sum(torch.zeros(1, 3, 2, device="meta"), seg)   # the kernel's shape
    assert meta.shape == (1, 2, 2) and meta.device.type == "meta"


def test_plain_version_dtype_and_bf16():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 9, 200)
    seg = Segments.from_ids(ids, 9, "cpu")
    v = torch.from_numpy(rng.integers(0, 3, (2, 200, 5)).astype(np.float32))
    out = segment_sum(v.to(torch.bfloat16), seg)            # accumulates in f32
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), segment_sum(v, seg).numpy())
    f64 = segment_sum_ref(v, seg.order, seg.offsets, torch.float64)
    assert f64.dtype == torch.float64


# ------------------------------------------------------------- semirings --

def _sem_case(rng, n=400, keys=30):
    ids = _ids(rng, n, keys, empty=True)
    return ids, Segments.from_ids(ids, keys, "cpu"), jnp.asarray(ids, jnp.int32), keys


@pytest.mark.parametrize("name", ["arith", "channels", "polycoeff", "polyfreq"])
def test_module_semiring_segment_add(name):
    rng = np.random.default_rng(3)
    ids, seg, jids, keys = _sem_case(rng)
    n = len(ids)
    if name == "arith":
        r, p, shape = rsem.Arithmetic(), psem.Arithmetic(), (n,)
    elif name == "channels":
        r, p, shape = rsem.Channels(5), psem.Channels(5), (n, 5)
    elif name == "polycoeff":
        r, p, shape = rsem.PolyCoeff(16), psem.PolyCoeff(16), (n, 16)
    else:
        r, p, shape = rsem.PolyFreq(16), psem.PolyFreq(16), (n, 9)
    if name == "polyfreq":
        x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(r.segment_add(jnp.asarray(x), jids, keys))
    got = p.segment_add(torch.from_numpy(x), seg)
    assert got.dtype == p.dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_tropical_and_boolean_segment_add():
    rng = np.random.default_rng(4)
    ids, seg, jids, keys = _sem_case(rng)
    x = rng.standard_normal(len(ids)).astype(np.float32)
    want = np.asarray(rsem.Tropical().segment_add(jnp.asarray(x), jids, keys))
    got = psem.Tropical().segment_add(torch.from_numpy(x), seg).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got).any()                 # empty segments: the semiring zero
    b = rng.random(len(ids)) < 0.1
    want = np.asarray(rsem.BooleanSR().segment_add(jnp.asarray(b), jids, keys))
    got = psem.BooleanSR().segment_add(torch.from_numpy(b), seg).numpy()
    used = np.bincount(ids, minlength=keys) > 0
    np.testing.assert_array_equal(got[used], want[used])
    # an empty segment is the semiring zero, False (the reference's int32
    # segment_max of an empty segment is INT32_MIN, which casts to True)
    assert not got[~used].any()
    # batched: a leading dim reduces per batch row
    xb = np.stack([x, -x])
    got = psem.Tropical().segment_add(torch.from_numpy(xb), seg).numpy()
    for k in range(2):
        np.testing.assert_array_equal(
            got[k], np.asarray(rsem.Tropical().segment_add(jnp.asarray(xb[k]), jids, keys)))


def test_tiled_key_column_reads_untiled_rows():
    """A key column over d tiled copies of the rows (the histogram
    sweep's ``bins + f·(B+1)``), with its order taken modulo n, reduces
    the untiled (n, C) values to what the reference's segment-sum gives
    on the tiled (d·n, C) values."""
    rng = np.random.default_rng(8)
    d, n, nb, C = 3, 500, 17, 4
    ids = (rng.integers(0, nb, (d, n)) + np.arange(d)[:, None] * nb).reshape(-1)
    seg = Segments.from_ids(ids, d * nb, "cpu", row_period=n)
    assert seg.n_rows == n and int(seg.order.max()) < n
    for integer in (True, False):
        x = _vals(rng, (n, C), integer)
        got = segment_sum(torch.from_numpy(x)[None], seg)[0]
        want = jax.ops.segment_sum(jnp.tile(jnp.asarray(x), (d, 1)), jnp.asarray(ids),
                                   d * nb)
        _check(got.numpy(), want, integer)
    with pytest.raises(ValueError, match="does not fit"):
        segment_sum(torch.zeros(1, d * n, C), seg)


# ------------------------------------------------------------ work plan --

L = ITEM_ROWS


def _plan_ids(case, rng):
    """(ids, n_keys, row_period) of one key-set shape of the plan tests."""
    if case == "uniform":
        return rng.integers(0, 64, 6000), 64, None
    if case == "zipf":                         # key 0 holds ~2.5× L entries
        return np.minimum(rng.zipf(1.3, 40000) - 1, 99), 100, None
    if case == "one_key":
        return np.full(3 * L + 5, 2), 5, None
    if case in ("run_L-1", "run_L", "run_L+1"):
        length = L + {"run_L-1": -1, "run_L": 0, "run_L+1": 1}[case]
        return np.concatenate([np.full(length, 1), rng.integers(2, 6, 300)]), 7, None
    if case == "half_empty":
        return 2 * rng.integers(0, 20, 5 * L), 41, None
    if case == "tiled":                        # the histogram sweep's key column
        n, nb = 2 * L + 100, 3
        ids = (rng.integers(0, nb, (2, n)) + np.arange(2)[:, None] * nb).reshape(-1)
        return ids, 2 * nb, n
    raise ValueError(case)


def _two_pass(x, seg):
    """The kernel's two passes over the plan in float64: each item's
    entries summed, an unsplit key's sum written, a split key's
    partials summed in item order."""
    plan = seg.plan
    beg, key = plan.item_offsets.numpy(), plan.item_key.numpy()
    rows = x[seg.order.numpy()]
    out = np.zeros((seg.n_keys, x.shape[1]))
    part = np.zeros((plan.n_slots, x.shape[1]))
    for i, slot in enumerate(plan.item_slot.numpy()):
        s = rows[beg[i]:beg[i + 1]].sum(0)
        if slot < 0:
            out[key[i]] = s
        else:
            part[slot] = s
    so = plan.split_offsets.numpy()
    for j, k in enumerate(plan.split_key.numpy()):
        acc = np.zeros(x.shape[1])
        for s in range(so[j], so[j + 1]):
            acc = acc + part[s]
        out[k] = acc
    return out


@pytest.mark.parametrize("case", ["uniform", "zipf", "one_key", "run_L-1", "run_L", "run_L+1",
                                  "half_empty", "tiled"])
def test_work_plan_covers_the_csr_and_sums_it(case):
    """The plan of ops.ITEM_ROWS-entry items covers every CSR entry once,
    each item within one key and at most L entries long; a key is split
    exactly when it holds more than L entries; and the two passes over
    the plan give segment_sum_ref's and the Pallas kernel's sums, exactly
    on integer values."""
    rng = np.random.default_rng(len(case))
    ids, keys, period = _plan_ids(case, rng)
    seg = Segments.from_ids(ids, keys, "cpu", row_period=period)
    plan, off = seg.plan, seg.offsets.numpy().astype(np.int64)
    assert plan.rows == L
    io, ik = plan.item_offsets.numpy(), plan.item_key.numpy()
    assert io[0] == 0 and io[-1] == len(ids) and np.all(np.diff(io) >= 0)   # each entry once
    assert np.all(np.diff(io) <= L)
    assert np.all(off[ik] <= io[:-1]) and np.all(io[1:] <= off[ik + 1])      # within one key
    lens = np.diff(off)
    assert np.array_equal(np.bincount(ik, minlength=keys), np.maximum(1, -(-lens // L)))
    split = np.flatnonzero(lens > L)
    assert plan.split_key.numpy().tolist() == split.tolist()
    slots = plan.item_slot.numpy()
    assert np.array_equal(slots >= 0, np.isin(ik, split))
    assert sorted(slots[slots >= 0].tolist()) == list(range(plan.n_slots))
    if case == "run_L":
        assert plan.n_split == 0
    if case in ("run_L+1", "one_key", "zipf"):
        assert plan.n_split >= 1

    n = seg.n_rows
    x = rng.integers(-3, 4, (n, 5)).astype(np.float32)
    got = _two_pass(x.astype(np.float64), seg)
    ref = segment_sum_ref(torch.from_numpy(x)[None], seg.order, seg.offsets, torch.float64)[0]
    np.testing.assert_array_equal(got, ref.numpy())
    tiled = np.tile(x, (len(ids) // n, 1))
    pallas = segment_sum_op(jnp.asarray(tiled), jnp.asarray(ids, jnp.int32), keys,
                            interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def test_work_plan_of_small_items():
    """A plan with a small L: items, slots and split keys by hand."""
    plan = WorkPlan.from_offsets(np.array([0, 2, 3, 3, 9, 9, 9]), 2, "cpu")
    assert plan.item_offsets.tolist() == [0, 2, 3, 3, 5, 7, 9, 9, 9]
    assert plan.item_key.tolist() == [0, 1, 2, 3, 3, 3, 4, 5]
    assert plan.item_slot.tolist() == [-1, -1, -1, 0, 1, 2, -1, -1]
    assert plan.split_key.tolist() == [3] and plan.split_offsets.tolist() == [0, 3]
    assert plan.n_slots == 3
    with pytest.raises(ValueError):
        WorkPlan.from_offsets(np.array([0, 1]), 0, "cpu")
