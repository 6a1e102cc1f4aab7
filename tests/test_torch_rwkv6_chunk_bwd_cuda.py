"""The WKV backward kernel (``csrc/rwkv6_chunk_bwd.cu``) on the card against
its plain version, and the relational weights pass's launches.

These tests need a CUDA device and the CUDA toolkit; on a host without
one they skip.  The file imports no JAX, so on the GPU machine it runs
without the shared fixtures:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_rwkv6_chunk_bwd_cuda.py

Tolerance against the plain backward in float64: |kernel − plain_f64| ≤
1e-4 · scale per element, the scale ``ref.rwkv6_chunk_bwd_scale`` (the
same formulas on |r|, |k|, |v|, |u|, |do|; for the decays the sum of the
two cancelling sums' magnitudes): float32 sums carried through the
chunk states, the reverse state G and the decays' running difference
over the whole sequence.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6_chunk import ops
from repro_torch.kernels.rwkv6_chunk.ref import rwkv6_chunk_bwd_ref, rwkv6_chunk_bwd_scale

BWD_RTOL = 1e-4
NAMES = ("dr", "dk", "dv", "dlogw", "du")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return "cuda"


def _inputs(B, S, H, hs, seed, dev, decay=(0.01, 2.0)):
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((B, S, H, hs), dtype=np.float32) for _ in range(4))
    logw = -rng.uniform(*decay, (B, S, H, hs)).astype(np.float32)
    u = rng.standard_normal((H, hs), dtype=np.float32)
    return [torch.from_numpy(x).to(dev) for x in (r, k, v, logw, u, do)]


def _strong(logw, chunk, which):
    """logw with 'mixed' chunks (every other chunk decays by 80-96, past the
    kernel's switch at −60) or 'one_column' (key column hs // 3 does, in
    every chunk); the rest keep their mild decays."""
    B, S, H, hs = logw.shape
    rng = np.random.default_rng(S + hs)
    w = logw.cpu().numpy().copy()
    strong = -rng.uniform(5.0, 6.0, (B, S, H, hs)).astype(np.float32) * (16 / chunk)
    if which == "mixed":
        odd = (np.arange(S) // chunk) % 2 == 1
        w[:, odd] = strong[:, odd]
    else:
        w[..., hs // 3] = strong[..., hs // 3]
    return torch.from_numpy(w).to(logw.device)


def _twice_within(args, chunk):
    """Two launches bit-equal (no atomics), and within the tolerance."""
    got = ops.rwkv6_chunk_bwd(*args, chunk)
    again = ops.rwkv6_chunk_bwd(*args, chunk)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _within(got, args, chunk)


def _within(got, args, chunk):
    want = rwkv6_chunk_bwd_ref(*args, chunk, torch.float64)
    scale = rwkv6_chunk_bwd_scale(*args, chunk)
    for name, g, w, s in zip(NAMES, got, want, scale):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        err = (g.double() - w).abs()
        assert bool((err <= BWD_RTOL * s).all()), (name, float((err / s.clamp_min(1e-300)).max()))


SHAPES = [(1, 2048, 32, 64, 16), (2, 64, 2, 32, 16), (3, 48, 1, 16, 8), (2, 40, 3, 64, 8),
          (1, 32, 5, 32, 8), (4, 16, 2, 16, 16)]


@pytest.mark.parametrize("B,S,H,hs,chunk", SHAPES)
def test_kernel_matches_plain(dev, B, S, H, hs, chunk):
    args = _inputs(B, S, H, hs, B * S + hs, dev)
    before = ops.bwd_launches
    got = ops.rwkv6_chunk_bwd(*args, chunk)
    again = ops.rwkv6_chunk_bwd(*args, chunk)
    torch.cuda.synchronize()
    assert ops.bwd_launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))      # no atomics: the same bits
    _within(got, args, chunk)


@pytest.mark.parametrize("hs", [16, 32, 64])
@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("decay", [(3.3, 3.7), (5.0, 6.0)])
def test_strong_decay(dev, hs, chunk, decay):
    """Chunks that decay by 53-59 (just inside the clip at c 16) and by
    80-96 at c 16 (past it: the clipped pairs' gradient is below e^{−60})."""
    per = tuple(x * 16 / chunk for x in decay)
    _twice_within(_inputs(1, 16 * chunk, 2, hs, hs + chunk, dev, per), chunk)


@pytest.mark.parametrize("which", ["mixed", "one_column"])
@pytest.mark.parametrize("hs,chunk", [(64, 16), (32, 8), (16, 16)])
def test_decays_that_switch_form(dev, which, hs, chunk):
    """Chunks that alternate between the factored and the pairwise form,
    and a sequence where only one key column passes −60."""
    args = _inputs(1, 16 * chunk, 2, hs, hs * chunk, dev)
    args[3] = _strong(args[3], chunk, which)
    _twice_within(args, chunk)


@pytest.mark.parametrize("B,S,H,hs,chunk", [(1, 128, 3, 64, 16), (3, 96, 5, 32, 8),
                                            (1, 64, 7, 16, 16), (8, 256, 4, 64, 16)])
def test_odd_heads_and_shared_sms(dev, B, S, H, hs, chunk):
    """B·H odd (15, 7: a cluster's rank pattern cannot hide an off-by-one)
    and B = 8 at (8, 256, 4, 64, 16), where several CTAs share an SM."""
    _twice_within(_inputs(B, S, H, hs, B + S + H, dev), chunk)


def test_launch_info(dev):
    """The launch the card takes: a cluster of 4 CTAs a (b, h) (2 at hs 16),
    at least one CTA an SM, shared memory under the card's 227 KB a CTA."""
    for hs in (16, 32, 64):
        for chunk in (8, 16):
            info = ops.bwd_info(hs, chunk)
            assert info["split"] == {16: 2, 32: 4, 64: 4}[hs]
            assert 0 < info["smem_bytes"] <= 227 * 1024 and info["ctas_per_sm"] >= 1


def test_autograd_function_launches_both_kernels(dev):
    r, k, v, logw, u, do = _inputs(2, 64, 2, 64, 9, dev)
    xs = [t.clone().requires_grad_() for t in (r, k, v, logw, u)]
    ops.reset_launches()
    out = ops.rwkv6_chunk(*xs, 16)
    got = torch.autograd.grad((out * do).sum(), xs)
    assert (ops.launches, ops.bwd_launches) == (1, 1)
    assert torch.equal(out.detach(), ops.rwkv6_chunk(r, k, v, logw, u, 16))
    want = ops.rwkv6_chunk_bwd(r, k, v, logw, u, do, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_relational_weights_pass_launches_once_an_edge(dev):
    """``relational_example_weights`` on a small star on the card: its one
    pass launches the segment_sum kernel once an edge of the join tree (n
    tables, n − 1 edges), and the weights are a distribution."""
    from repro_torch.core import BoostConfig, Booster
    from repro_torch.data import relational_example_weights
    from repro_torch.kernels.segment_sum import ops as sops
    from repro_torch.relational.generators import star_schema

    schema = star_schema(n_fact=4096, n_dim=64, device=dev)
    booster = Booster(schema, BoostConfig(n_trees=2, depth=2, mode="sketch", sketch_k=64))
    trees, _ = booster.fit()
    sops.reset_launches()
    w = relational_example_weights(booster, trees, "fact")
    torch.cuda.synchronize()
    assert sops.launches == schema.n_tables - 1 > 0
    assert w.dtype == np.float32 and w.shape == (4096,)
    assert abs(float(w.sum(dtype=np.float64)) - 1.0) < 1e-6 and (w > 0).all()
