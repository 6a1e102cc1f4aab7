"""RWKV-6 training in the port (the WKV's backward and ``Model.loss`` for
``kind="rwkv"``) on the CPU against the JAX reference, and the autograd
guard of the kernels that have no backward.

On the CPU the WKV's ``autograd.Function`` runs the plain forward
(``ref.rwkv6_chunk_ref``) and the plain backward
(``ref.rwkv6_chunk_bwd_ref``), the formulas of the backward kernel.

Tolerances:
- the plain backward in float64 against float64 autograd through the
  plain forward: 1e-10 of the gradients' scale (``rwkv6_chunk_bwd_scale``:
  the same formulas on |r|, |k|, |v|, |u|, |do|), also where a chunk decays
  by more than 60 (the forward clips there; its gradient is e^{−60} of a
  term) and through the model's padding of S to a multiple of the chunk;
- float32 against ``jax.grad`` of the reference's ``rwkv_chunked``: 1e-4
  of that scale (float32 sums in other orders, and the decays' gradient
  reached through a cancellation of two sums, measured ≤ 6e-6);
- ``Model.loss``: loss 1e-5 relative, gradients 1e-4 · max|g| per leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.models.rwkv6 import rwkv_chunked
from repro_torch import configs, convert
from repro_torch.data import TokenPipeline
from repro_torch.kernels.count_sketch import ops as cops
from repro_torch.kernels.polymul import ops as pops
from repro_torch.kernels.rwkv6_chunk import (rwkv6_chunk, rwkv6_chunk_bwd, rwkv6_chunk_bwd_ref,
                                             rwkv6_chunk_bwd_scale, rwkv6_chunk_ref)
from repro_torch.kernels.segment_sum import ops as sops
from repro_torch.launch import train as T
from repro_torch.models import Model, layer_views
from repro_torch.tree import leaves, paths

ARCH = "rwkv6_1_6b"
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
F64_RTOL = 1e-10


def _inputs(B, S, H, hs, decay=(0.01, 2.0), seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((B, S, H, hs)).astype(dtype) for _ in range(4))
    logw = (-rng.uniform(*decay, (B, S, H, hs))).astype(dtype)
    u = rng.standard_normal((H, hs)).astype(dtype)
    return r, k, v, logw, u, do


def _within(got, want, scale, rtol, what):
    err = (torch.as_tensor(np.asarray(got), dtype=torch.float64)
           - torch.as_tensor(np.asarray(want), dtype=torch.float64)).abs()
    bad = err > rtol * scale
    assert not bool(bad.any()), (f"{what}: {int(bad.sum())} elements off, max |err|/scale "
                                 f"{float((err / scale.clamp_min(1e-300)).max())}")


# ------------------------------------------------------------ backward --
@pytest.mark.parametrize("B,S,H,hs,c,decay", [
    (2, 64, 2, 16, 8, (0.01, 2.0)),
    (1, 48, 3, 32, 16, (0.01, 2.0)),
    (2, 64, 2, 16, 16, (3.3, 3.7)),        # every chunk decays by 53-59: just inside the clip
    (1, 64, 1, 64, 16, (5.0, 6.0)),        # every chunk decays by 80-96: the clip bites
])
def test_bwd_ref_matches_float64_autograd(B, S, H, hs, c, decay):
    r, k, v, logw, u, do = (torch.from_numpy(x) for x in _inputs(B, S, H, hs, decay))
    xs = [t.clone().requires_grad_() for t in (r, k, v, logw, u)]
    want = torch.autograd.grad((rwkv6_chunk_ref(*xs, c) * do).sum(), xs)
    got = rwkv6_chunk_bwd_ref(r, k, v, logw, u, do, c)
    scale = rwkv6_chunk_bwd_scale(r, k, v, logw, u, do, c)
    for name, g, w, s in zip(("dr", "dk", "dv", "dlogw", "du"), got, want, scale):
        assert g.shape == w.shape and g.dtype == torch.float64
        _within(g, w, s, F64_RTOL, name)


def test_autograd_through_the_padding_matches_float64():
    """S = 45, padded to 48 as ``time_mix_out`` pads it: the Function's
    gradients of the unpadded inputs against float64 autograd."""
    r, k, v, logw, u, do = (torch.from_numpy(x) for x in _inputs(2, 45, 2, 16, seed=3))
    pad = lambda t: F.pad(t, (0, 0, 0, 0, 0, 3))
    xs = [t.clone().requires_grad_() for t in (r, k, v, logw, u)]
    want = torch.autograd.grad((rwkv6_chunk_ref(*(pad(x) for x in xs[:4]), xs[4], 16)[:, :45]
                                * do).sum(), xs)
    ys = [t.float().requires_grad_() for t in (r, k, v, logw, u)]
    out = rwkv6_chunk(*(pad(y) for y in ys[:4]), ys[4], 16)[:, :45]
    got = torch.autograd.grad((out * do.float()).sum(), ys)
    scale = rwkv6_chunk_bwd_scale(*(pad(t) for t in (r, k, v, logw)), u, pad(do), 16)
    scale = [s[:, :45] if s.dim() == 4 else s for s in scale]
    for name, g, w, s in zip(("dr", "dk", "dv", "dlogw", "du"), got, want, scale):
        _within(g, w, s, GRAD_RTOL, name)


@pytest.mark.parametrize("B,S,H,hs,c,decay", [
    (2, 64, 2, 32, 16, (0.01, 2.0)),
    (3, 48, 1, 16, 8, (0.01, 2.0)),
    (1, 64, 2, 16, 16, (5.0, 6.0)),
])
def test_port_autograd_matches_jax_grad(B, S, H, hs, c, decay):
    """float32: the port's Function (forward, then the plain backward)
    against ``jax.grad`` of the reference's chunked scan."""
    arrs = _inputs(B, S, H, hs, decay, seed=B + S, dtype=np.float32)
    r, k, v, logw, u, do = arrs
    want = jax.grad(lambda *a: jnp.sum(rwkv_chunked(*a, c) * do), argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(x) for x in (r, k, v, logw, u)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (r, k, v, logw, u)]
    got = torch.autograd.grad((rwkv6_chunk(*xs, c) * torch.from_numpy(do)).sum(), xs)
    direct = rwkv6_chunk_bwd(*(torch.from_numpy(x) for x in arrs), c)
    scale = rwkv6_chunk_bwd_scale(*(torch.from_numpy(x) for x in arrs), c)
    for name, g, d, w, s in zip(("dr", "dk", "dv", "dlogw", "du"), got, direct, want, scale):
        assert g.dtype == torch.float32 and torch.equal(g, d)
        _within(g, w, s, GRAD_RTOL, name)


def test_state_has_no_backward():
    r, k, v, logw, u, _ = (torch.from_numpy(x) for x in _inputs(1, 16, 1, 16, dtype=np.float32))
    with pytest.raises(RuntimeError, match="terminal state has no backward"):
        rwkv6_chunk(r.requires_grad_(), k, v, logw, u, 8, return_state=True)
    with torch.no_grad():
        out, state = rwkv6_chunk(r, k, v, logw, u, 8, return_state=True)
    assert state.shape == (1, 1, 16, 16) and not out.requires_grad


# --------------------------------------------------------------- model --
def _ref(remat):
    cfg = ref_configs.get_smoke(ARCH).replace(dtype="float32", remat=remat)
    model = RefModel(cfg)
    return model, model.init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("remat", [True, False])
def test_model_loss_and_gradients_match_reference(remat):
    """``Model.loss`` of the smoke config (2 layers, d 128, 2 heads of 64,
    chunk 8; S 37 so the WKV pads) and its gradients against the
    reference's ``jax.value_and_grad(model.loss)``."""
    ref, rp = _ref(remat)
    toks = np.random.default_rng(4).integers(0, 512, (3, 37)).astype(np.int32)
    (want, wm), wg = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        rp, {"tokens": jnp.asarray(toks)})
    model = Model(configs.get_smoke(ARCH).replace(dtype="float32", remat=remat), device="cpu")
    stacked = convert.lm_stacked(rp, "cpu")
    for t in leaves(stacked):
        t.requires_grad_()
    loss, metrics = model.loss(layer_views(stacked), {"tokens": torch.from_numpy(toks),
                                                       "doc_ids": torch.arange(3)})
    assert abs(float(loss.detach()) - float(want)) <= LOSS_RTOL * abs(float(want))
    assert abs(float(metrics["ce"]) - float(wm["ce"])) <= LOSS_RTOL * abs(float(wm["ce"]))
    got = torch.autograd.grad(loss, leaves(stacked))
    assert len(got) == len(jax.tree.leaves(wg))
    for name, g, w in zip(paths(rp), got, jax.tree.leaves(wg)):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(), err_msg=name)


def test_train_cli_takes_an_rwkv_step_on_a_weighted_pipeline():
    """``launch/train.py``'s ``build`` for ``--arch rwkv6_1_6b`` (smoke
    size, compression 8), its pipeline replaced by a weighted one as a
    caller wires it: one step, a finite loss, and the batch's docs drawn
    from the weights' support."""
    args = T.parser().parse_args(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                                  "--batch", "4", "--seq", "24", "--n-micro", "2",
                                  "--compress-grads", "8"])
    tr = T.build(args)
    tr.pipe.stop()
    w = np.zeros(50, np.float32)
    w[[3, 17, 41]] = [0.5, 0.25, 0.25]
    tr.pipe = TokenPipeline(tr.model.cfg.vocab, 4, 24, seed=1, example_weights=w)
    try:
        before = [t.clone() for t in leaves(tr.params)]
        batch = tr.next_batch()
        assert set(batch["doc_ids"].tolist()) <= {3, 17, 41}
        metrics = tr.step(batch)
    finally:
        tr.pipe.stop()
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert any(not torch.equal(a, b) for a, b in zip(before, leaves(tr.params)))
    assert tr.compressor._round == 1


# ------------------------------------------------------- autograd guard --
def _meta(*shape):
    return torch.zeros(shape, device="meta").requires_grad_()


GUARDED = {
    "segment_sum": lambda: sops.segment_sum(_meta(1, 3, 2),
                                            sops.Segments.from_ids(np.array([0, 1, 1]), 2, "cpu")),
    "poly_mul": lambda: pops.poly_mul(_meta(2, 8), _meta(2, 8)),
    "count_sketch": lambda: cops.count_sketch_hashed(_meta(64), cops.Hash2(1, 0, 3, 0, 16)),
    "count_sketch unsketch": lambda: cops.unsketch(_meta(64), _meta(16),
                                                   cops.Hash2(1, 0, 3, 0, 16)),
}


@pytest.mark.parametrize("name", list(GUARDED))
def test_kernel_without_a_backward_refuses_a_gradient(name):
    """A wrapper whose kernel has no backward raises on an input that is
    not on the CPU and requires grad (here a ``meta`` tensor: the branch
    that decides it runs before the device's route), and takes the same
    input under ``torch.no_grad()`` on to its route: on ``meta``, outputs
    of the kernel's shapes and no launch."""
    with pytest.raises(RuntimeError, match=f"^{name}: the kernel has no backward"):
        GUARDED[name]()
    with torch.no_grad():
        assert GUARDED[name]().device.type == "meta"
    if name == "count_sketch":                      # the array form of the same wrapper
        with pytest.raises(RuntimeError, match="^count_sketch: the kernel has no backward"):
            cops.count_sketch(_meta(8), torch.zeros(8, dtype=torch.int32, device="meta"),
                              torch.ones(8, device="meta"), 16)
