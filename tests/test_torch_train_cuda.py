"""The training path on the card: the flash_attention kernel's lse output,
the differentiable attention and a smoke-size train step, against the
plain versions.

These tests need a CUDA device and the CUDA toolkit; on a host without
one they skip.  The file imports no JAX, so on the GPU machine it runs
without the shared fixtures:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_train_cuda.py

Tolerances: lse within 1e-4 + 1e-5 · |lse| of a float64 log-sum-exp
(float32 and bf16 inputs: the scores are exact products summed in
float32); float32 gradients of the attention within 1e-4 · max|grad| of
the plain forward's (the backward is the same plain code, the forward's
output and lse differ in the float32 sums); a float32 smoke train step on
the card within 1e-5 relative in loss and 1e-4 · max|g| in the compressed
gradient of the same step on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import attention_lse_dense
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model, stack_layers
from repro_torch.optim import CountSketchCompressor, adamw
from repro_torch.tree import leaves


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return "cuda"


@pytest.mark.parametrize("shape", [(2, 1000, 8, 2, 32), (2, 24, 8, 1, 16), (1, 2048, 32, 4, 64),
                                   (2, 300, 16, 16, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_lse_against_float64(dev, shape, dtype, causal):
    B, S, N, Kh, dh = shape
    rng = np.random.default_rng(S + N)
    q = torch.from_numpy(rng.standard_normal((B, S, N, dh), dtype=np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Kh, dh), dtype=np.float32)).to(dev, dtype)
            for _ in range(2))
    fops.reset_launches()
    out, lse = fops.flash_attention_gqa(q, k, v, causal, return_lse=True)
    assert fops.launches == 1 and lse.shape == (B, N, S) and lse.dtype == torch.float32
    assert torch.equal(out, fops.flash_attention_gqa(q, k, v, causal))
    want = attention_lse_dense(q, k, causal)
    assert bool(((lse.double() - want).abs() <= 1e-4 + 1e-5 * want.abs()).all())


@pytest.mark.parametrize("window", [None, 100])
def test_attention_train_gradients_match_plain(dev, window):
    """The kernel-served forward (with a window of 100 keys, the backward
    over each kv block's band) against the plain forward on the CPU."""
    rng = np.random.default_rng(1)
    B, S, N, Kh, dh = 2, 300, 8, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev)
               for s in ((B, S, N, dh), (B, S, Kh, dh), (B, S, Kh, dh)))
    dout = torch.from_numpy(rng.standard_normal((B, S, N * dh), dtype=np.float32)).to(dev)

    def grads():
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(fops.attention_train(*xs, True, 128, window), xs, dout)

    fops.reset_launches()
    got = grads()
    assert fops.launches == 1 and fops.windowed_launches == (window is not None)
    kernel = fops.flash_attention_gqa
    try:
        fops.flash_attention_gqa = lambda q_, k_, v_, c, return_lse, window=None: [
            t.to(dev) for t in kernel(q_.cpu(), k_.cpu(), v_.cpu(), c, return_lse=True,
                                      window=window)]
        want = grads()
    finally:
        fops.flash_attention_gqa = kernel
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_smoke_train_step_on_the_card_matches_the_cpu(dev):
    cfg = configs.get_smoke("tinyllama_1_1b").replace(dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 40)))
    out = {}
    for d in ("cpu", dev):
        model = Model(cfg, device=d)
        params = stack_layers(model.init(torch.Generator().manual_seed(0)))
        ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=3)
        rec = []
        comp = CountSketchCompressor(ratio=8)

        def compress(g, comp=comp, rec=rec):
            comp(g)
            rec.extend(t.cpu().clone() for t in leaves(g))
        step = make_train_step(model, ocfg, 2, compressor=compress)
        _, _, m = step(params, adamw.init(ocfg, params), {"tokens": toks.to(d)})
        out[d] = (float(m["loss"]), rec)
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out[dev]
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for a, b in zip(g_gpu, g_cpu):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
