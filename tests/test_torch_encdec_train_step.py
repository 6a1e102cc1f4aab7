"""One train step of the port's encoder–decoder (``seamless_m4t_medium``
SMOKE, float32: 2 encoder and 2 decoder layers, d 128) on the CPU against
the reference's jitted ``make_train_step``: 2 microbatches of 2 rows, each
37 frames and 29 tokens, count-sketch compression 8 with the reference's
hashes injected into the port's, AdamW.  A file of its own: the
reference's whole step is jitted (~20 s of compile).

Tolerances (float32 sums in other orders), as
``tests/test_torch_hymba_train_step.py``:
- loss and grad norm: 1e-5 relative;
- every compressed gradient leaf: 1e-4 · max|g| of the leaf;
- the updated parameters: AdamW's limits (2e-6 relative, plus 2e-6 · lr)
  against the reference's AdamW of the port's own state and gradient;
  against the reference's own step within 2 · lr everywhere and 1e-4 · lr
  on all but 1e-3 of each leaf's elements.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import Model as RefModel
from repro.optim import adamw as ref_adamw
from repro.optim.grad_compress import CountSketchCompressor as RefCompressor
from repro_torch import configs, convert
from repro_torch.launch import steps
from repro_torch.models import Model
from repro_torch.optim import CountSketchCompressor, adamw
from repro_torch.tree import leaves, paths

ARCH = "seamless_m4t_medium"
SE, S = 37, 29
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ADAM_RTOL = 2e-6


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


def _inject(port: CountSketchCompressor, seed=0):
    """The port compressor's hashes replaced by the reference's for the
    same (leaf, round)."""
    hasher = RefCompressor(ratio=port.ratio, seed=seed)

    def leaf_hash(i, n):
        hasher._round = port._round
        return convert.hash2(hasher._leaf_hash(i, n))
    port._leaf_hash = leaf_hash
    return port


def test_one_train_step_matches_reference():
    """``make_train_step`` (2 microbatches, compression 8 with the
    reference's hashes, AdamW) against the reference's jitted step: the
    encoder's leaves sit between ``embed`` and ``layers`` in the hashes'
    leaf order, as in the reference's pytree."""
    cfg = ref_configs.get_smoke(ARCH).replace(dtype="float32")
    ref = RefModel(cfg)
    rp = jax.jit(ref.init)(jax.random.PRNGKey(0))
    model = Model(configs.get_smoke(ARCH).replace(dtype="float32"), device="cpu")
    rcfg = ref_adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=3)
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=3)
    rcomp, pcomp = RefCompressor(ratio=8), _inject(CountSketchCompressor(ratio=8))
    rec_r, rec_p = [], []

    def rcompress(g):
        rec_r.append(rcomp(g))
        return rec_r[-1]

    def pcompress(g):
        pcomp(g)
        rec_p.append([t.clone() for t in leaves(g)])
        return g

    rstep = ref_make_train_step(ref, rcfg, 2, compressor=rcompress)

    def rrun(p, s, b):
        rec_r.clear()
        return rstep(p, s, b), rec_r[-1]

    rng = np.random.default_rng(10)
    batch = {"tokens": rng.integers(0, 512, (4, S)).astype(np.int32),
             "src_frames": (rng.standard_normal((4, SE, 128)) * 0.02).astype(np.float32)}
    (rp1, _, rm), rgrads = jax.jit(rrun)(rp, ref_adamw.init(rcfg, rp),
                                          {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.lm_stacked(rp, "cpu")
    state = adamw.init(ocfg, params)
    before = convert.to_numpy((params, state))
    params, state, pm = steps.make_train_step(model, ocfg, 2, compressor=pcompress)(
        params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        assert abs(float(pm[k]) - float(rm[k])) <= LOSS_RTOL * abs(float(rm[k])), k
    lr = pm["lr"]
    names = paths(params)
    for name, gp, gr in zip(names, rec_p[-1], jax.tree.leaves(rgrads)):
        _close(gp.numpy(), gr, GRAD_RTOL, f"compressed grad {name}")
    treedef = jax.tree.structure(rp)
    want, _, _ = ref_adamw.apply(rcfg, jax.tree.unflatten(treedef, leaves(before[0])),
                                 jax.tree.unflatten(treedef, [g.numpy() for g in rec_p[-1]]),
                                 ref_adamw.OptState(*before[1][:3], ()))
    for name, a, b, r in zip(names, leaves(params), jax.tree.leaves(want), jax.tree.leaves(rp1)):
        a, b, r = a.numpy(), np.asarray(b), np.asarray(r)
        np.testing.assert_allclose(a, b, rtol=ADAM_RTOL, atol=ADAM_RTOL * lr, err_msg=name)
        d = np.abs(a - r)
        assert (d <= 2 * lr).all() and (d > 1e-4 * lr).mean() <= 1e-3, name
