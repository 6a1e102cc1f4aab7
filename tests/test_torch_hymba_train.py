"""The port's Hymba training path (``hymba_1_5b`` SMOKE: 2 layers, d 128, 4
query and 2 K/V heads of 32, window 64 on layer 1, 8 meta tokens, SSM
state 4 and chunk 8; float32) on the CPU against the JAX reference.

The reference's ``Model.init(PRNGKey(0))`` is carried across by
``convert.lm_stacked``; the same numpy batches go through both.  The
prompts hold 72 tokens, 80 positions with the meta tokens, so layer 1's
window of 64 bites past them.  On the CPU the port's training attention
is the plain forward (``ref.block_attn_fwd``, with the layer's window) and
the port of the reference's custom VJP over the window's band
(``ref.block_attn_bwd``); the compressor's sketches are the plain float64
``index_add_``.

Tolerances (float32 sums in other orders):
- ``Model.loss``: 1e-5 relative;
- every gradient leaf: 1e-4 · max|g| of the leaf;
- the windowed attention's output and its dq, dk, dv against ``jax.vjp``
  of the reference's ``_block_attn``: 1e-4 · max|·| of each;
- the checkpoint of ``launch/train.main``: bit for bit.

One train step against the reference's is in
``tests/test_torch_hymba_train_step.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.models import layers as RL
from repro.optim import adamw as ref_adamw
from repro_torch import configs, convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.kernels.flash_attention import attention_train
from repro_torch.launch import train as T
from repro_torch.models import Model, layer_views
from repro_torch.models import ssm as SSM
from repro_torch.tree import leaves, paths

ARCH = "hymba_1_5b"
B, S = 2, 72                       # 80 positions with the 8 meta tokens: past the window of 64
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _ref(remat=True):
    cfg = ref_configs.get_smoke(ARCH).replace(dtype="float32", remat=remat)
    model = RefModel(cfg)
    return model, jax.jit(model.init)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(remat=True):
    model, _ = _ref(remat)
    return jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b), has_aux=True))


def _port(remat=True):
    return Model(configs.get_smoke(ARCH).replace(dtype="float32", remat=remat), device="cpu")


def _tokens(seed=1, rows=B):
    return np.random.default_rng(seed).integers(0, 512, (rows, S)).astype(np.int32)


def _leaf_close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


# ------------------------------------------------------------ the loss --
@pytest.mark.parametrize("remat,masked", [(True, False), (False, True)])
def test_loss_and_every_gradient_leaf_match_reference(remat, masked):
    """Loss (meta tokens prepended, positions 0..M + S − 1, each layer's
    own window, the M prefix positions dropped before the logits) and the
    gradient of every leaf, ``meta`` and each ``ssm`` weight among them."""
    _, rp = _ref(remat)
    batch = {"tokens": _tokens()}
    if masked:
        batch["loss_mask"] = (np.random.default_rng(2).random((B, S)) < 0.7).astype(np.float32)
    (want, wm), wg = _ref_value_and_grad(remat)(rp, {k: jnp.asarray(v) for k, v in batch.items()})
    stacked = convert.lm_stacked(rp, "cpu")
    for t in leaves(stacked):
        t.requires_grad_()
    loss, metrics = _port(remat).loss(layer_views(stacked),
                                      {k: torch.from_numpy(v) for k, v in batch.items()})
    got = torch.autograd.grad(loss, leaves(stacked))
    for g, w in ((loss, want), (metrics["ce"], wm["ce"]), (metrics["tokens"], wm["tokens"])):
        assert abs(float(g) - float(w)) <= LOSS_RTOL * abs(float(w)), (g, w)
    names = paths(stacked)
    assert names == paths(rp) and len(got) == len(jax.tree.leaves(wg)) == 24
    assert {"meta", "layers.ssm.A_log", "layers.ssm.conv", "layers.bn_s.scale"} <= set(names)
    for name, g, w in zip(names, got, jax.tree.leaves(wg)):
        assert bool(torch.isfinite(g).all()), name
        _leaf_close(g.numpy(), w, GRAD_RTOL, name)


# ------------------------------------------- the windowed attention --
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("window,G", [(5, 3), (16, 3), (23, 3), (45, 3), (100, 3), (9, 1)])
def test_windowed_attention_train_matches_reference_vjp(window, G, traced):
    """``attention_train(..., window=w)`` against ``jax.vjp`` of the
    reference's ``_block_attn`` with w a static int (its band branch) and a
    traced int32 (its masked scan over every kv block): S = 45 off the kv
    chunk of 16, w below, at and above the chunk and ≥ S, G 3 and 1."""
    Bq, Sq, Kh, dh, qc, kc = 2, 45, 2, 16, 16, 16
    rng = np.random.default_rng(window + 7 * G)
    q = rng.standard_normal((Bq, Sq, Kh * G, dh)).astype(np.float32)
    k, v = (rng.standard_normal((Bq, Sq, Kh, dh)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((Bq, Sq, Kh * G * dh)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(Sq, dtype=jnp.int32), (Bq, Sq))
    w = jnp.int32(window) if traced else window
    out, vjp = jax.vjp(lambda q_, k_, v_: RL._block_attn(q_, k_, v_, pos, pos, True, w, qc, kc),
                       *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got_out = attention_train(tq, tk, tv, True, kc, window)
    _leaf_close(got_out.detach().numpy(), out, GRAD_RTOL, "out")
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(dout))
    for name, g, wv in zip(("dq", "dk", "dv"), got, want):
        _leaf_close(g.numpy(), wv, GRAD_RTOL, name)


# ------------------------------------------------------ the SSM branch --
def test_ssm_branch_gradient_under_checkpoint_at_hymba_widths():
    """``ssm_branch`` at Hymba-1.5B's widths (d 1,600, 25 heads of 64,
    state 16, chunk 16), S = 200 (padded to 208), decays strong enough that
    a chunk's pairwise decays and the decay across chunks pass the −60
    clip: under ``torch.utils.checkpoint`` its gradients are those of the
    plain call, bit for bit, and finite."""
    cfg = configs.get(ARCH).replace(dtype="float32")
    gen = torch.Generator().manual_seed(3)
    p = SSM.init_ssm(gen, cfg, torch.float32, cfg.n_heads * cfg.head_dim)
    p["A_log"] = torch.full_like(p["A_log"], float(np.log(8.0)))   # log a ≈ −8·dt a position
    u = torch.randn(1, 200, cfg.d_model, generator=gen)
    ws = [p["wx"], p["wdt"], p["A_log"], p["conv"], p["Dskip"]]
    grads = []
    for ckpt in (False, True):
        x = u.clone().requires_grad_()
        for t in ws:
            t.requires_grad_()
        f = lambda x_: SSM.ssm_branch(p, cfg, x_)
        out = torch.utils.checkpoint.checkpoint(f, x, use_reentrant=False) if ckpt else f(x)
        grads.append(torch.autograd.grad(out.square().sum(), [x, *ws]))
    loga = -torch.nn.functional.softplus(u @ p["wdt"].detach()) * 8.0
    assert float(loga[0, :16].sum(0).max()) < -60                 # one chunk passes the clip
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


def test_opt_state_and_params_carry_meta_and_ssm_leaves():
    """``convert.lm_stacked`` and ``convert.opt_state`` carry the meta
    tokens and every SSM leaf in the reference's order, bit for bit."""
    _, rp = _ref()
    rcfg = ref_adamw.AdamWConfig()
    rstate = ref_adamw.init(rcfg, rp)
    rstate = rstate._replace(step=jnp.int32(3), m=jax.tree.map(lambda x: x + 0.5, rstate.m))
    state = convert.opt_state(rstate, "cpu")
    params = convert.lm_stacked(rp, "cpu")
    assert paths(state.m) == paths(params) == paths(rp)
    for got, want in ((params, rp), (state.m, rstate.m), (state.v, rstate.v)):
        for a, b in zip(leaves(got), jax.tree.leaves(want)):
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert int(state.step) == 3


# ------------------------------------------------------------------ CLI --
def test_train_main_runs_hymba_on_the_cpu(tmp_path, capsys):
    """``launch/train.main`` with ``--arch hymba_1_5b``: 3 steps with
    compressed gradients, finite losses, and a checkpoint that restores
    the meta tokens and the SSM weights bit for bit."""
    flags = ["--arch", ARCH, "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", str(S),
             "--n-micro", "2", "--compress-grads", "8", "--log-every", "1", "--ckpt-dir",
             str(tmp_path)]
    params = T.main(flags)
    losses = [float(l.split('"loss": ')[1].split(",")[0])
              for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    like = T.build(T.parser().parse_args(flags))
    like.pipe.stop()
    got = Checkpointer(str(tmp_path)).restore(3, like.state())
    assert int(got[2]["round"]) == 3
    assert paths(got[0]) == paths(params)
    for a, b in zip(leaves(got[0]), leaves(params)):
        assert torch.equal(a, b)
