"""The port's MoE training (``kind="moe"``: ``dbrx_132b`` SMOKE, 4 experts
top-2, capacity factor 1.25; ``llama4_scout_17b_a16e`` SMOKE, 4 experts
top-1 and a shared expert, capacity factor 1.5; 2 layers, d 128, float32)
on the CPU against the JAX reference.

The reference's ``Model.init(PRNGKey(0))`` is carried across by
``convert.lm_stacked``; the same numpy batches go through both.  The
training loss routes at the config's own capacity factor, so (token,
expert) pairs are dropped, and the tests check that they are: the
gradient then runs through the gates, the router (the top-k values and
the mean probabilities of the aux loss), the scatter into the (E, C, D)
buffer, the expert products and the gather, and a dropped pair gives
nothing and takes no gradient.

Tolerances (float32 sums in other orders):
- ``moe_ffn``'s output, aux and every gradient (weights and input)
  against ``jax.vjp`` of the reference's: 1e-4 · max|·| of each; a top-1
  router's (Scout), whose gate p/p is 1, against the aux loss's gradient
  alone within that plus the gate path's float32 residue, 2⁻²⁰ · max|x| ·
  Σ_t |cot_t · out_t|;
- ``Model.loss``: 1e-5 relative; every gradient leaf: 1e-4 · max|g|;
- one compressed train step as ``tests/test_torch_hymba_train_step.py``:
  loss and grad norm 1e-5 relative, every compressed gradient leaf 1e-4
  · max|g|, the parameters through the reference's AdamW of the port's
  own gradient within 2e-6 relative (plus 2e-6 · lr).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import Model as RefModel
from repro.models import moe as RMOE
from repro.optim import adamw as ref_adamw
from repro.optim.grad_compress import CountSketchCompressor as RefCompressor
from repro_torch import configs, convert
from repro_torch.launch import steps
from repro_torch.launch import train as T
from repro_torch.models import Model, layer_views, moe, stack_layers
from repro_torch.optim import CountSketchCompressor, adamw
from repro_torch.tree import leaves, paths

ARCHS = ("dbrx_132b", "llama4_scout_17b_a16e")
B, S = 2, 30
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ADAM_RTOL = 2e-6


@functools.lru_cache(maxsize=None)
def _ref(arch):
    cfg = ref_configs.get_smoke(arch).replace(dtype="float32")
    model = RefModel(cfg)
    return cfg, model, jax.jit(model.init)(jax.random.PRNGKey(0))


def _port(arch, **kw):
    return Model(configs.get_smoke(arch).replace(dtype="float32", **kw), device="cpu")


def _tokens(seed=1, rows=B):
    return np.random.default_rng(seed).integers(0, 512, (rows, S)).astype(np.int32)


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


class _Recorder:
    """``models/moe.route`` recorded (the stand-in ``moe.py``'s docstring
    allows): every call's Routing, in call order."""

    def __init__(self, monkeypatch):
        self.seen, route = [], moe.route

        def recording(*a, **kw):
            r = route(*a, **kw)
            self.seen.append(r)
            return r
        monkeypatch.setattr(moe, "route", recording)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_gradient_matches_reference_vjp(arch):
    """Output, aux and the gradients of (out · cot).sum() + aux for every
    weight, the float32 router's among them, and the input, at the
    config's training factor with pairs dropped; the tokens whose every
    pair is dropped get no gradient from the experts (DBRX: no shared
    expert, so their output and its gradient are exactly 0)."""
    cfg, _, _ = _ref(arch)
    pcfg = configs.get_smoke(arch).replace(dtype="float32")
    p = RMOE.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    # experts 0 and 1 favoured by every token: they overflow (and DBRX's
    # last tokens lose both their pairs)
    p = {**p, "router": p["router"].at[:, 0].add(0.03).at[:, 1].add(0.025)}
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 20, cfg.d_model)) + 0.5).astype(np.float32)
    cot = rng.standard_normal((3, 20, cfg.d_model)).astype(np.float32)

    def f(p_, x_):
        out, aux = RMOE.moe_ffn(p_, cfg, x_)
        return (out * cot).sum() + aux, (out, aux)
    (_, (want, want_aux)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1),
                                                                 has_aux=True))(p, jnp.asarray(x))
    tp = convert.lm_stacked({"moe": p}, "cpu")["moe"]
    for t in leaves(tp):
        t.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_ffn(tp, pcfg, tx)
    _close(out.detach().numpy(), want, GRAD_RTOL, "out")
    assert abs(float(aux.detach()) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    (gx_out,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), tx, retain_graph=True)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum() + aux, [*leaves(tp), tx])
    assert paths(tp) == [n for n in paths(p)]
    for name, g, w in zip(paths(tp) + ["x"], got, jax.tree.leaves(gp) + [gx]):
        if name == "router" and cfg.top_k == 1:
            # a top-1 gate is p/p = 1: the router's gradient is the aux
            # loss's alone, and the gate path leaves float32 residues on both
            # sides, each below 2⁻²⁰·max|x|·Σ_t |cot_t·out_t|
            g_aux = jax.jit(jax.grad(lambda r: RMOE.moe_ffn({**p, "router": r}, cfg,
                                                            jnp.asarray(x))[1]))(p["router"])
            res = 2.0 ** -20 * np.abs(x).max() * np.abs((out.detach().numpy() * cot).sum(-1)).sum()
            for side in (g.numpy(), np.asarray(w)):
                assert np.abs(side - np.asarray(g_aux)).max() <= \
                    GRAD_RTOL * np.abs(np.asarray(g_aux)).max() + res, name
            continue
        _close(g.numpy(), w, GRAD_RTOL, name)
    r = moe.route(tp, pcfg, tx.detach().reshape(60, cfg.d_model))
    assert int((~r.keep).sum()) > 0
    if not cfg.shared_expert:
        gone = ~r.keep.view(60, cfg.top_k).any(1)
        assert bool(gone.any())
        assert not out.detach().reshape(60, -1)[gone].any()
        assert not gx_out.reshape(60, -1)[gone].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(arch, monkeypatch):
    """``Model.loss`` (every layer's aux added) and the gradient of every
    leaf against ``jax.value_and_grad`` of the reference's loss, under
    remat; the forward dropped pairs at the training factor, and each
    block's recompute routed every pair as its forward did."""
    _, ref, rp = _ref(arch)
    batch = {"tokens": _tokens()}
    (want, wm), wg = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        rp, {"tokens": jnp.asarray(batch["tokens"])})
    stacked = convert.lm_stacked(rp, "cpu")
    for t in leaves(stacked):
        t.requires_grad_()
    rec = _Recorder(monkeypatch)
    loss, metrics = _port(arch).loss(layer_views(stacked),
                                     {"tokens": torch.from_numpy(batch["tokens"])})
    got = torch.autograd.grad(loss, leaves(stacked))
    for g, w in ((loss.detach(), want), (metrics["ce"].detach(), wm["ce"]),
                 (metrics["aux"].detach(), wm["aux"])):
        assert abs(float(g) - float(w)) <= LOSS_RTOL * abs(float(w)), (g, w)
    assert float(metrics["aux"].detach()) > 0
    names = paths(stacked)
    assert names == paths(rp) and len(got) == len(jax.tree.leaves(wg))
    assert "layers.moe.router" in names
    for name, g, w in zip(names, got, jax.tree.leaves(wg)):
        assert bool(torch.isfinite(g).all()), name
        _close(g.numpy(), w, GRAD_RTOL, name)
    # 2 layers: forward 0, 1, then the backward's recomputes 1, 0
    assert len(rec.seen) == 4
    assert sum(int((~r.keep).sum()) for r in rec.seen[:2]) > 0
    for fwd, again in ((rec.seen[0], rec.seen[3]), (rec.seen[1], rec.seen[2])):
        assert torch.equal(fwd.expert, again.expert) and torch.equal(fwd.keep, again.keep)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_replays_given_choices(arch):
    """``route(..., expert=e)`` with a routing's own choices gives that
    routing back (gates, ranks, drops, aux); with other choices it ranks
    and gates those, their gates the probabilities renormalised."""
    pcfg = configs.get_smoke(arch).replace(dtype="float32")
    p = moe.init_moe(torch.Generator().manual_seed(2), pcfg, torch.float32)
    x = torch.randn(40, pcfg.d_model, generator=torch.Generator().manual_seed(3))
    r = moe.route(p, pcfg, x, 0.5)
    again = moe.route(p, pcfg, x, 0.5, expert=r.expert)
    for f in ("expert", "gate", "rank", "keep", "aux"):
        assert torch.equal(getattr(r, f), getattr(again, f)), f
    other = (r.expert + 1) % pcfg.n_experts
    s = moe.route(p, pcfg, x, 0.5, expert=other)
    probs = torch.softmax(x @ p["router"], -1).gather(1, other)
    assert torch.equal(s.expert, other)
    assert torch.allclose(s.gate, probs / probs.sum(-1, keepdim=True))
    flat = other.reshape(-1).tolist()
    assert s.rank.tolist() == [flat[:i].count(e) for i, e in enumerate(flat)]


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
    """``make_train_step`` for DBRX's SMOKE (2 microbatches, compression 8
    with the reference's hashes, AdamW) against the reference's jitted
    step: the stacked (L, E, D, F) expert leaves and the (L, D, E) router
    are sketched and stepped as the reference's."""
    arch = "dbrx_132b"
    cfg, ref, rp = _ref(arch)
    model = _port(arch)
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

    toks = _tokens(seed=10, rows=4)
    (rp1, _, rm), rgrads = jax.jit(rrun)(rp, ref_adamw.init(rcfg, rp),
                                          {"tokens": jnp.asarray(toks)})
    params = convert.lm_stacked(rp, "cpu")
    state = adamw.init(ocfg, params)
    before = convert.to_numpy((params, state))
    params, state, pm = steps.make_train_step(model, ocfg, 2, compressor=pcompress)(
        params, state, {"tokens": torch.from_numpy(toks)})
    for k in ("loss", "grad_norm"):
        assert abs(float(pm[k]) - float(rm[k])) <= LOSS_RTOL * abs(float(rm[k])), k
    lr = pm["lr"]
    names = paths(params)
    assert tuple(params["layers"]["moe"]["w_gate"].shape) == (2, 4, 128, 128)
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


def test_bf16_model_keeps_its_float32_router_through_a_step():
    """A bf16 MoE model's stacked layout holds the float32 router (L, D, E)
    beside bf16 experts; AdamW's moments and the float32 accumulators
    stack, a compressed step sketches and updates it, and it stays float32."""
    model = Model(configs.get_smoke("llama4_scout_17b_a16e"), device="cpu")
    params = stack_layers(model.init(torch.Generator().manual_seed(0)))
    router = params["layers"]["moe"]["router"]
    assert router.dtype == torch.float32 and tuple(router.shape) == (2, 128, 4)
    assert params["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3)
    state = adamw.init(ocfg, params)
    comp = CountSketchCompressor(ratio=8)
    before = router.clone()
    params, state, m = steps.make_train_step(model, ocfg, 1, compressor=comp)(
        params, state, {"tokens": torch.from_numpy(_tokens(seed=3))})
    assert np.isfinite(float(m["loss"])) and comp._round == 1
    router = params["layers"]["moe"]["router"]
    assert router.dtype == torch.float32 and not torch.equal(router, before)
    i = paths(params).index("layers.moe.router")
    assert comp._state[i].dtype == torch.float32 and comp._state[i].numel() == router.numel()


def test_adamw_slices_a_large_leaf_bit_for_bit(monkeypatch):
    """AdamW updates a leaf past ``CHUNK`` elements in slices: the same
    bits as one pass over it."""
    gen = torch.Generator().manual_seed(5)
    p = {"w": torch.randn(10, 37, generator=gen).to(torch.bfloat16),
         "r": torch.randn(3, 5, generator=gen)}
    g = {"w": torch.randn(10, 37, generator=gen), "r": torch.randn(3, 5, generator=gen)}
    ocfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    runs = []
    for chunk in (adamw.CHUNK, 64):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        q = {k: v.clone() for k, v in p.items()}
        st = adamw.init(ocfg, q)
        for _ in range(2):
            q, st, _ = adamw.apply(ocfg, q, g, st)
        runs.append(leaves((q, st.m, st.v)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_compressor_refuses_a_leaf_past_the_kernel_limit():
    """A gradient leaf of 2³¹ elements (DBRX's stacked w_gate at 3 layers
    holds 3.2 · 10⁹) is refused before any leaf or state is touched."""
    comp = CountSketchCompressor(ratio=8)
    small = torch.ones(64)
    grads = {"a": small, "b": torch.empty(2 ** 31, device="meta")}
    with pytest.raises(ValueError, match="at most 2147483647"):
        comp(grads)
    assert comp._state is None and comp._round == 0 and bool((small == 1).all())


def test_train_cli_runs_dbrx_on_the_cpu(tmp_path, capsys):
    """``launch/train.main(["--arch", "dbrx_132b", ...])``: 3 steps, finite
    losses, a checkpoint at the end."""
    flags = ["--arch", "dbrx_132b", "--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
             "16", "--n-micro", "1", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    T.main(flags)
    losses = [float(l.split('"loss": ')[1].split(",")[0])
              for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert (tmp_path / "step_3").exists()
