"""The port's MoE serving (``kind="moe"``: ``dbrx_132b`` and
``llama4_scout_17b_a16e``) on the CPU against the JAX reference.

``moe_ffn`` runs on the reference's ``init_moe`` weights, carried across
by ``convert.lm_stacked``; the models run on the reference's
``Model(SMOKE).init(PRNGKey(0))`` carried across by ``convert.lm_params``
(2 layers, d 128, 8 query and 2 K/V heads of 16, d_ff 128, 4 experts:
DBRX top-2, Scout top-1 with a shared expert).  The same numpy inputs
go through both.

Tolerances:
- float32 ``moe_ffn``: the output within 1e-5 · max|out| (float32 sums
  in other orders), the aux loss within 1e-6 relative; at every capacity
  factor, the train factor, serving's 4.0, and 0.5, which drops pairs (a
  pair dropped by one side and not the other moves its token's output by
  O(max|out|));
- bf16 ``moe_ffn`` and bf16 logits: the reference's band
  (``tests/test_archs.py``: atol 0.08, rtol 0.05);
- float32 prefill logits, K/V caches and decode step 1: 1e-4 of the
  field's largest magnitude;
- decode against the port's own prefill(S + t): 1e-4 · max|logit|.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.models import moe as RMOE
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import Model, moe

ARCHS = ("dbrx_132b", "llama4_scout_17b_a16e")
BAND = dict(atol=0.08, rtol=0.05)
B, S = 2, 30


@functools.lru_cache(maxsize=None)
def _ref(arch, dtype="float32"):
    cfg = ref_configs.get_smoke(arch).replace(dtype=dtype)
    model = RefModel(cfg)
    return cfg, model, jax.jit(model.init)(jax.random.PRNGKey(0))


def _port(arch, dtype="float32"):
    _, _, rp = _ref(arch, dtype)
    model = Model(configs.get_smoke(arch).replace(dtype=dtype), device="cpu")
    return model, convert.lm_params(rp, device="cpu")


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n))


def _close(got: torch.Tensor, want, f32: bool, what: str, tol=1e-4):
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, what
    if f32:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, **BAND, err_msg=what)


def test_configs_match_reference():
    for arch in ARCHS:
        assert arch in configs.PORTED
        for name in [arch] + [k for k, v in configs.ALIASES.items() if v == arch]:
            for get, ref_get in ((configs.get, ref_configs.get),
                                 (configs.get_smoke, ref_configs.get_smoke)):
                assert dataclasses.asdict(get(name)) == dataclasses.asdict(ref_get(name))
    dbrx, scout = configs.get("dbrx_132b"), configs.get("llama4_scout_17b_a16e")
    assert (dbrx.n_layers, dbrx.d_model, dbrx.n_heads, dbrx.kv_heads, dbrx.d_ff, dbrx.vocab,
            dbrx.n_experts, dbrx.top_k) == (40, 6144, 48, 8, 10752, 100352, 16, 4)
    assert (scout.n_layers, scout.d_model, scout.n_heads, scout.kv_heads, scout.d_ff,
            scout.n_experts, scout.top_k, scout.shared_expert) == \
        (48, 5120, 40, 8, 8192, 16, 1, True)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_is_the_references(arch):
    """The port's own ``Model.init`` gives the reference's layout: each
    layer's ``moe`` in place of ``mlp``, the same shapes and dtypes (the
    router float32 in a bf16 model)."""
    _, _, rp = _ref(arch, "bfloat16")
    carried = convert.lm_params(rp, device="cpu")
    ours = Model(configs.get_smoke(arch), device="cpu").init(torch.Generator().manual_seed(0))
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else (tuple(v.shape), v.dtype)
                        for k, v in t.items()}
    assert shapes(ours["layers"][1]) == shapes(carried["layers"][1])
    assert set(ours["layers"][0]) == {"ln1", "ln2", "attn", "moe"}
    assert ours["layers"][0]["moe"]["router"].dtype == torch.float32
    assert ("shared" in ours["layers"][0]["moe"]) == (arch == "llama4_scout_17b_a16e")


@pytest.mark.parametrize("cf", [None, 4.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, cf):
    """Output and aux at the train factor (None: the config's), serving's
    4.0, and 0.5, where pairs are dropped: the dropped pairs are the
    reference's own."""
    cfg, _, _ = _ref(arch)
    pcfg = configs.get_smoke(arch).replace(dtype="float32")
    p = RMOE.init_moe(jax.random.PRNGKey(3), cfg, jnp.float32)
    x = np.random.default_rng(0).standard_normal((3, 20, cfg.d_model)).astype(np.float32)
    want, want_aux = jax.jit(lambda p_, x_: RMOE.moe_ffn(p_, cfg, x_, cf))(p, jnp.asarray(x))
    tp = convert.lm_stacked({"moe": p}, "cpu")["moe"]
    got, aux = moe.moe_ffn(tp, pcfg, torch.from_numpy(x), cf)
    _close(got, want, True, "moe out", tol=1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    r = moe.route(tp, pcfg, torch.from_numpy(x).reshape(60, cfg.d_model), cf)
    assert r.capacity == min(max(int(np.ceil(60 * cfg.top_k / cfg.n_experts *
                                             (cf or cfg.capacity_factor))), 1), 60 * cfg.top_k)
    dropped = int((~r.keep).sum())
    assert (dropped > 0) == (cf == 0.5), dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_ties_route_as_the_reference(arch):
    """A zero router gives every expert the same probability: the tied
    experts are taken in index order, as ``jax.lax.top_k`` takes them, and
    the pairs past the capacity are dropped as the reference drops them."""
    cfg, _, _ = _ref(arch)
    pcfg = configs.get_smoke(arch).replace(dtype="float32")
    p = RMOE.init_moe(jax.random.PRNGKey(4), cfg, jnp.float32)
    p = {**p, "router": jnp.zeros_like(p["router"])}
    x = np.random.default_rng(5).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p_, x_: RMOE.moe_ffn(p_, cfg, x_))(p, jnp.asarray(x))
    tp = convert.lm_stacked({"moe": p}, "cpu")["moe"]
    got, _ = moe.moe_ffn(tp, pcfg, torch.from_numpy(x))
    _close(got, want, True, "moe out, tied router", tol=1e-5)
    r = moe.route(tp, pcfg, torch.from_numpy(x).reshape(32, cfg.d_model))
    assert torch.equal(r.expert, torch.arange(cfg.top_k).expand(32, -1))
    assert int(r.keep.sum()) == cfg.top_k * r.capacity


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_bf16_within_the_reference_band(arch):
    cfg, _, _ = _ref(arch, "bfloat16")
    pcfg = configs.get_smoke(arch)
    p = RMOE.init_moe(jax.random.PRNGKey(3), cfg, jnp.bfloat16)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 24, cfg.d_model)), jnp.bfloat16)
    want, _ = jax.jit(lambda p_, x_: RMOE.moe_ffn(p_, cfg, x_, 4.0))(p, x)
    tp = convert.lm_stacked({"moe": p}, "cpu")["moe"]
    got, _ = moe.moe_ffn(tp, pcfg, convert._tensor(x, "cpu"), 4.0)
    assert got.dtype == torch.bfloat16
    _close(got, want, False, "bf16 moe out")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_step_match_reference(arch, dtype):
    """Logits, every layer's K/V cache and kpos, then decode step 1, each
    block's FFN the MoE at capacity factor 4.0."""
    cfg, ref, rp = _ref(arch, dtype)
    model, params = _port(arch, dtype)
    f32 = dtype == "float32"
    tokens = _tokens(cfg, S)
    want, ref_cache = jax.jit(ref.prefill)(rp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert bool((got[:, cfg.vocab:] == -1e30).all())
    _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab], f32, "prefill logits")
    for i, lc in enumerate(cache["layers"]):
        rlc = jax.tree.map(lambda a: a[i], ref_cache["layers"])
        assert np.array_equal(lc["kpos"].numpy(), np.asarray(rlc["kpos"]))
        _close(lc["k"], rlc["k"], f32, f"layer {i} k")
        _close(lc["v"], rlc["v"], f32, f"layer {i} v")
    tok = torch.argmax(got, -1)
    want1, _ = jax.jit(ref.decode_step)(rp, ref_cache, jnp.asarray(tok.numpy(), jnp.int32))
    got1, _ = model.decode_step(params, cache, tok)
    _close(got1[:, :cfg.vocab], np.asarray(want1)[:, :cfg.vocab], f32, "decode step 1")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_longer_prefill(arch):
    """Float32, 8 greedy decode steps after a prompt of 30 with room for
    them: step t within 1e-4 · max|logit| of the port's own prefill(S +
    t)."""
    cfg, _, _ = _ref(arch)
    model, params = _port(arch)
    tokens = _tokens(cfg, S, seed=4)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, S + 8)
    ids = []
    for t in range(1, 9):
        ids.append(torch.argmax(logits, -1))
        logits, cache = model.decode_step(params, cache, ids[-1])
        longer = np.concatenate([tokens, torch.stack(ids, 1).numpy()], 1)
        want = model.prefill(params, {"tokens": torch.from_numpy(longer)})[0]
        _close(logits[:, :cfg.vocab], want[:, :cfg.vocab].numpy(), True,
               f"decode step {t} vs prefill(S + {t})")


def test_reference_batched_decode_drops_tokens():
    """The reference's fault that the port keeps (ROADMAP §3): at serving's
    factor 4.0 a decode step of B sequences has C = ⌈B·K/E·4⌉, 2 for
    Scout's 16 experts and top 1 at B = 8.  Eight copies of one token all
    pick one expert: from the third on they are dropped and get the
    shared expert alone, so a sequence's decode depends on the rest of its
    batch, where a step of one sequence keeps it.  The port gives the
    reference's outputs."""
    cfg = ref_configs.get_smoke("llama4_scout_17b_a16e").replace(dtype="float32",
                                                                  n_experts=16)
    pcfg = configs.get_smoke("llama4_scout_17b_a16e").replace(dtype="float32", n_experts=16)
    p = RMOE.init_moe(jax.random.PRNGKey(6), cfg, jnp.float32)
    row = np.random.default_rng(7).standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    x = np.repeat(row, 8, 0)                                           # (B 8, 1, D)
    step = jax.jit(lambda p_, x_: RMOE.moe_ffn(p_, cfg, x_, 4.0)[0])
    batched, alone = np.asarray(step(p, jnp.asarray(x))), np.asarray(step(p, jnp.asarray(row)))
    np.testing.assert_allclose(batched[:2], np.repeat(alone, 2, 0), rtol=1e-6, atol=1e-6)
    assert np.abs(batched[2:] - alone).max() > 0.1 * np.abs(alone).max()
    tp = convert.lm_stacked({"moe": p}, "cpu")["moe"]
    got, _ = moe.moe_ffn(tp, pcfg, torch.from_numpy(x), 4.0)
    _close(got, batched, True, "port, batched decode", tol=1e-5)
    assert moe.capacity(configs.get("llama4_scout_17b_a16e"), 8, 4.0) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_training_the_moe_block_raises(arch):
    """The MoE block's training loss is ported now
    (``tests/test_torch_moe_train.py`` holds it against the reference): it
    is finite, carries every layer's aux loss, and differentiates to
    every leaf, the router's among them."""
    model, params = _port(arch)
    for leaf in [t for lp in params["layers"] for t in lp["moe"].values()
                 if isinstance(t, torch.Tensor)]:
        leaf.requires_grad_()
    loss, m = model.loss(params, {"tokens": torch.from_numpy(_tokens(model.cfg, 8))})
    assert bool(torch.isfinite(loss)) and float(m["aux"].detach()) > 0
    router = params["layers"][0]["moe"]["router"]
    (g,) = torch.autograd.grad(loss, [router])
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    seqs = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "24",
                       "--decode-tokens", "5"])
    assert seqs.shape == (2, 6) and ((0 <= seqs) & (seqs < 512)).all()
    out = capsys.readouterr().out
    assert f"{configs.get(arch).name} on cpu" in out and "prefill" in out and "tok/s" in out
