"""The three dense configs that need no new block kind (``granite_3_8b``:
tied embeddings; ``qwen2_5_32b``: QKV bias, θ 1e6; ``llama3_405b``: θ
5e5) in the port, on the CPU against the JAX reference, as
``tests/test_torch_dense_lm.py`` does for TinyLlama.

The reference's ``Model(SMOKE).init(PRNGKey(0))`` is carried across with
``convert.lm_params``; Qwen's zero-initialised QKV biases are replaced
by random ones in both, so the bias is exercised.  The same numpy prompt
goes through both models' ``prefill``, ``decode_step`` and ``loss``.

Tolerances (float32): logits within 1e-4 of the largest |logit| with the
same greedy tokens; the loss within 1e-5 relative; gradients within
1e-4 · max|g| per leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import Model, layer_views
from repro_torch.tree import leaves, paths

ARCHS = ["granite_3_8b", "qwen2_5_32b", "llama3_405b"]
B, S = 2, 24
LOGIT_RTOL, LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-5, 1e-4


def _ref(arch, remat=False):
    cfg = ref_configs.get_smoke(arch).replace(dtype="float32", remat=remat)
    model = RefModel(cfg)
    params = model.init(jax.random.PRNGKey(0))
    if cfg.qkv_bias:                                # zero at init: make the bias count
        rng = np.random.default_rng(5)
        attn = params["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.standard_normal(attn[name].shape).astype(np.float32))
    return cfg, model, params


def _port(arch, remat=False):
    return Model(configs.get_smoke(arch).replace(dtype="float32", remat=remat), device="cpu")


def _close(got, want, what):
    got, want = got.detach().double().numpy(), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    name = ref_configs.get(arch).name
    for key in (arch, name):
        for get, ref_get in ((configs.get, ref_configs.get),
                             (configs.get_smoke, ref_configs.get_smoke)):
            assert dataclasses.asdict(get(key)) == dataclasses.asdict(ref_get(key))


def test_full_configs_published_numbers():
    g, q, l = (configs.get(a) for a in ARCHS)
    assert (g.n_layers, g.d_model, g.n_heads, g.kv_heads, g.head_dim, g.padded_vocab,
            g.tie_embeddings) == (40, 4096, 32, 8, 128, 49664, True)
    assert (q.n_layers, q.d_model, q.n_heads, q.kv_heads, q.head_dim, q.qkv_bias,
            q.rope_theta) == (64, 5120, 40, 8, 128, True, 1e6)
    assert (l.n_layers, l.d_model, l.n_heads, l.kv_heads, l.head_dim, l.rope_theta,
            l.n_heads // l.kv_heads) == (126, 16384, 128, 8, 128, 5e5, 16)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    cfg, ref, rp = _ref(arch)
    model, params = _port(arch), convert.lm_params(rp, device="cpu")
    if cfg.tie_embeddings:
        assert "head" not in params["embed"]
    if cfg.qkv_bias:
        assert {"bq", "bk", "bv"} <= set(params["layers"][0]["attn"])
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    want, ref_cache = jax.jit(ref.prefill)(rp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    _close(got, want, "prefill logits")
    assert bool((got[:, cfg.vocab:] == -1e30).all())
    toks = np.array(jnp.argmax(want, -1)).astype(np.int32)
    assert np.array_equal(torch.argmax(got, -1).numpy(), toks)
    want, _ = jax.jit(ref.decode_step)(rp, ref_cache, jnp.asarray(toks))
    got, _ = model.decode_step(params, cache, torch.from_numpy(toks).long())
    _close(got, want, "decode step logits")
    assert np.array_equal(torch.argmax(got, -1).numpy(), np.array(jnp.argmax(want, -1)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    _, ref, rp = _ref(arch, remat=True)
    toks = np.random.default_rng(2).integers(0, 512, (B, S)).astype(np.int32)
    (want, _), wg = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        rp, {"tokens": jnp.asarray(toks)})
    stacked = convert.lm_stacked(rp, "cpu")
    for t in leaves(stacked):
        t.requires_grad_()
    loss, _ = _port(arch, remat=True).loss(layer_views(stacked),
                                           {"tokens": torch.from_numpy(toks)})
    assert abs(float(loss.detach()) - float(want)) <= LOSS_RTOL * abs(float(want))
    got = torch.autograd.grad(loss, leaves(stacked))
    assert len(got) == len(jax.tree.leaves(wg))
    for name, g, w in zip(paths(rp), got, jax.tree.leaves(wg)):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    seqs = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "10",
                       "--decode-tokens", "3"])
    assert seqs.shape == (2, 4) and ((0 <= seqs) & (seqs < 512)).all()
    assert configs.get(arch).name in capsys.readouterr().out
