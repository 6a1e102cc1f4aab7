"""The port's patch front end (``llava_next_34b`` SMOKE, float32: 2 layers,
d 128, 8 query and 2 K/V heads of 16, vocab 512) on the CPU against the
JAX reference: ``batch["patches"]`` (B, P, D) go before the tokens,
positions 0..P + S − 1, and the loss drops the P prefix positions.

The reference's ``Model.init(PRNGKey(0))`` is carried across by
``convert.lm_stacked``; the same numpy batches (19 patch embeddings, 23
tokens) go through both.

Tolerances (float32 sums in other orders):
- ``Model.loss``: 1e-5 relative; every gradient leaf: 1e-4 · max|g|;
- prefill logits, the K/V caches and decode step 1: 1e-4 of the field's
  largest magnitude;
- decode against the port's own prefill(S + t): 1e-4 · max|logit|.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import Model, layer_views
from repro_torch.tree import leaves, paths

ARCH = "llava_next_34b"
B, P, S = 2, 19, 23
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _ref():
    cfg = ref_configs.get_smoke(ARCH).replace(dtype="float32")
    model = RefModel(cfg)
    return cfg, model, jax.jit(model.init)(jax.random.PRNGKey(0))


def _port():
    _, _, rp = _ref()
    model = Model(configs.get_smoke(ARCH).replace(dtype="float32"), device="cpu")
    return model, convert.lm_params(rp, device="cpu")


def _batch(seed=1, n=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (B, n)).astype(np.int32),
            "patches": (rng.standard_normal((B, P, 128)) * 0.02).astype(np.float32)}


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


def test_config_matches_reference():
    for name in (ARCH, "llava-next-34b"):
        for get, ref_get in ((configs.get, ref_configs.get),
                             (configs.get_smoke, ref_configs.get_smoke)):
            assert dataclasses.asdict(get(name)) == dataclasses.asdict(ref_get(name))
    full = configs.get(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.kv_heads, full.head_dim, full.d_ff,
            full.vocab, full.rope_theta, full.frontend) == \
        (60, 7168, 56, 8, 128, 20480, 64000, 1e6, "patches")


def test_loss_and_every_gradient_leaf_match_reference():
    _, ref, rp = _ref()
    batch = _batch()
    (want, wm), wg = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    model, _ = _port()
    stacked = convert.lm_stacked(rp, "cpu")
    for t in leaves(stacked):
        t.requires_grad_()
    loss, metrics = model.loss(layer_views(stacked),
                               {k: torch.from_numpy(v) for k, v in batch.items()})
    got = torch.autograd.grad(loss, leaves(stacked))
    for g, w in ((loss.detach(), want), (metrics["ce"].detach(), wm["ce"]),
                 (metrics["tokens"], wm["tokens"])):
        assert abs(float(g) - float(w)) <= LOSS_RTOL * abs(float(w)), (g, w)
    assert float(metrics["tokens"]) == B * (S - 1)           # the patch positions dropped
    assert paths(stacked) == paths(rp) and len(got) == len(jax.tree.leaves(wg))
    for name, g, w in zip(paths(stacked), got, jax.tree.leaves(wg)):
        assert bool(torch.isfinite(g).all()), name
        _close(g.numpy(), w, GRAD_RTOL, name)


def test_prefill_cache_and_decode_step_match_reference():
    cfg, ref, rp = _ref()
    model, params = _port()
    batch = _batch(seed=4)
    want, rc = jax.jit(ref.prefill)(rp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, cache = model.prefill(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(cache["pos"][0]) == P + S
    _close(got[:, :cfg.vocab].numpy(), np.asarray(want)[:, :cfg.vocab], 1e-4, "prefill logits")
    for i, lc in enumerate(cache["layers"]):
        rlc = jax.tree.map(lambda a: a[i], rc["layers"])
        assert np.array_equal(lc["kpos"].numpy(), np.asarray(rlc["kpos"]))
        _close(lc["k"].numpy(), rlc["k"], 1e-4, f"layer {i} k")
        _close(lc["v"].numpy(), rlc["v"], 1e-4, f"layer {i} v")
    tok = torch.argmax(got, -1)
    want1, _ = jax.jit(ref.decode_step)(rp, rc, jnp.asarray(tok.numpy(), jnp.int32))
    got1, _ = model.decode_step(params, cache, tok)
    _close(got1[:, :cfg.vocab].numpy(), np.asarray(want1)[:, :cfg.vocab], 1e-4, "decode step 1")


def test_decode_matches_longer_prefill():
    """6 greedy decode steps after 19 patches and 23 tokens, the cache with
    room for them (``max_len`` counts tokens; the model adds the patches):
    step t within 1e-4 · max|logit| of the port's own prefill(S + t)."""
    cfg, _, _ = _ref()
    model, params = _port()
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=5).items()}
    logits, cache = model.prefill(params, batch, S + 6)
    assert cache["layers"][0]["k"].shape[1] == P + S + 6
    ids = []
    for t in range(1, 7):
        ids.append(torch.argmax(logits, -1))
        logits, cache = model.decode_step(params, cache, ids[-1])
        longer = {**batch, "tokens": torch.cat([batch["tokens"], torch.stack(ids, 1)], 1)}
        want = model.prefill(params, longer)[0]
        _close(logits[:, :cfg.vocab].numpy(), want[:, :cfg.vocab].numpy(), 1e-4,
               f"decode step {t} vs prefill(S + {t})")
    empty = model.init_cache(B, S + 6, patches=P)
    assert empty["layers"][0]["k"].shape[1] == P + S + 6 and int(empty["pos"][0]) == P + S + 6


def test_serve_cli_on_cpu(capsys):
    seqs = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "30",
                       "--decode-tokens", "4"])
    assert seqs.shape == (2, 5) and ((0 <= seqs) & (seqs < 512)).all()
    out = capsys.readouterr().out
    assert "llava-next-34b on cpu" in out and "tok/s" in out
