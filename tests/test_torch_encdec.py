"""The port's encoder–decoder (``seamless_m4t_medium`` SMOKE, float32: 2
encoder and 2 decoder layers, d 128, 8 heads of 16, d_ff 256, GELU, vocab
512, kv chunk 64) and the flash_attention call it adds, Sk ≠ S on a
non-causal call (cross-attention), on the CPU against the JAX reference.

The reference's ``Model.init(PRNGKey(0))`` is carried across by
``convert.lm_stacked``; the same numpy batches (``src_frames`` of 37
frames, 29 target tokens: neither a multiple of the chunks) go through
both.  One compressed train step against the reference's is in
``tests/test_torch_encdec_train_step.py``.  On the CPU the port's
attention is the plain blockwise forward
(``ref.block_attn_fwd``) and the port of the reference's custom VJP
(``ref.block_attn_bwd``).

Tolerances (float32 sums in other orders):
- the GELU MLP: 1e-6 · max|out|;
- cross-attention (K3's plain path) and its dq, dk, dv against
  ``jax.vjp`` of the reference's ``_block_attn`` with ``kv``: 1e-4 ·
  max|·| of each (with one key, where dq and dk are 0 up to rounding, 1e-4 of
  the scale of ds·k, max|dv|·max|v|·max(|q|, |k|)/√dh); the float64 oracle ``ref.attention_limit`` holds the
  plain output within its float32 limit;
- ``Model.loss``: 1e-5 relative; every gradient leaf: 1e-4 · max|g|;
- prefill logits, ``enc_out``, the K/V caches by position, the cached
  cross K/V against the reference's projections of ``enc_out``, and decode
  step 1: 1e-4 of the field's largest magnitude;
- decode against the port's own prefill(S + t): 1e-4 · max|logit|;
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
from repro.models import layers as RL
from repro_torch import configs, convert
from repro_torch.kernels.flash_attention import (attention_limit, attention_train,
                                                 flash_attention_gqa)
from repro_torch.launch import serve
from repro_torch.launch import train as T
from repro_torch.models import Model, layer_views
from repro_torch.models import layers as L
from repro_torch.tree import leaves, paths

ARCH = "seamless_m4t_medium"
B, SE, S = 2, 37, 29
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


def _batch(seed=1, rows=B, n=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (rows, n)).astype(np.int32),
            "src_frames": (rng.standard_normal((rows, SE, 128)) * 0.02).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


def test_config_matches_reference_and_builds():
    for name in (ARCH, "seamless-m4t-medium"):
        for get, ref_get in ((configs.get, ref_configs.get),
                             (configs.get_smoke, ref_configs.get_smoke)):
            assert dataclasses.asdict(get(name)) == dataclasses.asdict(ref_get(name))
    full = configs.get(ARCH)
    assert (full.n_layers, full.enc_layers, full.d_model, full.n_heads, full.d_ff, full.vocab,
            full.padded_vocab, full.act, full.frontend) == \
        (12, 12, 1024, 16, 4096, 256206, 256512, "gelu", "frames")
    _, _, rp = _ref()
    ours = Model(configs.get_smoke(ARCH), device="cpu").init(torch.Generator().manual_seed(0))
    carried = convert.lm_params(rp, device="cpu")
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                        for k, v in t.items()}
    for part in ("layers", "enc_layers"):
        assert len(ours[part]) == len(carried[part]) == 2
        assert shapes(ours[part][1]) == shapes(carried[part][1])
    assert set(ours) == set(carried) == {"embed", "layers", "enc_layers", "enc_ln_f", "ln_f"}


def test_gelu_mlp_matches_reference():
    """The first ported config whose MLP is GELU: the port's tanh form is
    the reference's ``jax.nn.gelu`` default."""
    cfg, _, _ = _ref()
    p = RL.init_mlp(jax.random.PRNGKey(2), cfg, jnp.float32)
    x = np.random.default_rng(3).standard_normal((2, 9, cfg.d_model)).astype(np.float32) * 3
    want = jax.jit(lambda p_, x_: RL.mlp(p_, cfg, x_))(p, jnp.asarray(x))
    got = L.mlp(convert.lm_stacked({"m": p}, "cpu")["m"], configs.get_smoke(ARCH),
                torch.from_numpy(x))
    assert "w_gate" not in p
    _close(got.numpy(), want, 1e-6, "gelu mlp")


# ------------------------------------------------------------------ K3 --
K3_CASES = [  # (Sq, Sk, Kh, G, kv_chunk): Sk < Sq, Sk > Sq, Sk = 1, Sq = 1, G > 1, off the chunks
    (40, 70, 2, 1, 32), (70, 40, 2, 1, 32), (29, 1, 2, 3, 16), (1, 37, 1, 4, 16),
    (45, 130, 2, 3, 64), (64, 37, 4, 2, 64)]


@pytest.mark.parametrize("Sq,Sk,Kh,G,kc", K3_CASES)
def test_cross_attention_matches_reference_vjp(Sq, Sk, Kh, G, kc):
    """``flash_attention_gqa(..., causal=False)`` and ``attention_train``
    with k, v of Sk ≠ Sq rows against the reference's ``_block_attn`` with
    ``kv`` (positions 0..Sq−1 and 0..Sk−1, non-causal): output, dq, dk and
    dv; the output also within the float64 oracle's float32 limit."""
    dh, qc = 16, 16
    rng = np.random.default_rng(Sq + 3 * Sk + G)
    q = rng.standard_normal((B, Sq, Kh * G, dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, Kh, dh)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((B, Sq, Kh * G * dh)).astype(np.float32)
    qp = jnp.broadcast_to(jnp.arange(Sq, dtype=jnp.int32), (B, Sq))
    kp = jnp.broadcast_to(jnp.arange(Sk, dtype=jnp.int32), (B, Sk))
    out, vjp = jax.vjp(lambda q_, k_, v_: RL._block_attn(q_, k_, v_, qp, kp, False, None, qc, kc),
                       *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plain = flash_attention_gqa(tq, tk, tv, causal=False)
    _close(plain.numpy(), out, GRAD_RTOL, "forward")
    oracle, lim = attention_limit(tq, tk, tv, causal=False)
    assert bool(((plain.double() - oracle).abs() <= lim).all())
    o2, lse = flash_attention_gqa(tq, tk, tv, causal=False, return_lse=True)
    assert torch.equal(o2, plain) and tuple(lse.shape) == (B, Kh * G, Sq)
    tq, tk, tv = (x.clone().requires_grad_() for x in (tq, tk, tv))
    got_out = attention_train(tq, tk, tv, False, kc)
    _close(got_out.detach().numpy(), out, GRAD_RTOL, "out")
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(dout))
    # with one key, dq and dk are 0 (p = 1 has no gradient), float32 residues
    # on both sides: held to 1e-4 of the scale of ds·k, max|dv|·max|v|·max(|q|,
    # |k|)/√dh
    floor = (np.abs(np.asarray(want[2])).max() * np.abs(v).max()
             * max(np.abs(q).max(), np.abs(k).max()) / np.sqrt(dh))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if Sk == 1 and name != "dv":
            assert np.abs(g.numpy() - np.asarray(w)).max() <= GRAD_RTOL * floor, name
            continue
        _close(g.numpy(), w, GRAD_RTOL, name)


def test_causal_or_windowed_call_with_other_key_count_raises():
    q = torch.zeros(1, 8, 4, 16)
    k = v = torch.zeros(1, 12, 2, 16)
    with pytest.raises(ValueError, match="causal call takes as many keys"):
        flash_attention_gqa(q, k, v, causal=True)
    with pytest.raises(ValueError, match="causal call takes as many keys"):
        flash_attention_gqa(q, k, v, causal=True, window=4)
    with pytest.raises(ValueError, match="needs a causal call"):
        flash_attention_gqa(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="causal call takes as many keys"):
        attention_train(q.requires_grad_(), k, v, True)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_gqa(q, k[:, :0], v[:, :0], causal=False)
    long = torch.zeros(1, 64 * 65536 + 1, 2, 16, device="meta")       # 65,537 key tiles of 64
    with pytest.raises(ValueError, match="ceil"):
        flash_attention_gqa(torch.zeros(1, 8, 4, 16, device="meta"), long, long, causal=False)


# ------------------------------------------------------------ the model --
def test_loss_and_every_gradient_leaf_match_reference():
    """Loss (the encoder over the frames, non-causal; each decoder block's
    cross-attention over its output) and the gradient of every leaf,
    ``enc_layers``' and ``xattn``'s among them, in the reference's leaf
    order."""
    _, ref, rp = _ref()
    batch = _batch()
    (want, wm), wg = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    model, _ = _port()
    stacked = convert.lm_stacked(rp, "cpu")
    for t in leaves(stacked):
        t.requires_grad_()
    loss, metrics = model.loss(layer_views(stacked), _torch(batch))
    got = torch.autograd.grad(loss, leaves(stacked))
    for g, w in ((loss.detach(), want), (metrics["ce"].detach(), wm["ce"])):
        assert abs(float(g) - float(w)) <= LOSS_RTOL * abs(float(w)), (g, w)
    names = paths(stacked)
    assert names == paths(rp) and len(got) == len(jax.tree.leaves(wg))
    assert names[:3] == ["embed.head", "embed.tok", "enc_layers.attn.wk"]
    assert {"enc_ln_f.scale", "layers.xattn.wq", "layers.ln_x.scale"} <= set(names)
    for name, g, w in zip(names, got, jax.tree.leaves(wg)):
        assert bool(torch.isfinite(g).all()), name
        _close(g.numpy(), w, GRAD_RTOL, name)


def test_prefill_cache_and_decode_step_match_reference():
    """Logits, ``enc_out``/``enc_pos``, every layer's K/V cache by position
    and its cached cross K/V (the reference projects ``enc_out`` anew each
    step), then decode step 1."""
    cfg, ref, rp = _ref()
    model, params = _port()
    batch = _batch(seed=4)
    want, rc = jax.jit(ref.prefill)(rp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, cache = model.prefill(params, _torch(batch))
    assert bool((got[:, cfg.vocab:] == -1e30).all())
    _close(got[:, :cfg.vocab].numpy(), np.asarray(want)[:, :cfg.vocab], 1e-4, "prefill logits")
    _close(cache["enc_out"].numpy(), rc["enc_out"], 1e-4, "enc_out")
    assert np.array_equal(cache["enc_pos"].numpy(), np.asarray(rc["enc_pos"]))
    for i, lc in enumerate(cache["layers"]):
        rlc = jax.tree.map(lambda a: a[i], rc["layers"])
        assert np.array_equal(lc["kpos"].numpy(), np.asarray(rlc["kpos"]))
        _close(lc["k"].numpy(), rlc["k"], 1e-4, f"layer {i} k")
        _close(lc["v"].numpy(), rlc["v"], 1e-4, f"layer {i} v")
        xp = jax.tree.map(lambda a: a[i], rp["layers"])["xattn"]
        for name, w in (("xk", xp["wk"]), ("xv", xp["wv"])):
            proj = np.asarray(rc["enc_out"] @ w).reshape(B, SE, cfg.kv_heads, cfg.head_dim)
            _close(lc[name].numpy(), proj, 1e-4, f"layer {i} {name}")
    tok = torch.argmax(got, -1)
    want1, _ = jax.jit(ref.decode_step)(rp, rc, jnp.asarray(tok.numpy(), jnp.int32))
    got1, c1 = model.decode_step(params, cache, tok)
    _close(got1[:, :cfg.vocab].numpy(), np.asarray(want1)[:, :cfg.vocab], 1e-4, "decode step 1")
    assert c1["enc_out"] is cache["enc_out"] and int(c1["pos"][0]) == S + 1


def test_decode_matches_longer_prefill():
    """8 greedy decode steps after a prompt of 29 tokens with room for them
    (the encoder's frames fixed): step t within 1e-4 · max|logit| of the
    port's own prefill(S + t)."""
    cfg, _, _ = _ref()
    model, params = _port()
    batch = _torch(_batch(seed=5))
    logits, cache = model.prefill(params, batch, S + 8)
    ids = []
    for t in range(1, 9):
        ids.append(torch.argmax(logits, -1))
        logits, cache = model.decode_step(params, cache, ids[-1])
        longer = {**batch, "tokens": torch.cat([batch["tokens"], torch.stack(ids, 1)], 1)}
        want = model.prefill(params, longer)[0]
        _close(logits[:, :cfg.vocab].numpy(), want[:, :cfg.vocab].numpy(), 1e-4,
               f"decode step {t} vs prefill(S + {t})")


def test_init_cache_has_the_references_layout():
    cfg, ref, _ = _ref()
    model, _ = _port()
    want = ref.init_cache(B, 12, src_len=SE)
    got = model.init_cache(B, 12, src_len=SE)
    assert tuple(got["enc_out"].shape) == want["enc_out"].shape
    assert tuple(got["enc_pos"].shape) == want["enc_pos"].shape
    assert np.array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    for i, lc in enumerate(got["layers"]):
        rlc = jax.tree.map(lambda a: a[i], want["layers"])
        assert tuple(lc["k"].shape) == rlc["k"].shape and not lc["k"].any()
        assert np.array_equal(np.sort(lc["kpos"].numpy(), 1), np.asarray(rlc["kpos"]))
        assert tuple(lc["xk"].shape) == (B, SE, cfg.kv_heads, cfg.head_dim)


# ---------------------------------------------------------------- CLIs --
def test_make_batch_for_is_the_references_stub():
    """``launch/train.make_batch_for``: the reference's tokens cut to S/2
    and ``src_frames`` (B, S/2, D) from the same rng."""
    from repro.data.synthetic import SyntheticLM as RefLM
    from repro.launch.train import make_batch_for as ref_make_batch
    from repro_torch.data.synthetic import SyntheticLM

    cfg = configs.get_smoke(ARCH)
    got = T.make_batch_for(cfg, SyntheticLM(cfg.vocab, seed=1), np.random.default_rng(3), 4, 30)
    want = ref_make_batch(ref_configs.get_smoke(ARCH), np.random.default_rng(3), 4, 30,
                          gen=RefLM(cfg.vocab, seed=1))
    assert set(got) == set(want) == {"tokens", "src_frames"}
    for k in got:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k


def test_serve_and_train_cli_on_cpu(tmp_path, capsys):
    seqs = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "30",
                       "--decode-tokens", "4"])
    assert seqs.shape == (2, 5) and ((0 <= seqs) & (seqs < 512)).all()
    out = capsys.readouterr().out
    assert "seamless-m4t-medium on cpu" in out and "tok/s" in out
    flags = ["--arch", ARCH, "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
             "--n-micro", "1", "--compress-grads", "8", "--log-every", "1", "--ckpt-dir",
             str(tmp_path)]
    params = T.main(flags)
    losses = [float(l.split('"loss": ')[1].split(",")[0])
              for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert (len(leaves(params["enc_layers"])), len(leaves(params["layers"]))) == (8, 13)
