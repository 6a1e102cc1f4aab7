"""The port's Hymba (``kind="hybrid"``: windowed attention beside the SSM
branch, meta tokens) on the CPU against the JAX reference.

The reference's ``Model(SMOKE).init(PRNGKey(0))`` (2 layers, d 128, 4
query and 2 K/V heads of 32, window 64 on layer 1, layer 0 global, 8 meta
tokens, SSM state 4 and chunk 8) is carried across with
``convert.lm_params``; the same numpy prompts then go through both
models.  On the CPU the port's prefill attention is the plain version of
the flash_attention kernel, with the layer's window.

Tolerances:
- float32: logits and every cache field within 1e-4 of the field's
  largest magnitude (the SSM state 1e-4 too: the port's is unclipped
  where the reference's ``_ssm_final_state`` clips each decay to the end
  at exp(−60), a difference far below that), kpos equal;
- bfloat16: the reference's own band (``tests/test_archs.py``: atol
  0.08, rtol 0.05), elementwise;
- the plain windowed attention against the reference's ``_block_attn``
  (whose static band gathers only the kv blocks that meet it): float32
  2e-6 · max|v|, bf16 2⁻⁷ · max|v| (``tests/test_torch_flash_attention.py``'s);
- decode against the port's own prefill(S + t): 1e-4 · max|logit| in
  float32.

The port's cache lays position p at slot p mod span; the reference keeps
a windowed layer's last positions in order.  Caches are compared by
position (slots sorted by kpos).
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
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch import serve
from repro_torch.models import Model, layers as L

ARCH = "hymba_1_5b"
B = 2
BAND = dict(atol=0.08, rtol=0.05)
SHORT, LONG = 20, 90                 # prompts: with the 8 meta tokens 28 < 64 and 98 > 64


@functools.lru_cache(maxsize=None)
def _ref(dtype="float32"):
    cfg = ref_configs.get_smoke(ARCH).replace(dtype=dtype, remat=False)
    model = RefModel(cfg)
    return cfg, model, jax.jit(model.init)(jax.random.PRNGKey(0))


def _port(dtype="float32"):
    _, _, ref_params = _ref(dtype)
    model = Model(configs.get_smoke(ARCH).replace(dtype=dtype, remat=False), device="cpu")
    return model, convert.lm_params(ref_params, device="cpu")


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n))


def _close(got: torch.Tensor, want, f32: bool, what: str, tol=1e-4):
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, what
    if f32:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, **BAND, err_msg=what)


def _by_position(lc):
    """A port cache layer's k, v and kpos with the slots sorted by position."""
    order = torch.argsort(lc["kpos"].long(), dim=1)
    take = lambda t: torch.stack([t[b, order[b]] for b in range(t.shape[0])])
    return take(lc["k"]), take(lc["v"]), take(lc["kpos"])


def test_configs_and_windows_match_reference():
    for name in (ARCH, "hymba-1.5b"):
        for get, ref_get in ((configs.get, ref_configs.get),
                             (configs.get_smoke, ref_configs.get_smoke)):
            assert dataclasses.asdict(get(name)) == dataclasses.asdict(ref_get(name))
            windows = Model(get(name), device="cpu").windows
            assert [RL.GLOBAL_WINDOW if w is None else w for w in windows] == \
                list(RefModel(ref_get(name))._layer_windows())
    full = configs.get(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.kv_heads, full.head_dim,
            full.window, full.global_layers, full.meta_tokens) == \
        (32, 1600, 25, 5, 64, 1024, (0, 15, 31), 128)
    cut = Model(full.replace(n_layers=2, dtype="float32"), device="cpu")
    assert cut.windows == [None, 1024]     # globals past the depth ignored


def test_lm_params_carry_meta_ssm_and_branch_norms():
    """``convert.lm_params`` carries the reference's meta tokens and each
    layer's ``ssm``, ``bn_a`` and ``bn_s`` bit for bit (bf16), in the layout
    the port's own ``Model.init`` gives."""
    cfg, _, ref_params = _ref("bfloat16")
    carried = convert.lm_params(ref_params, device="cpu")
    ours = Model(configs.get_smoke(ARCH), device="cpu").init(torch.Generator().manual_seed(0))
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else (tuple(v.shape), v.dtype)
                        for k, v in t.items()}
    assert shapes(ours["layers"][1]) == shapes(carried["layers"][1])
    assert set(carried["layers"][0]) == {"ln1", "ln2", "attn", "mlp", "ssm", "bn_a", "bn_s"}
    assert shapes({"meta": ours["meta"]}) == shapes({"meta": carried["meta"]})
    bits = lambda t: t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    assert np.array_equal(bits(carried["meta"]), np.asarray(ref_params["meta"]).view(np.int16))
    for name in ("wx", "conv", "A_log", "Dskip"):
        want = np.asarray(ref_params["layers"]["ssm"][name][1])
        want = want.view(np.int16) if want.dtype.name == "bfloat16" else want
        assert np.array_equal(bits(carried["layers"][1]["ssm"][name]), want), name
    assert np.array_equal(bits(carried["layers"][1]["bn_a"]["scale"]),
                          np.asarray(ref_params["layers"]["bn_a"]["scale"][1]).view(np.int16))


@pytest.mark.parametrize("window", [1, 7, 16, 64, 100, 93])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_windowed_attention_matches_block_attn(dtype, window):
    """GQA (6 query heads over 2 K/V heads), S = 90 ragged against every
    chunk; windows from 1 to ≥ S: the wrapper's CPU route and its
    log-sum-exp against the reference's banded ``_block_attn_fwd``."""
    Bq, S, N, Kh, dh = 2, 90, 6, 2, 32
    rng = np.random.default_rng(window)
    q = rng.standard_normal((Bq, S, N, dh)).astype(np.float32)
    k, v = (rng.standard_normal((Bq, S, Kh, dh)).astype(np.float32) for _ in range(2))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    tq, tk, tv = (convert._tensor(x, "cpu") for x in (jq, jk, jv))
    pos = jnp.tile(jnp.arange(S, dtype=jnp.int32), (Bq, 1))
    want = RL._block_attn(jq, jk, jv, pos, pos, True, window, 32, 64)
    got = ops.flash_attention_gqa(tq, tk, tv, True, window=window)
    assert got.dtype == tdt
    tol = (2e-6 if dtype == "float32" else 2.0 ** -7) * np.abs(v).max()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=tol)
    _, want_lse = RL._block_attn_fwd(jq, jk, jv, pos, pos, True, jnp.int32(window), 32, 64,
                                     window if window < S else None)
    _, lse = ops.flash_attention_gqa(tq, tk, tv, True, return_lse=True, window=window)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(Bq, N, S), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(want_lse)).max()))


def test_window_refusals_and_full_width_on_cpu():
    q, k, v = (torch.randn(1, 40, 2, 16) for _ in range(3))
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention_gqa(q, k, v, False, window=8)
    with pytest.raises(ValueError, match="at least 1"):
        ops.flash_attention_gqa(q, k, v, True, window=0)
    causal = ops.flash_attention_gqa(q, k, v, True)
    assert torch.equal(causal, ops.flash_attention_gqa(q, k, v, True, window=1 << 29))
    w = {"wo": torch.eye(32)}
    qg = q.clone().requires_grad_(True)
    banded = L.attend(w, qg, k, v, window=8)                         # trainable, with its band
    assert banded.requires_grad
    assert torch.equal(banded.detach(), ops.flash_attention_gqa(q, k, v, True, window=8))
    (dq,) = torch.autograd.grad(banded.sum(), qg)
    assert bool(torch.isfinite(dq).all()) and bool(dq.abs().sum() > 0)
    assert L.attend(w, qg, k, v, window=1 << 30).requires_grad       # full width: trainable


@pytest.mark.parametrize("window", [None, 5, 64])
def test_decode_attention_window_matches_reference(window):
    rcfg = ref_configs.get_smoke(ARCH).replace(dtype="float32")
    cfg = configs.get_smoke(ARCH).replace(dtype="float32")
    D, N, Kh, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    rng = np.random.default_rng(21)
    w = {"wq": rng.standard_normal((D, N * dh)) / np.sqrt(D),
         "wk": rng.standard_normal((D, Kh * dh)) / np.sqrt(D),
         "wv": rng.standard_normal((D, Kh * dh)) / np.sqrt(D),
         "wo": rng.standard_normal((N * dh, D)) / np.sqrt(N * dh)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    Smax = 40
    x = rng.standard_normal((3, 1, D)).astype(np.float32)
    ck, cv = (rng.standard_normal((3, Smax, Kh, dh)).astype(np.float32) for _ in range(2))
    kpos = np.tile(np.arange(Smax, dtype=np.int32), (3, 1))
    kpos[:, 35:] = -1
    pos = np.array([35, 30, 9], np.int32)
    want = RL.decode_attention({k: jnp.asarray(v) for k, v in w.items()}, rcfg, jnp.asarray(x),
                               jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kpos),
                               jnp.asarray(pos), layer_window=window)
    got = L.decode_attention({k: torch.from_numpy(v) for k, v in w.items()}, cfg,
                             torch.from_numpy(x), torch.from_numpy(ck), torch.from_numpy(cv),
                             torch.from_numpy(kpos), torch.from_numpy(pos), layer_window=window)
    for g, wv, what in zip(got, want, ("out", "k", "v")):
        _close(g, wv, True, what, tol=1e-5)


@pytest.mark.parametrize("n", [SHORT, LONG])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_cache_and_decode_step_match_reference(dtype, n):
    """Logits and every layer's cache (k, v, kpos by position; the SSM's h
    and conv tail), at a prompt whose positions (with the meta tokens)
    fit the window and one they overrun; then decode step 1."""
    cfg, ref, ref_params = _ref(dtype)
    model, params = _port(dtype)
    f32 = dtype == "float32"
    tokens = _tokens(cfg, n)
    want, ref_cache = jax.jit(ref.prefill)(ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    S = n + cfg.meta_tokens
    assert got.dtype == torch.float32 and bool((got[:, cfg.vocab:] == -1e30).all())
    _close(got[:, :cfg.vocab], np.asarray(want)[:, :cfg.vocab], f32, "prefill logits")
    assert torch.equal(cache["pos"], torch.full((B,), S, dtype=torch.int32))
    for i, (lc, rlc) in enumerate(zip(cache["layers"], ref_cache["layers"])):
        k, v, kpos = _by_position(lc)
        assert np.array_equal(kpos.numpy(), np.asarray(rlc["kpos"])), i
        _close(k, rlc["k"], f32, f"layer {i} k")
        _close(v, rlc["v"], f32, f"layer {i} v")
        _close(lc["ssm"]["h"], rlc["ssm"]["h"], f32, f"layer {i} ssm h")
        _close(lc["ssm"]["conv"], rlc["ssm"]["conv"], f32, f"layer {i} ssm conv")
    assert cache["layers"][1]["k"].shape[1] == min(S, cfg.window)
    tok = torch.argmax(got, -1)
    want1, _ = jax.jit(ref.decode_step)(ref_params, ref_cache, jnp.asarray(tok.numpy(), jnp.int32))
    got1, _ = model.decode_step(params, cache, tok)
    _close(got1[:, :cfg.vocab], np.asarray(want1)[:, :cfg.vocab], f32, "decode step 1")


def _greedy(model, params, tokens, steps, max_len=None):
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, max_len)
    ids, outs = [], []
    for _ in range(steps):
        ids.append(torch.argmax(logits, -1))
        logits, cache = model.decode_step(params, cache, ids[-1])
        outs.append(logits)
    return torch.stack(ids, 1), outs, cache


def test_decode_matches_longer_prefill_with_the_window_biting():
    """Float32, a prompt of 60 tokens (68 positions with the meta tokens,
    past the window of 64) and room for 8 more: decode steps t = 1..8
    within 1e-4·max|logit| of the port's own prefill(S + t); the windowed
    layer's cache holds 64 slots, the global layer's 76.  Without room the
    second step raises."""
    cfg, _, _ = _ref()
    model, params = _port()
    tokens = _tokens(cfg, 60, seed=4)
    ids, steps, cache = _greedy(model, params, tokens, 8, max_len=68)
    assert [lc["k"].shape[1] for lc in cache["layers"]] == [76, 64]
    for t in range(1, 9):
        longer = np.concatenate([tokens, ids[:, :t].numpy()], 1)
        want = model.prefill(params, {"tokens": torch.from_numpy(longer)})[0]
        _close(steps[t - 1][:, :cfg.vocab], want[:, :cfg.vocab].numpy(), True,
               f"decode step {t} vs prefill(S + {t})")
    with pytest.raises(ValueError, match="max_len"):
        _greedy(model, params, tokens, 2)
    with pytest.raises(ValueError, match="max_len"):              # the windowed layer's too
        _greedy(model, params, _tokens(cfg, SHORT), 2)


def test_reference_windowed_cache_drops_in_window_positions():
    """The reference itself (ROADMAP §3): with its global layer given room,
    its second decode step after a prompt whose positions fit the window
    is far from its own prefill(S + 2): the windowed layer's shifting cache
    dropped position 0, which the window still covers.  The port's second
    step, with room, matches its prefill(S + 2)."""
    cfg, ref, ref_params = _ref()
    tokens = jnp.asarray(_tokens(cfg, SHORT), jnp.int32)
    logits, cache = jax.jit(ref.prefill)(ref_params, {"tokens": tokens})
    g = cache["layers"][0]
    room = 4
    cache["layers"][0] = {**g,
                          "k": jnp.concatenate([g["k"], jnp.zeros_like(g["k"][:, :room])], 1),
                          "v": jnp.concatenate([g["v"], jnp.zeros_like(g["v"][:, :room])], 1),
                          "kpos": jnp.concatenate([g["kpos"], -jnp.ones_like(g["kpos"][:, :room])],
                                                  1)}
    seq, dec = tokens, jax.jit(ref.decode_step)
    for _ in range(2):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = dec(ref_params, cache, tok)
        seq = jnp.concatenate([seq, tok[:, None]], 1)
    longer, _ = jax.jit(ref.prefill)(ref_params, {"tokens": seq})
    assert float(jnp.abs(logits - longer)[:, :cfg.vocab].max()) > 0.05
    model, params = _port()
    _, steps, _ = _greedy(model, params, np.array(tokens), 2, max_len=SHORT + 2)
    want = model.prefill(params, {"tokens": torch.from_numpy(np.asarray(seq))})[0]
    _close(steps[1][:, :cfg.vocab], want[:, :cfg.vocab].numpy(), True, "port step 2")


def test_init_cache_matches_reference():
    """``init_cache(B, max_len)`` counts token positions; the reference's
    counts every position, so it is held against the reference's at
    max_len + M: the same shapes and dtypes, the same positions held."""
    cfg = configs.get_smoke(ARCH)
    ours = Model(cfg, device="cpu").init_cache(B, 70)
    ref = RefModel(ref_configs.get_smoke(ARCH)).init_cache(B, 70 + cfg.meta_tokens)
    assert torch.equal(ours["pos"], torch.full((B,), 78, dtype=torch.int32))
    for lc, rlc in zip(ours["layers"], ref["layers"]):
        for f in ("k", "v"):
            assert tuple(lc[f].shape) == rlc[f].shape and not lc[f].any()
            assert str(lc[f].dtype).split(".")[-1] == rlc[f].dtype.name
        assert np.array_equal(np.sort(lc["kpos"].numpy(), 1), np.asarray(rlc["kpos"]))
        assert bool((lc["kpos"].long() % lc["k"].shape[1] ==
                     torch.arange(lc["k"].shape[1])).all())           # position p at slot p mod span
        for f in ("h", "conv"):
            assert tuple(lc["ssm"][f].shape) == rlc["ssm"][f].shape
            assert str(lc["ssm"][f].dtype).split(".")[-1] == rlc["ssm"][f].dtype.name


def test_training_a_hybrid_model_raises():
    """Hymba's loss is ported now (``tests/test_torch_hymba_train.py`` holds
    it and its gradients against the reference): it is finite; so is the
    MoE block's (``tests/test_torch_moe_train.py`` holds it), with its
    aux loss in it."""
    model, params = _port()
    loss, _ = model.loss(params, {"tokens": torch.zeros(B, 16, dtype=torch.long)})
    assert bool(torch.isfinite(loss))
    moe = Model(configs.get_smoke("dbrx_132b").replace(dtype="float32"), device="cpu")
    loss, m = moe.loss(moe.init(torch.Generator().manual_seed(0)),
                       {"tokens": torch.zeros(B, 16, dtype=torch.long)})
    assert bool(torch.isfinite(loss)) and float(m["aux"]) > 0


def test_serve_cli_on_cpu(capsys):
    seqs = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "70",
                       "--decode-tokens", "6"])
    assert seqs.shape == (2, 7)
    out = capsys.readouterr().out
    assert "hymba-1.5b on cpu" in out and "prefill" in out and "tok/s" in out
