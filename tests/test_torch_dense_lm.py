"""The port's dense LM (``tinyllama_1_1b``) on the CPU against the JAX reference.

The reference's ``Model(SMOKE).init(PRNGKey(0))`` (2 layers, d 128, 8
heads of 16, 1 K/V head) is carried across with ``convert.lm_params``;
the same numpy prompt then goes through both models' ``prefill`` and
``decode_step``.  On the CPU the port's prefill attention is the plain
version of the flash_attention kernel.

Tolerances:
- float32: logits and the cache's k and v within 1e-4 of the field's
  largest magnitude, kpos equal, the greedy tokens equal;
- bfloat16: the reference's own band (``tests/test_archs.py``: atol
  0.08, rtol 0.05), elementwise.

The reference's prefill cache holds exactly S slots and decode writes
position p at slot p mod S: the first decode step writes over position 0
after attending, so from the second step on decode attends without the
oldest positions.  ``test_reference_ring_cache_drops_oldest`` shows the
fault.  The port gives the cache room with ``max_len``
(``test_cache_room_matches_longer_prefill``), and decodes as the
reference does once the reference's cache is given the same room;
without room it takes the one step that is exact and then raises.
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
from repro_torch.models import Model

ARCH = "tinyllama_1_1b"
B, S = 2, 24
BAND = dict(atol=0.08, rtol=0.05)


def _ref(dtype="float32"):
    cfg = ref_configs.get_smoke(ARCH).replace(dtype=dtype, remat=False)
    model = RefModel(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(0))


def _port(ref_params, dtype="float32"):
    model = Model(configs.get_smoke(ARCH).replace(dtype=dtype, remat=False), device="cpu")
    return model, convert.lm_params(ref_params, device="cpu")


def _tokens(cfg, seed=1, n=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n))


def _close(got: torch.Tensor, want, f32: bool, what: str):
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, what
    if f32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, **BAND, err_msg=what)


def _last(model, params, toks) -> torch.Tensor:
    return model.prefill(params, {"tokens": torch.as_tensor(np.asarray(toks))})[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    cfg, ref, ref_params = _ref(dtype)
    model, params = _port(ref_params, dtype)
    f32 = dtype == "float32"
    tokens = _tokens(cfg)
    want, ref_cache = jax.jit(ref.prefill)(ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and got.shape == (B, cfg.padded_vocab)
    assert bool((got[:, cfg.vocab:] == -1e30).all())
    _close(got, want, f32, "prefill logits")
    assert torch.equal(cache["pos"], torch.full((B,), S, dtype=torch.int32))
    for i, lc in enumerate(cache["layers"]):
        for f in ("k", "v"):
            assert lc[f].dtype == getattr(torch, dtype)
            _close(lc[f], ref_cache["layers"][f][i], f32, f"layer {i} {f}")
        assert np.array_equal(lc["kpos"].numpy(), np.asarray(ref_cache["layers"]["kpos"][i]))

    toks = jnp.argmax(want, -1).astype(jnp.int32)
    if f32:
        assert torch.equal(torch.argmax(got, -1), torch.from_numpy(np.array(toks)).long())
    want, ref_cache = jax.jit(ref.decode_step)(ref_params, ref_cache, toks)
    got, cache = model.decode_step(params, cache, torch.from_numpy(np.array(toks)).long())
    _close(got, want, f32, "decode step logits")
    if f32:
        assert torch.equal(torch.argmax(got, -1), torch.from_numpy(np.array(jnp.argmax(want, -1))))
    for i, lc in enumerate(cache["layers"]):
        _close(lc["k"], ref_cache["layers"]["k"][i], f32, f"layer {i} k after decode")
        assert np.array_equal(lc["kpos"].numpy(), np.asarray(ref_cache["layers"]["kpos"][i]))


def _greedy(model, params, tokens, n, max_len=None):
    """Prefill, then n greedy decode steps; returns the decoded ids (B, n)
    and each step's logits."""
    logits, cache = model.prefill(params, {"tokens": torch.as_tensor(tokens)}, max_len)
    ids, steps = [], []
    for _ in range(n):
        tok = torch.argmax(logits, -1)
        ids.append(tok)
        logits, cache = model.decode_step(params, cache, tok)
        steps.append(logits)
    return torch.stack(ids, 1), steps


def reference_ring_diffs(steps: int = 4):
    """max |Δlogit| of the reference's decode steps 1..steps after
    prefill(S) against its own prefill(S + t), float32 SMOKE config."""
    cfg, ref, ref_params = _ref()
    tokens = _tokens(cfg)
    logits, cache = jax.jit(ref.prefill)(ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    dec = jax.jit(ref.decode_step)
    seq, diffs = jnp.asarray(tokens, jnp.int32), []
    for _ in range(steps):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = dec(ref_params, cache, tok)
        seq = jnp.concatenate([seq, tok[:, None]], 1)
        longer, _ = jax.jit(ref.prefill)(ref_params, {"tokens": seq})
        diffs.append(float(jnp.abs(logits - longer)[:, :cfg.vocab].max()))
    return diffs, float(jnp.abs(longer[:, :cfg.vocab]).max())


def test_reference_ring_cache_drops_oldest():
    """The reference itself: decode steps t ≥ 2 after prefill(S) are far
    from its own prefill(S + t), because steps 1..t − 1 wrote over
    positions 0..t − 2 of the S-slot cache (the first step is exact: it
    writes slot S mod S = 0 only after attending)."""
    diffs, top = reference_ring_diffs()
    assert diffs[0] < 1e-4 * top
    assert all(d > 0.1 for d in diffs[1:]), diffs


def test_cache_room_matches_longer_prefill():
    """With room for the decode tokens (max_len = S + 4), every decode
    step t = 1..4 stays within 1e-4·max|logit| of the port's own
    prefill(S + t) in float32."""
    cfg, _, ref_params = _ref()
    model, params = _port(ref_params)
    tokens = _tokens(cfg)
    ids, steps = _greedy(model, params, tokens, 4, max_len=S + 4)
    for t in range(1, 5):
        want = _last(model, params, np.concatenate([tokens, ids[:, :t].numpy()], 1))
        _close(steps[t - 1], want.numpy(), True, f"decode step {t} vs prefill(S + {t})")
    assert model.prefill(params, {"tokens": torch.from_numpy(tokens)}, S + 4)[1][
        "layers"][0]["k"].shape[1] == S + 4


def _ref_with_room(cache, room: int):
    """The reference's prefill cache with ``room`` empty slots appended
    (zero k and v, kpos −1), the layout the port's ``max_len`` gives."""
    lay = cache["layers"]
    pad = lambda a, fill: jnp.concatenate(
        [a, jnp.full(a.shape[:2] + (room,) + a.shape[3:], fill, a.dtype)], 2)
    return {**cache, "layers": {**lay, "k": pad(lay["k"], 0), "v": pad(lay["v"], 0),
                                "kpos": pad(lay["kpos"], -1)}}


def _ref_greedy(ref, ref_params, tokens, n, room=0):
    """The reference's prefill, then n greedy decode steps; returns each
    step's (input ids, logits)."""
    logits, cache = jax.jit(ref.prefill)(ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    if room:
        cache = _ref_with_room(cache, room)
    dec, steps = jax.jit(ref.decode_step), []
    for _ in range(n):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = dec(ref_params, cache, tok)
        steps.append((np.asarray(tok), logits))
    return steps


def test_port_with_room_equals_reference_with_room():
    """With max_len = S + 3, three greedy steps match the reference's own
    decode once its prefill cache has the same three empty slots."""
    cfg, ref, ref_params = _ref()
    model, params = _port(ref_params)
    tokens = _tokens(cfg, seed=3)
    ids, steps = _greedy(model, params, tokens, 3, max_len=S + 3)
    for t, (tok, logits) in enumerate(_ref_greedy(ref, ref_params, tokens, 3, room=3)):
        assert np.array_equal(tok, ids[:, t].numpy())
        _close(steps[t], logits, True, f"decode step {t + 1}")


def test_port_without_room_stops_before_wrapping():
    """max_len=None keeps the reference's S slots: the first step matches
    the reference's; the second, which would need position 0 that the
    first overwrote, raises instead of attending without it."""
    cfg, ref, ref_params = _ref()
    model, params = _port(ref_params)
    tokens = _tokens(cfg, seed=3)
    ids, steps = _greedy(model, params, tokens, 1)
    (tok, logits), = _ref_greedy(ref, ref_params, tokens, 1)
    assert np.array_equal(tok, ids[:, 0].numpy())
    _close(steps[0], logits, True, "decode step 1")
    with pytest.raises(ValueError, match="max_len"):
        _greedy(model, params, tokens, 2)
    cache = model.init_cache(B, 10)                       # full at position 10
    model.decode_step(params, cache, torch.zeros(B, dtype=torch.long))
    with pytest.raises(ValueError, match="holds 10"):
        model.decode_step(params, {**cache, "pos": cache["pos"] + 1},
                          torch.zeros(B, dtype=torch.long))


def test_init_and_lm_params_match_reference_layout():
    cfg = configs.get_smoke(ARCH)
    ours = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    ref = RefModel(ref_configs.get_smoke(ARCH)).init(jax.random.PRNGKey(0))
    carried = convert.lm_params(ref, device="cpu")
    flat = lambda layer: {(blk, k): (tuple(v.shape), v.dtype)
                          for blk in ("attn", "mlp") for k, v in layer[blk].items()}
    assert len(ours["layers"]) == len(carried["layers"]) == cfg.n_layers
    assert set(ours["layers"][0]) == set(carried["layers"][0]) == {"ln1", "ln2", "attn", "mlp"}
    assert flat(ours["layers"][0]) == flat(carried["layers"][0])
    want = np.asarray(ref["layers"]["attn"]["wq"][1]).view(np.int16)    # bf16 bit for bit
    assert np.array_equal(carried["layers"][1]["attn"]["wq"].view(torch.int16).numpy(), want)
    want = np.asarray(ref["layers"]["mlp"]["w_gate"][0]).view(np.int16)
    assert np.array_equal(carried["layers"][0]["mlp"]["w_gate"].view(torch.int16).numpy(), want)
    biased = RefModel(ref_configs.get_smoke(ARCH).replace(qkv_bias=True)).init(
        jax.random.PRNGKey(0))
    assert {"bq", "bk", "bv"} <= set(convert.lm_params(biased, device="cpu")["layers"][0]["attn"])


def test_init_cache_matches_reference():
    cfg = configs.get_smoke(ARCH)
    ours = Model(cfg, device="cpu").init_cache(2, 10)
    ref = RefModel(ref_configs.get_smoke(ARCH)).init_cache(2, 10)
    assert torch.equal(ours["pos"], torch.full((2,), 10, dtype=torch.int32))
    for i, lc in enumerate(ours["layers"]):
        assert lc["k"].shape == ref["layers"]["k"].shape[1:] and not lc["k"].any()
        assert np.array_equal(lc["kpos"].numpy(), np.asarray(ref["layers"]["kpos"][i]))


def test_config_matches_reference():
    for name in (ARCH, "tinyllama-1.1b"):
        for get, ref_get in ((configs.get, ref_configs.get),
                             (configs.get_smoke, ref_configs.get_smoke)):
            assert dataclasses.asdict(get(name)) == dataclasses.asdict(ref_get(name))
    full = configs.get(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.kv_heads, full.head_dim,
            full.d_ff, full.padded_vocab) == (22, 2048, 32, 4, 64, 5632, 32256)


def test_serve_cli_tinyllama_on_cpu(capsys):
    seqs = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "12",
                       "--decode-tokens", "3"])
    assert seqs.shape == (2, 4)
    assert ((0 <= seqs) & (seqs < 512)).all()
    out = capsys.readouterr().out
    assert "tinyllama-1.1b" in out and "prefill" in out and "tok/s" in out
