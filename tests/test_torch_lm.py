"""The port's RWKV-6 LM on the CPU against the JAX reference.

The reference's ``Model(SMOKE).init(PRNGKey(0))`` is carried across with
``convert.lm_params``; the same prompt (numpy ids) then goes through both
models' ``prefill`` and three ``decode_step``s, with the reference's WKV
in its Pallas kernel (interpret mode) and in ``rwkv_chunked``.

Tolerances:
- float32: logits and every cache field within 1e-4 of the field's
  largest magnitude, and the greedy tokens equal;
- bfloat16: logits and the cache's ``x_last`` within the reference's own
  bf16 band (``tests/test_archs.py``: atol 0.08, rtol 0.05), elementwise.
  The state S is a sum of outer products whose entries cancel, so it is
  held norm-wise: ‖ΔS‖ ≤ 0.05·‖S‖ for every (layer, batch, head).  The
  two frameworks round bfloat16 at different places (XLA keeps excess
  precision inside a fusion), so a k or v may differ by one bf16 ulp.
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
from repro_torch.models import Model, ModelConfig

B, S = 2, 24
BAND = dict(atol=0.08, rtol=0.05)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(reference cfg, its params, port model, its params) in one dtype."""
    cfg = ref_configs.get_smoke("rwkv6_1_6b").replace(dtype=request.param)
    ref_params = RefModel(cfg).init(jax.random.PRNGKey(0))
    model = Model(configs.get_smoke("rwkv6_1_6b").replace(dtype=request.param), device="cpu")
    return cfg, ref_params, model, convert.lm_params(ref_params, device="cpu")


def _close(got: torch.Tensor, want, f32: bool, what: str):
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, what
    if f32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, **BAND, err_msg=what)


def _state_close(got: torch.Tensor, want, f32: bool, what: str):
    got, want = got.numpy(), np.asarray(want)
    if f32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=what)
    else:
        diff = np.linalg.norm(got - want, axis=(-2, -1))
        assert np.all(diff <= 0.05 * np.linalg.norm(want, axis=(-2, -1))), (what, diff.max())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_reference(pair, use_pallas):
    cfg, ref_params, model, params = pair
    f32 = cfg.dtype == "float32"
    ref = RefModel(cfg.replace(use_pallas=use_pallas))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    want, ref_cache = ref.prefill(ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and got.shape == (B, cfg.padded_vocab)
    _close(got, want, f32, "prefill logits")
    assert torch.equal(cache["pos"], torch.full((B,), S, dtype=torch.int32))
    for i, lc in enumerate(cache["layers"]):
        _state_close(lc["S"], ref_cache["layers"]["S"][i], f32, f"layer {i} S")
        for f in ("x_last_tm", "x_last_cm"):
            assert lc[f].dtype == model.init_cache(1, 1)["layers"][0][f].dtype
            _close(lc[f], ref_cache["layers"][f][i], f32, f"layer {i} {f}")

    toks = jnp.argmax(want, -1).astype(jnp.int32)
    for step in range(3):
        if f32:
            assert torch.equal(torch.argmax(got, -1), torch.from_numpy(np.array(toks)).long())
        want, ref_cache = ref.decode_step(ref_params, ref_cache, toks)
        got, cache = model.decode_step(params, cache, torch.from_numpy(np.array(toks)).long())
        _close(got, want, f32, f"decode step {step} logits")
        toks = jnp.argmax(want, -1).astype(jnp.int32)
    assert torch.equal(cache["pos"], torch.full((B,), S + 3, dtype=torch.int32))
    for i, lc in enumerate(cache["layers"]):
        _state_close(lc["S"], ref_cache["layers"]["S"][i], f32, f"layer {i} S after decode")


def test_decode_after_prefill_matches_longer_prefill():
    """The reference's own oracle (tests/test_archs.py) on the port alone,
    bf16: decode_step after prefill(S) reproduces the last-position logits
    of prefill(S + 1) — what checks the terminal state the prefill harvests."""
    model = Model(configs.get_smoke("rwkv6_1_6b"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (B, S)))
    logits, cache = model.prefill(params, {"tokens": tokens})
    nxt = torch.argmax(logits, -1)
    got, _ = model.decode_step(params, cache, nxt)
    want, _ = model.prefill(params, {"tokens": torch.cat([tokens, nxt[:, None]], 1)})
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **BAND)


def test_init_matches_reference_layout():
    cfg = configs.get_smoke("rwkv6_1_6b")
    ours = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    ref = convert.lm_params(RefModel(ref_configs.get_smoke("rwkv6_1_6b"))
                            .init(jax.random.PRNGKey(0)), device="cpu")
    flat = lambda t: {k: (tuple(v.shape), v.dtype) for k, v in t["mix"].items()}
    assert len(ours["layers"]) == len(ref["layers"]) == cfg.n_layers
    assert flat(ours["layers"][0]) == flat(ref["layers"][0])
    for k in ("tok", "head"):
        assert ours["embed"][k].shape == ref["embed"][k].shape
        assert ours["embed"][k].dtype == ref["embed"][k].dtype == torch.bfloat16
    assert ours["layers"][0]["mix"]["u"].dtype == torch.float32     # u and w0 stay f32
    assert ours["layers"][0]["mix"]["w0"].dtype == torch.float32


def test_lm_params_carry_bf16_bits():
    ref = RefModel(ref_configs.get_smoke("rwkv6_1_6b")).init(jax.random.PRNGKey(0))
    ours = convert.lm_params(ref, device="cpu")
    want = np.asarray(ref["layers"]["mix"]["wk"][1]).view(np.int16)
    got = ours["layers"][1]["mix"]["wk"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), want)


def test_configs_match_reference():
    for name in ("rwkv6_1_6b", "rwkv6-1.6b"):
        for get, ref_get in ((configs.get, ref_configs.get),
                             (configs.get_smoke, ref_configs.get_smoke)):
            assert dataclasses.asdict(get(name)) == dataclasses.asdict(ref_get(name))
    full = configs.get("rwkv6_1_6b")
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab, full.ssm_chunk) == \
        (24, 2048, 7168, 65536, 16)
    assert configs.ALIASES == ref_configs.ALIASES
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(type(ref_configs.get("rwkv6_1_6b")))]
    for name in ("seamless_m4t_medium", "seamless-m4t-medium"):
        assert dataclasses.asdict(configs.get(name)) == \
            dataclasses.asdict(ref_configs.get(name))
    with pytest.raises(ValueError, match="unknown"):
        configs.get("not_an_arch")
    for bad in (full.replace(kind="mamba"), full.replace(frontend="video")):
        with pytest.raises(ValueError, match="unknown"):
            Model(bad, device="cpu")


def test_serve_cli_on_cpu(capsys):
    seqs = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "12",
                       "--decode-tokens", "3"])
    assert seqs.shape == (2, 4)
    assert ((0 <= seqs) & (seqs < 512)).all()
    out = capsys.readouterr().out
    assert "prefill" in out and "tok/s" in out
