"""The port's attention on the CPU against the JAX package.

The plain version of the flash_attention kernel (``kernels/flash_attention
/ref.py``, what the wrapper runs for CPU tensors) against the reference's
Pallas kernel in interpret mode, its dense oracle, its GQA wrapper and the
model's blockwise twin ``_block_attn``; then the ported layers (``rope``,
``mlp``, the prefill's attention with a QKV bias, ``decode_attention``)
against the reference's.  Inputs are numpy-seeded and go to both frameworks as the
same numbers.

Tolerances, with V = max|v| (or the largest magnitude of the compared
output):
- float32: 2e-6 · V for the attention (the two run the same float32
  recurrence over other blocks: measured ≤ 3e-7 · V), 1e-5 of the
  output's largest magnitude for the layers (float32 matmuls of other
  libraries);
- bfloat16: 2⁻⁷ · V — both round the output to bf16 (2⁻⁹ relative each)
  and the port rounds the probabilities to bf16 before P·V, as the model
  does, where the Pallas kernel keeps them in float32 (measured ≤ 0.0042 · V).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ops import flash_attention_gqa as jax_flash_gqa
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro import configs as ref_configs
from repro.models import layers as RL
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import Model, layers as L

F32_ATTN, F32_LAYER, BF16_ATTN = 2e-6, 1e-5, 2.0 ** -7


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


@pytest.mark.parametrize("S,dh,causal", [(128, 64, True), (256, 128, True),
                                         (128, 64, False), (96, 32, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(S, dh, causal, dtype):
    """The grid of tests/test_kernels.py: (BH, S, dh) heads as Kh = N = BH."""
    rng = np.random.default_rng(S + dh)
    BH = 3
    a = [rng.standard_normal((BH, S, dh)).astype(np.float32) for _ in range(3)]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq = [jnp.asarray(x, jdt) for x in a]
    kernel = jax_flash(*jq, causal=causal, q_block=64, kv_block=32)
    dense = jax_flash_ref(*[x.astype(jnp.float32) for x in jq], causal)
    tq = [_t(np.asarray(x, np.float32), getattr(torch, dtype)).transpose(0, 1)[None] for x in jq]
    got = ops.flash_attention_gqa(*tq, causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == (1, S, BH * dh)
    got = got.float().reshape(S, BH, dh).transpose(0, 1).numpy()
    tol = (F32_ATTN if dtype == "float32" else BF16_ATTN) * np.abs(a[2]).max()
    _close(got, kernel, tol, "vs Pallas kernel")
    _close(got, dense, tol, "vs dense oracle")


@pytest.mark.parametrize("B,S,N,Kh,dh", [(2, 128, 4, 2, 64), (2, 100, 4, 2, 64),
                                         (2, 128, 4, 2, 16)])
def test_plain_matches_gqa_wrapper_and_block_attn(B, S, N, Kh, dh):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, S, N, dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Kh, dh)).astype(np.float32) for _ in range(2))
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S)).astype(jnp.int32)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    got = ops.flash_attention_gqa(_t(q), _t(k), _t(v), True).numpy()
    tol = F32_ATTN * np.abs(v).max()
    _close(got, jax_flash_gqa(jq, jk, jv, causal=True, q_block=64, kv_block=64), tol, "gqa")
    _close(got, RL._block_attn(jq, jk, jv, pos, pos, True, None, 64, 64), tol, "_block_attn")


@pytest.mark.parametrize("window", [None, 16])
def test_block_attn_with_padding_and_window(window):
    """The port of ``_block_attn_fwd`` (the plain version's core) at
    padded positions (−1 queries, a key block past the end) against the
    reference's forward, output and log-sum-exp."""
    B, Sq, Sk, N, Kh, dh = 2, 40, 70, 4, 2, 16
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, Sq, N, dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, Kh, dh)).astype(np.float32) for _ in range(2))
    qp = np.tile(np.arange(30, 30 + Sq, dtype=np.int32), (B, 1))
    qp[1, -5:] = -1
    kp = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    jw = jnp.asarray(RL.GLOBAL_WINDOW if window is None else window, jnp.int32)
    want, want_lse = RL._block_attn_fwd(*(jnp.asarray(x) for x in (q, k, v, qp, kp)), True, jw,
                                        16, 32)
    got, lse = ref.block_attn_fwd(_t(q), _t(k), _t(v), torch.from_numpy(qp),
                                  torch.from_numpy(kp), True, window, 16, 32)
    _close(got.numpy(), want, F32_ATTN * np.abs(v).max(), "out")
    _close(lse.numpy(), want_lse, 1e-5 * float(np.abs(np.asarray(want_lse)).max()), "lse")


def test_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 8, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 24)).astype(np.int32)
    want = RL.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = L.rope(_t(x), torch.from_numpy(pos), 1e4)
    _close(got.numpy(), want, F32_LAYER * np.abs(np.asarray(want)).max())
    got16 = L.rope(_t(x, torch.bfloat16), torch.from_numpy(pos), 1e4)
    assert got16.dtype == torch.bfloat16                     # computed in f32, cast back


def _cfg(**kw):
    """The tinyllama SMOKE config (8 heads of 16, 1 K/V head) of both packages."""
    return (ref_configs.get_smoke("tinyllama_1_1b").replace(**kw),
            configs.get_smoke("tinyllama_1_1b").replace(**kw))


def _weights(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * (0.5 / np.sqrt(s[0]) if len(s) > 1 else 0.3))
            .astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    rcfg, cfg = _cfg(act=act)
    D, F = cfg.d_model, cfg.d_ff
    w = _weights({"w_up": (D, F), "w_down": (F, D), "w_gate": (D, F)}, 1)
    if act == "gelu":
        del w["w_gate"]
    x = np.random.default_rng(2).standard_normal((2, 10, D)).astype(np.float32)
    want = RL.mlp({k: jnp.asarray(v) for k, v in w.items()}, rcfg, jnp.asarray(x))
    got = L.mlp({k: _t(v) for k, v in w.items()}, cfg, _t(x))
    _close(got.numpy(), want, F32_LAYER * np.abs(np.asarray(want)).max(), act)


def _attn_weights(cfg, seed):
    D, N, Kh, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    return _weights({"wq": (D, N * dh), "wk": (D, Kh * dh), "wv": (D, Kh * dh),
                     "wo": (N * dh, D), "bq": (N * dh,), "bk": (Kh * dh,), "bv": (Kh * dh,)},
                    seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_with_qkv_bias_matches_reference(dtype):
    """The reference's ``attention`` (causal self-attention at positions
    0..S−1) against the model's route: ``attention_qkv``, then ``attend``
    (the kernel's wrapper)."""
    rcfg, cfg = _cfg(qkv_bias=True, dtype=dtype)
    w = _attn_weights(cfg, 3)
    B, S = 2, 50
    x = np.random.default_rng(5).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want = RL.attention({k: jnp.asarray(v, jdt) for k, v in w.items()}, rcfg,
                        jnp.asarray(x, jdt), jnp.asarray(pos))
    tw = {k: _t(v, tdt) for k, v in w.items()}
    got = L.attend(tw, *L.attention_qkv(tw, cfg, _t(x, tdt), torch.from_numpy(pos)))
    assert got.dtype == tdt
    mag = np.abs(np.asarray(want, np.float32)).max()
    if dtype == "float32":
        _close(got.numpy(), want, F32_LAYER * mag)
    else:            # the reference's bf16 band (tests/test_archs.py)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=0.08, rtol=0.05)


@pytest.mark.parametrize("bias", [True, False])
def test_decode_attention_matches_reference(bias):
    rcfg, cfg = _cfg(qkv_bias=bias)
    w = _attn_weights(cfg, 6)
    B, Smax, Kh, dh = 3, 20, cfg.kv_heads, cfg.head_dim
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, Smax, Kh, dh)).astype(np.float32) for _ in range(2))
    kpos = np.tile(np.arange(Smax, dtype=np.int32), (B, 1))
    kpos[:, 15:] = -1                                         # empty slots
    pos = np.array([15, 12, 9], np.int32)
    want = RL.decode_attention({k: jnp.asarray(v) for k, v in w.items()}, rcfg, jnp.asarray(x),
                               jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kpos),
                               jnp.asarray(pos))
    got = L.decode_attention({k: _t(v) for k, v in w.items()}, cfg, _t(x), _t(ck), _t(cv),
                             torch.from_numpy(kpos), torch.from_numpy(pos))
    for g, wv, what in zip(got, want, ("out", "k", "v")):
        _close(g.numpy(), wv, F32_LAYER * np.abs(np.asarray(wv)).max(), what)


def test_decode_attention_runs_in_float32_on_a_bf16_cache():
    """With a bf16 cache the decode step's attention rounds only its output
    (to bf16): against a float64 softmax over the same bf16 q, k and v it is
    within 2⁻⁸ of each output plus float32 sums (1e-6 · max|v|).  The
    reference's roundings of the scores, probabilities and unnormalised P·V
    (``repro.models.layers.decode_attention``) miss this."""
    _, cfg = _cfg(qkv_bias=True, dtype="bfloat16")
    B, Smax, N, Kh, dh = 3, 40, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    assert N * dh == cfg.d_model
    w = {k: _t(v, torch.bfloat16) for k, v in _attn_weights(cfg, 12).items()}
    w["wo"] = torch.eye(N * dh, dtype=torch.bfloat16)             # the attention's output itself
    rng = np.random.default_rng(13)
    x = _t(rng.standard_normal((B, 1, cfg.d_model)), torch.bfloat16)
    ck, cv = (_t(3 * rng.standard_normal((B, Smax, Kh, dh)), torch.bfloat16) for _ in range(2))
    kpos = torch.arange(Smax).repeat(B, 1)
    kpos[:, 30:] = -1
    pos = torch.tensor([30, 21, 9])
    got = L.decode_attention(w, cfg, x, ck, cv, kpos, pos)[0]
    q, k, v = L.attention_qkv(w, cfg, x, pos[:, None])
    keys = torch.cat([ck, k], 1).double()
    vals = torch.cat([cv, v], 1).double()
    valid = torch.cat([(kpos >= 0) & (kpos < pos[:, None]), torch.ones(B, 1, dtype=torch.bool)], 1)
    qg = q.double().reshape(B, Kh, N // Kh, dh)
    s = torch.einsum("bhgd,bshd->bhgs", qg, keys) / dh ** 0.5
    p = torch.softmax(s.masked_fill(~valid[:, None, None], -torch.inf), -1)
    want = torch.einsum("bhgs,bshd->bhgd", p, vals).reshape(B, 1, N * dh)
    err = (got.double() - want).abs()
    assert bool((err <= 2.0 ** -8 * want.abs() + 1e-6 * vals.abs().max()).all()), float(err.max())


def test_attention_routes():
    """The prefill's attention takes the kernel's wrapper (which has no
    route for a meta tensor); a windowed config is refused where the model
    is built, on every device, rather than run some other way."""
    _, cfg = _cfg()
    w = {k: _t(v) for k, v in _attn_weights(cfg, 8).items()}
    B, S, N, Kh, dh = 2, 8, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = torch.randn(B, S, N, dh, device="meta")
    k = v = torch.randn(B, S, Kh, dh, device="meta")
    with pytest.raises(RuntimeError, match="no route"):
        L.attend(w, q, k, v)
    with pytest.raises(NotImplementedError, match="item 7"):
        Model(cfg.replace(window=4, global_layers=(0,)), device="cpu")


@pytest.mark.parametrize("causal", [True, False])
def test_dense_oracle_spread_and_limit(causal):
    """``attention_dense`` also gives each row's ‖softmax‖₂ (1 for
    the first causal row, which sees one key), and ``attention_limit``
    holds bf16 to 2⁻⁷·(|o| + ‖p‖₂·max|v|) and float32 to 2e-5·max|v|."""
    B, S, N, Kh, dh = 2, 40, 4, 2, 16
    rng = np.random.default_rng(12)
    q = _t(rng.standard_normal((B, S, N, dh)))
    k, v = (_t(rng.standard_normal((B, S, Kh, dh))) for _ in range(2))
    want, norms = ref.attention_dense(q, k, v, causal)
    s = torch.einsum("bqnd,bknd->bnqk", q.double(), k.double().repeat_interleave(2, 2)) / 4.0
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -1e30)
    p = torch.softmax(s, -1)
    torch.testing.assert_close(norms, p.norm(dim=-1).permute(0, 2, 1), rtol=1e-12, atol=0)
    torch.testing.assert_close(want, torch.einsum("bnqk,bknd->bqnd", p, v.double()
                                                  .repeat_interleave(2, 2)).reshape(B, S, -1))
    if causal:
        assert torch.equal(norms[:, 0], torch.ones(B, N, dtype=torch.float64))
    vmax = float(v.abs().max())
    q16, k16, v16 = (x.bfloat16() for x in (q, k, v))
    bf, bnorms = ref.attention_dense(q16, k16, v16, causal)
    _, lim = ref.attention_limit(q16, k16, v16, causal)
    torch.testing.assert_close(lim, 2.0 ** -7 * (bf.abs() + bnorms.repeat_interleave(dh, -1)
                                                 * float(v16.abs().max())), rtol=1e-12, atol=0)
    _, lim32 = ref.attention_limit(q, k, v, causal)
    assert float(lim32) == 2e-5 * vmax


def test_wrapper_refuses_unsupported_shapes_on_cpu():
    q, k = torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match="dh"):
        ops.flash_attention_gqa(q, k, k)
    with pytest.raises(ValueError):
        ops.flash_attention_gqa(torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 2, 16),
                                torch.zeros(1, 8, 2, 16))
    with pytest.raises(TypeError):
        ops.flash_attention_gqa(*(torch.zeros(1, 8, 2, 16, dtype=torch.float16),) * 3)
    with pytest.raises(ValueError, match="65535"):
        ops.flash_attention_gqa(*(torch.zeros(65536, 1, 1, 16),) * 3)


def test_query_tile_is_per_dtype_and_bounds_the_grid_on_cpu():
    """The query tile that the wrapper checks the grid with is the kernel's
    for that dtype (128 rows in bf16, 64 in float32), so a shape refused
    on the card is refused here too; expanded operands cost no memory and
    ``_check`` runs before any arithmetic."""
    assert ref.KERNEL_TILE == {torch.float32: 64, torch.bfloat16: 128}

    def qkv(S, dtype):
        return [torch.zeros(1, 1, h, 16, dtype=dtype).expand(1, S, h, 16) for h in (2, 1, 1)]
    ops._check(*qkv(65535 * 64, torch.float32))
    with pytest.raises(ValueError, match=r"ceil\(S / 64\)"):
        ops._check(*qkv(65535 * 64 + 1, torch.float32))
    ops._check(*qkv(65535 * 64 + 1, torch.bfloat16))
    ops._check(*qkv(65535 * 128, torch.bfloat16))
    with pytest.raises(ValueError, match=r"ceil\(S / 128\)"):
        ops._check(*qkv(65535 * 128 + 1, torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_aligned_copies_only_what_the_kernel_cannot_read_in_place(dtype):
    """``_aligned`` hands the kernel an operand in place when its last
    dimension is contiguous, its base and strides are 16-byte multiples and
    no dimension longer than 1 has stride 0 (what the bf16 kernel's TMA
    tensor maps take); otherwise a contiguous copy with the same values."""
    B, S, N, Kh, dh = 2, 40, 4, 2, 16
    fused = torch.randn(B, S, N + 2 * Kh, dh).to(dtype)
    single = torch.randn(S * dh).to(dtype)
    in_place = [fused,
                fused[:, :, :N],                             # views of a fused projection
                fused[:, :, N:N + Kh],
                single.as_strided((1, S, 1, dh), (7, dh, 3, 1))]   # extent-1 dims: any stride
    copied = [fused.transpose(1, 3),                         # last dim not contiguous
              torch.randn(B, S, N, dh + 1).to(dtype)[..., 1:],   # base off 16 bytes
              torch.randn(B, S, N, dh + 2).to(dtype)[..., :dh],  # row strides off 16 bytes
              torch.randn(B, 1, N, dh).to(dtype).expand(B, S, N, dh)]   # stride 0
    for x in in_place:
        assert ops._aligned(x) is x
    for x in copied:
        y = ops._aligned(x)
        assert y is not x and y.is_contiguous() and torch.equal(y, x)
