"""The port's LM training path (``tinyllama_1_1b`` SMOKE, float32 unless
stated) on the CPU against the JAX reference.

The reference's ``Model.init(PRNGKey(0))`` is carried across by
``convert.lm_params`` / ``convert.lm_stacked``; the same numpy batches
go through both.  On the CPU the port's training attention is the plain
forward (``ref.block_attn_fwd``) and the port of the reference's custom
VJP (``ref.block_attn_bwd``); the compressor's sketches are the plain
float64 ``index_add_``.

Tolerances (float32 sums in other orders; measured ~1.5e-7 and ~3e-6):
- ``Model.loss`` (loss, ce, tokens): 1e-5 relative;
- gradients and compressed gradients: 1e-4 · max|g| of each leaf;
- ``block_attn_bwd``: 1e-4 · max|grad| of each of dq, dk, dv;
- AdamW and the schedule (same arithmetic in the same order): 2e-6
  relative for the moments and float32 parameters (plus 2e-6 · lr for a
  parameter near 0: a last-bit difference in the update), 1e-12 for the
  rate;
  bf16 parameters within one bf16 ulp (a last-bit difference in float32
  may flip a rounding);
- two train steps: loss and grad norm 1e-5 relative, the compressed
  gradients as above, and the updated parameters equal (AdamW's limits)
  to the reference's AdamW applied to the port's own state and compressed
  gradient.  Against the reference's own parameters they are within
  1e-4 · lr on all but 1e-3 of each leaf's elements, and within AdamW's
  bound, 2 · lr a step, everywhere: AdamW's first step is g/(|g| + 1e-8),
  so where the compressed g is a few 1e-8 (a bucket whose terms cancel)
  the gradients' 1e-6-relative agreement moves the step by up to 1 % of
  lr (about 15 of 65,536 elements a leaf at these defaults).
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import Model as RefModel
from repro.models.layers import _block_attn_vjp_bwd, _block_attn_vjp_fwd
from repro.optim import adamw as ref_adamw
from repro.optim.grad_compress import CountSketchCompressor as RefCompressor
from repro_torch import configs, convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import TokenPipeline
from repro_torch.kernels.flash_attention import attention_dense, attention_train
from repro_torch.kernels.flash_attention.ref import block_attn_bwd, block_attn_fwd
from repro_torch.launch import steps
from repro_torch.launch import train as T
from repro_torch.models import Model, layer_views
from repro_torch.optim import CountSketchCompressor, adamw
from repro_torch.runtime.fault import FaultInjector, StepWatchdog, run_with_retries
from repro_torch.tree import leaves, map_tree, paths

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama_1_1b"
B, S = 4, 40                       # S off the smoke config's chunks (q 32, kv 64)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ADAM_RTOL = 2e-6


def _ref(dtype="float32", remat=True):
    cfg = ref_configs.get_smoke(ARCH).replace(dtype=dtype, remat=remat)
    model = RefModel(cfg)
    return model, model.init(jax.random.PRNGKey(0))


def _port(dtype="float32", remat=True):
    return Model(configs.get_smoke(ARCH).replace(dtype=dtype, remat=remat), device="cpu")


def _tokens(seed=1, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _leaf_close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


def _port_grads(model, stacked, batch):
    for t in leaves(stacked):
        t.requires_grad_()
    loss, metrics = model.loss(layer_views(stacked), batch)
    return loss, metrics, torch.autograd.grad(loss, leaves(stacked))


# ------------------------------------------------------------------ loss --
@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_reference(masked):
    ref, rp = _ref()
    toks = _tokens()
    batch = {"tokens": toks}
    if masked:
        batch["loss_mask"] = (np.random.default_rng(2).random((B, S)) < 0.7).astype(np.float32)
    want, wm = jax.jit(ref.loss)(rp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, gm = _port().loss(convert.lm_params(rp, "cpu"),
                               {k: torch.from_numpy(v) for k, v in batch.items()})
    for g, w in ((got, want), (gm["ce"], wm["ce"]), (gm["tokens"], wm["tokens"]),
                 (gm["aux"], wm["aux"])):
        assert abs(float(g) - float(w)) <= LOSS_RTOL * max(abs(float(w)), 1e-30), (g, w)


@pytest.mark.parametrize("remat", [True, False])
def test_gradients_match_reference(remat):
    ref, rp = _ref(remat=remat)
    toks = _tokens()
    want = jax.jit(jax.grad(lambda p, b: ref.loss(p, b)[0]))(rp, {"tokens": jnp.asarray(toks)})
    _, _, got = _port_grads(_port(remat=remat), convert.lm_stacked(rp, "cpu"),
                            {"tokens": torch.from_numpy(toks)})
    assert len(got) == len(jax.tree.leaves(want)) == 12
    for name, g, w in zip(paths(rp), got, jax.tree.leaves(want)):
        _leaf_close(g.numpy(), w, GRAD_RTOL, name)


def test_rwkv_loss_is_not_ported():
    """RWKV-6's loss is ported now (``tests/test_torch_rwkv_train.py`` holds
    it against the reference): it runs; a block kind the reference does not
    have raises."""
    model = Model(configs.get_smoke("rwkv6_1_6b"), device="cpu")
    loss, _ = model.loss(model.init(torch.Generator().manual_seed(0)),
                         {"tokens": torch.zeros(1, 8, dtype=torch.long)})
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="unknown block kind"):
        Model(configs.get_smoke("rwkv6_1_6b").replace(kind="retnet"), device="cpu")


# ------------------------------------------------------- attention bwd --
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_block_attn_bwd_matches_reference(G, causal):
    Bq, Sq, Kh, dh, qc, kc = 2, 45, 2, 16, 16, 32        # ragged: 45 = 2·16 + 13 = 32 + 13
    rng = np.random.default_rng(G + 2 * causal)
    q = rng.standard_normal((Bq, Sq, Kh * G, dh)).astype(np.float32)
    k, v = (rng.standard_normal((Bq, Sq, Kh, dh)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((Bq, Sq, Kh * G * dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (Bq, Sq))
    win = jnp.int32(1 << 30)
    out, res = _block_attn_vjp_fwd(*(jnp.asarray(x) for x in (q, k, v, pos, pos)), win, causal,
                                   qc, kc)
    want = _block_attn_vjp_bwd(causal, qc, kc, None, res, jnp.asarray(dout))[:3]
    t = [torch.from_numpy(np.array(x)) for x in (q, k, v, pos)]
    got_out, lse = block_attn_fwd(t[0], t[1], t[2], t[3], t[3], causal, None, qc, kc)
    _leaf_close(got_out.numpy(), out, GRAD_RTOL, "out")
    _leaf_close(lse.numpy(), res[-1], GRAD_RTOL, "lse")
    got = block_attn_bwd(t[0], t[1], t[2], got_out, lse, torch.from_numpy(dout), t[3], t[3],
                         causal, None, kc)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _leaf_close(g.numpy(), w, GRAD_RTOL, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_train_gradients_against_dense_float64(dtype):
    """The Function end to end (forward with its lse, then the backward)
    against autograd through a dense float64 softmax."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 37, 8, 16))).to(dtype).requires_grad_()
    k, v = (torch.from_numpy(rng.standard_normal((2, 37, 2, 16))).to(dtype).requires_grad_()
            for _ in range(2))
    dout = torch.from_numpy(rng.standard_normal((2, 37, 128))).to(dtype)
    got = torch.autograd.grad(attention_train(q, k, v, True, 16), (q, k, v), dout)
    qd, kd, vd = (x.detach().double().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(attention_dense(qd, kd, vd, True)[0], (qd, kd, vd),
                               dout.double())
    rtol = 1e-4 if dtype == torch.float32 else 3e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype
        _leaf_close(g.double().numpy(), w.numpy(), rtol, name)


# ---------------------------------------------------------------- adamw --
def test_schedule_matches_reference():
    cfg, rcfg = adamw.AdamWConfig(warmup_steps=5, total_steps=12), \
        ref_adamw.AdamWConfig(warmup_steps=5, total_steps=12)
    for step in range(0, 15):
        want = float(ref_adamw.schedule(rcfg, jnp.int32(step)))
        assert abs(adamw.schedule(cfg, step) - want) <= 1e-12 + 1e-7 * want, step


@pytest.mark.parametrize("dtype,master", [("float32", False), ("bfloat16", False),
                                          ("bfloat16", True)])
def test_adamw_matches_reference_over_three_steps(dtype, master):
    _, rp = _ref(dtype)
    ocfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6, master_fp32=master)
    rcfg = ref_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6, master_fp32=master)
    params, rparams = convert.lm_stacked(rp, "cpu"), rp
    state, rstate = adamw.init(ocfg, params), ref_adamw.init(rcfg, rp)
    rng = np.random.default_rng(7)
    for step in range(3):
        g = [rng.standard_normal(p.shape).astype(np.float32) * (3.0 if step == 1 else 0.01)
             for p in leaves(params)]
        params, state, stats = adamw.apply(ocfg, params, [torch.from_numpy(x) for x in g],
                                           state)
        rparams, rstate, rstats = ref_adamw.apply(rcfg, rparams, jax.tree.unflatten(
            jax.tree.structure(rparams), [jnp.asarray(x) for x in g]), rstate)
        assert int(state.step) == int(rstate.step) == step + 1
        assert abs(stats["lr"] - float(rstats["lr"])) <= 1e-12
        assert abs(float(stats["grad_norm"]) - float(rstats["grad_norm"])) <= ADAM_RTOL * float(
            rstats["grad_norm"])
        for name, a, b in zip(paths(params), leaves(state.m), jax.tree.leaves(rstate.m)):
            _leaf_close(a.numpy(), b, ADAM_RTOL, f"m {name}")
        for name, a, b in zip(paths(params), leaves(state.v), jax.tree.leaves(rstate.v)):
            _leaf_close(a.numpy(), b, ADAM_RTOL, f"v {name}")
        for name, a, b in zip(paths(params), leaves(params), jax.tree.leaves(rparams)):
            a, b = a.float().numpy(), np.asarray(b).astype(np.float32)
            if dtype == "float32":
                np.testing.assert_allclose(a, b, rtol=ADAM_RTOL, atol=ADAM_RTOL * stats["lr"],
                                           err_msg=name)
            else:                          # one bf16 ulp
                np.testing.assert_array_less(np.abs(a - b), 2.0 ** -7 * np.abs(b) + 1e-30,
                                             err_msg=name)


# ----------------------------------------------------------- compressor --
def _inject(port: CountSketchCompressor, seed=0):
    """The port compressor's hashes replaced by the reference's for the
    same (leaf, round)."""
    hasher = RefCompressor(ratio=port.ratio, seed=seed)

    def leaf_hash(i, n):
        hasher._round = port._round
        return convert.hash2(hasher._leaf_hash(i, n))
    port._leaf_hash = leaf_hash
    return port


@pytest.mark.parametrize("error_feedback", [True, False])
def test_compressor_matches_reference_over_three_rounds(error_feedback):
    shapes = {"a": (200,), "b": (4, 50), "c": (3, 7, 11), "tiny": (16,), "w": (2, 64, 33)}
    ref = RefCompressor(ratio=8, error_feedback=error_feedback)
    port = _inject(CountSketchCompressor(ratio=8, error_feedback=error_feedback))
    rng = np.random.default_rng(11)
    for _ in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        want = ref({k: jnp.asarray(v) for k, v in g.items()})
        got = port({k: torch.from_numpy(v.copy()) for k, v in g.items()})
        for k in shapes:
            _leaf_close(got[k].numpy(), want[k], GRAD_RTOL, k)
        np.testing.assert_array_equal(got["tiny"].numpy(), g["tiny"])
        if error_feedback:
            for i, k in enumerate(sorted(shapes)):
                _leaf_close(port._state[i].numpy(), ref._state[i], GRAD_RTOL, f"state {k}")
    assert port._round == ref._round == 3
    sample = {k: torch.zeros(s) for k, s in shapes.items()}
    assert port.compressed_bytes(sample) == ref.compressed_bytes(
        {k: jnp.zeros(s) for k, s in shapes.items()})


def test_compressor_sketch_sizes_are_the_references():
    port, ref = CountSketchCompressor(ratio=8), RefCompressor(ratio=8)
    for n in (32, 33, 45_056, 2_048, 11_534_336, 253_755_392):
        assert port.sketch_size(n) == ref._leaf_hash(0, n).k
    assert port.sketch_size(253_755_392) == 1 << 25


# ----------------------------------------------------------- train step --
def test_two_train_steps_match_reference():
    ref, rp = _ref()
    model = _port()
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

    rstep = ref_make_train_step(ref, rcfg, 2, compressor=rcompress)      # eager, not jitted
    pstep = steps.make_train_step(model, ocfg, 2, compressor=pcompress)
    rstate = ref_adamw.init(rcfg, rp)
    params = convert.lm_stacked(rp, "cpu")
    state = adamw.init(ocfg, params)
    treedef = jax.tree.structure(rp)
    for s in range(2):
        toks = _tokens(10 + s)
        before = convert.to_numpy((params, state))
        rp, rstate, rm = rstep(rp, rstate, {"tokens": jnp.asarray(toks)})
        params, state, pm = pstep(params, state, {"tokens": torch.from_numpy(toks)})
        for k in ("loss", "grad_norm"):
            assert abs(float(pm[k]) - float(rm[k])) <= LOSS_RTOL * abs(float(rm[k])), k
        assert pm["lr"] == float(rm["lr"])
        lr = pm["lr"]
        for name, gp, gr in zip(paths(params), rec_p[-1], jax.tree.leaves(rec_r[-1])):
            _leaf_close(gp.numpy(), gr, GRAD_RTOL, f"step {s} grad {name}")
        # the port's update is the reference's AdamW of the port's own state and gradient
        want, _, _ = ref_adamw.apply(rcfg, jax.tree.unflatten(treedef, leaves(before[0])),
                                     jax.tree.unflatten(treedef, [g.numpy() for g in rec_p[-1]]),
                                     ref_adamw.OptState(*before[1][:3], ()))
        for name, a, b, r in zip(paths(params), leaves(params), jax.tree.leaves(want),
                                 jax.tree.leaves(rp)):
            a, b, r = a.numpy(), np.asarray(b), np.asarray(r)
            np.testing.assert_allclose(a, b, rtol=ADAM_RTOL, atol=ADAM_RTOL * lr,
                                       err_msg=f"step {s} {name}")
            # and the reference's own step, but where AdamW's direction
            # g/(|g| + 1e-8) turns float noise in a small g into up to lr
            d = np.abs(a - r)
            assert (d <= 2 * lr * (s + 1)).all() and (d > 1e-4 * lr).mean() <= 1e-3, (s, name)


def test_split_micro_and_n_micro():
    batch = {"tokens": np.arange(24).reshape(8, 3)}
    parts = steps.split_micro(batch, 4)
    assert len(parts) == 4 and all(p["tokens"].shape == (2, 3) for p in parts)
    np.testing.assert_array_equal(np.concatenate([p["tokens"] for p in parts]), batch["tokens"])
    with pytest.raises(ValueError):
        steps.split_micro(batch, 3)
    assert steps.n_micro("tinyllama_1_1b", 256, 1) == 8
    assert steps.n_micro("tinyllama_1_1b", 8, 4) == 2


# ------------------------------------------------------------ data, ckpt --
def test_token_pipeline_batches_equal_reference():
    port = TokenPipeline(512, 8, 33, seed=3)
    ref = RefPipeline(512, 8, 33, seed=3)
    try:
        for _ in range(3):
            np.testing.assert_array_equal(next(port)["tokens"], next(ref)["tokens"])
        port.seek(7)
        ref.seek(7)
        np.testing.assert_array_equal(next(port)["tokens"], next(ref)["tokens"])
    finally:
        port.stop()
        ref.stop()
    assert not port._thread.is_alive()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    _, rp = _ref("bfloat16")
    rcfg = ref_adamw.AdamWConfig()
    rstate = ref_adamw.init(rcfg, rp)
    rstate = rstate._replace(step=jnp.int32(5), m=jax.tree.map(lambda x: x + 0.25, rstate.m))
    params = convert.lm_stacked(rp, "cpu")
    state = convert.opt_state(rstate, "cpu")
    d = str(tmp_path / "ck")
    if writer == "port":
        Checkpointer(d).save(5, (params, state))
        like = jax.tree.map(jnp.zeros_like, (rp, rstate))
        got_p, got_s = RefCheckpointer(d).restore(RefCheckpointer(d).latest_step(), like)
        for a, b in zip(jax.tree.leaves((got_p, got_s)), jax.tree.leaves((rp, rstate))):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                          np.asarray(b).reshape(-1).view(np.uint8))
    else:
        RefCheckpointer(d).save(5, (rp, rstate), blocking=True)
        like = (map_tree(torch.zeros_like, params), adamw.init(adamw.AdamWConfig(), params))
        ck = Checkpointer(d)
        got = ck.restore(ck.latest_step(), like)
        for a, b in zip(leaves(got), leaves((params, state))):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_checkpointer_async_keep_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": torch.ones(2).bfloat16()}
    for s in (1, 2, 3):
        ck.save(s, map_tree(lambda t: t * s, tree))
    ck.wait()
    assert ck.latest_step() == 3 and sorted(ck.all_steps()) == [2, 3]
    got = ck.restore(3, tree)
    assert torch.equal(got["w"], tree["w"] * 3) and got["b"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        ck.restore(3, {"w": tree["w"]})


# -------------------------------------------------------------- runtime --
def test_watchdog_retries_and_injector():
    seen = []
    wd = StepWatchdog(threshold=3.0, warmup=2, on_straggler=lambda s, dt, ema: seen.append(s))
    for step, dt in enumerate([1.0, 1.0, 1.1, 5.0, 1.0]):
        wd.observe(step, dt)
    assert wd.straggler_steps == [3] and seen == [3]
    inj = FaultInjector([1])
    calls = []

    def step_fn(state, batch):
        calls.append(batch)
        inj.maybe_fail(batch)
        return state + 1
    assert run_with_retries(step_fn, 0, 1) == 1 and calls == [1, 1]
    with pytest.raises(RuntimeError):
        run_with_retries(lambda s, b: (_ for _ in ()).throw(RuntimeError("x")), 0, 0, retries=1)


def _smoke_trainer():
    return T.build(T.parser().parse_args(["--device", "cpu", "--steps", "3",
                                          "--compress-grads", "8"]))


def _assert_same_state(a, b):
    assert a.compressor._round == b.compressor._round == 1
    for x, y in zip(leaves((a.params, a.opt_state.m, a.opt_state.v, a.compressor._state)),
                    leaves((b.params, b.opt_state.m, b.opt_state.v, b.compressor._state))):
        assert torch.equal(x, y)


def test_trainer_retries_a_failed_gradient_stage(monkeypatch):
    """A fault in the gradient stage (it changes no state) is retried, and
    the step ends as a step without the fault does."""
    clean, faulty = _smoke_trainer(), _smoke_trainer()
    try:
        clean.step(clean.next_batch())
        inj, calls, retried = FaultInjector([0]), [], []
        loss = faulty.model.loss

        def failing_loss(params, batch):
            calls.append(len(calls))
            inj.maybe_fail(calls[-1])
            return loss(params, batch)
        monkeypatch.setattr(faulty.model, "loss", failing_loss)
        faulty.step(faulty.next_batch(), on_failure=lambda a, e: retried.append(a))
        assert retried == [0]
        _assert_same_state(clean, faulty)
    finally:
        clean.pipe.stop()
        faulty.pipe.stop()


def test_trainer_does_not_retry_the_update(monkeypatch):
    """A fault after the compressor and AdamW have updated the state in
    place raises: the update is not run a second time, and the state is
    advanced once, as by a step without the fault."""
    clean, faulty = _smoke_trainer(), _smoke_trainer()
    try:
        clean.step(clean.next_batch())
        apply, calls = adamw.apply, []

        def failing_apply(*a, **kw):
            calls.append(1)
            apply(*a, **kw)
            raise RuntimeError("injected fault after the update")
        monkeypatch.setattr(adamw, "apply", failing_apply)
        with pytest.raises(RuntimeError, match="injected fault"):
            faulty.step(faulty.next_batch())
        assert calls == [1]
        _assert_same_state(clean, faulty)
    finally:
        clean.pipe.stop()
        faulty.pipe.stop()


# ------------------------------------------------------------------ CLI --
def _train(*args, tmp):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          capture_output=True, text=True, env=env, timeout=600)


def test_train_cli_runs_on_the_cpu_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    out = _train("--device", "cpu", "--steps", "3", "--compress-grads", "8", "--log-every", "1",
                 "--ckpt-dir", ck, tmp=tmp_path)
    assert out.returncode == 0, out.stderr
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 3 and all(np.isfinite(float(l.split('"loss": ')[1].split(",")[0]))
                                   for l in lines)
    assert Checkpointer(ck).latest_step() == 3
    out = _train("--device", "cpu", "--steps", "4", "--compress-grads", "8", "--resume",
                 "--ckpt-dir", ck, tmp=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "resumed from step 3" in out.stdout and '"step": 3' in out.stdout


def test_train_cli_resumes_bit_for_bit_from_an_intermediate_checkpoint(tmp_path):
    """A run resumed from the intermediate checkpoint of an uninterrupted one
    (4 steps, a save every 2) ends bit for bit where that run ends:
    parameters, AdamW's state and the compressor's round and error feedback,
    with the same losses on the way."""
    flags = ["--device", "cpu", "--steps", "4", "--ckpt-every", "2", "--compress-grads", "8",
             "--log-every", "1"]
    whole, part = tmp_path / "whole", tmp_path / "part"
    out = _train(*flags, "--ckpt-dir", str(whole), tmp=tmp_path)
    assert out.returncode == 0, out.stderr
    assert sorted(Checkpointer(str(whole)).all_steps()) == [2, 4]
    part.mkdir()
    shutil.copytree(whole / "step_2", part / "step_2")
    (part / "LATEST").write_text("2")
    resumed = _train(*flags, "--resume", "--ckpt-dir", str(part), tmp=tmp_path)
    assert resumed.returncode == 0, resumed.stderr
    assert "resumed from step 2" in resumed.stdout

    def logged(o):
        return [json.loads(l) for l in o.stdout.splitlines() if l.startswith("{")]
    assert [m["step"] for m in logged(resumed)] == [2, 3]
    assert logged(resumed) == logged(out)[2:]
    a, b = whole / "step_4", part / "step_4"
    manifest = json.loads((a / "manifest.json").read_text())
    assert manifest == json.loads((b / "manifest.json").read_text())
    assert ", 2.error.0, " in manifest["treedef"]                 # the compressor's state
    assert manifest["treedef"].endswith(", 2.round")
    rounds = np.load(a / f"leaf_{manifest['n_leaves'] - 1}.npy")
    assert int(rounds) == 4
    for i in range(manifest["n_leaves"]):
        x, y = np.load(a / f"leaf_{i}.npy"), np.load(b / f"leaf_{i}.npy")
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), i


def test_train_cli_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    out = _train("--steps", "1", "--ckpt-dir", str(tmp_path / "ck"), tmp=tmp_path)
    assert out.returncode != 0 and "torch.cuda.is_available() is False" in out.stderr
