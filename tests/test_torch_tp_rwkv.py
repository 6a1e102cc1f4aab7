"""RWKV-6's heads over tp (``models/rwkv6.py`` on a tp rank of
``distributed/tp.py``) on gloo ranks on the CPU, against the JAX reference.

One spawn of a world of 4 ranks runs the meshes (1, 4) and (2, 2), each
rank joined with a timeout.  Config: the smoke RWKV-6 with
``rwkv_head_size=32`` (d 128: 4 heads, which tp 4 and tp 2 split; d_ff
256), float32, the reference's weights carried across by ``convert``.  On
each mesh at S = 32 (tp divides it: the residual stream
sequence-parallel) and on (1, 4) at S = 30 (the stream whole on every
rank); and at the default head size 64 (2 heads) on (1, 4) at S = 32,
where tp 4 divides no head count, so every rank computes every head of
the time mix (its projections gathered whole) and splits the channel
mix:

- the placed step's gradient stage (one microbatch of 4 rows): its loss
  within 1e-5 relative of the reference's ``ce`` and every gathered
  gradient leaf within 1e-4·max|g| of ``jax.value_and_grad(Model.loss)``
  (``ln_x``, ``cr``, ``w0``, ``u``, ``mu`` and ``wA`` among them, read
  whole or cut to the rank's heads: a missed or doubled sum over tp, or
  a per-rank ``ln_x``, shows there);
- every WKV call (``rwkv6_chunk``: the training forward and its remat
  recompute, the prefill) sees the rank's H/tp heads (all H where tp
  does not divide them);
- ``steps.placed_prefill`` of 4 × S tokens with room for 4 more, then 4
  ``placed_decode`` steps of the batch's next tokens: each step's logits
  within 1e-4·max|logit| of the reference's prefill(S + t); the cache's
  state holds the rank's heads and its ``x_last`` pair the rank's slice
  of D, as the rules place them;
- each rank's local shards: no rank holds a whole ``wr``, ``wk``, ``wv``,
  ``wg``, ``wo``, ``wB``, ``ck`` or ``cv``.

A dry-run smoke cell beside the spawn, in a subprocess a mesh: RWKV-6
train_4k (the smoke config at head size 32) on (1, 4) does at most 1.5×
the FLOPs a rank of (4, 1) (every rank of a tp group once computed every
head).

This module imports no JAX at module level: the spawned ranks import it.
"""
import datetime
import faulthandler
import json
import multiprocessing
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.distributed import sharding as S
from repro_torch.launch import steps
from repro_torch.models import Model, rwkv6
from repro_torch.optim import adamw
from repro_torch.tree import leaves, paths

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 240.0
ARCH, HEAD_SIZE, WHOLE = "rwkv6_1_6b", 32, 64   # WHOLE: 2 heads, which tp 4 does not divide
MESHES = ((1, 4), (2, 2))
B, SEQ, ODD, DECODE = 4, 32, 30, 4
LOSS_RTOL, GRAD_RTOL, LOGIT_RTOL = 1e-5, 1e-4, 1e-4
# (head size, mesh, S)
CASES = ([(HEAD_SIZE, MESHES[0], SEQ), (HEAD_SIZE, MESHES[1], SEQ), (HEAD_SIZE, MESHES[0], ODD)]
         + [(WHOLE, MESHES[0], SEQ)])
IDS = [f"hs{h}-{'x'.join(map(str, m))}-S{s}" for h, m, s in CASES]


def _cfg(hs=HEAD_SIZE, configs=configs):
    return configs.get_smoke(ARCH).replace(dtype="float32", rwkv_head_size=hs)


def _tokens(n):
    return np.random.default_rng(7).integers(0, _cfg().vocab, (B, n)).astype(np.int32)


def _case(params, hs, mesh, seq):
    """One case on this rank: its gradients, loss, the heads each WKV call
    saw, served logits, its cache's local shapes and its local shards'
    shapes."""
    model = Model(_cfg(hs), device="cpu")
    P = S.place(params, S.param_shardings(mesh, params))
    tok = torch.from_numpy(_tokens(seq + DECODE))
    batch = {"tokens": tok[:, :seq]}
    heads, real = [], rwkv6.rwkv6_chunk

    def seen(r, *a, **k):
        heads.append(r.shape[2])
        return real(r, *a, **k)
    rwkv6.rwkv6_chunk = seen
    try:
        g, loss = steps.make_train_step(model, adamw.AdamWConfig(), 1).grads(
            P, S.place(batch, S.batch_shardings(mesh, batch)))
        train_heads = list(heads)
        heads.clear()
        logits, cache = steps.placed_prefill(model, P, S.place(batch, S.batch_shardings(
            mesh, batch)), max_len=seq + DECODE)
    finally:
        rwkv6.rwkv6_chunk = real
    out = {"loss": float(loss), "grads": [t.clone() for t in leaves(S.gathered(g))],
           "local_shapes": {n: tuple(t.to_local().shape) for n, t in zip(paths(P), leaves(P))},
           "train_heads": train_heads, "prefill_heads": list(heads),
           "cache_shapes": {k: tuple(t.to_local().shape) for k, t in cache["layers"][0].items()}}
    served = [logits.full_tensor().clone()]
    for t in range(DECODE):
        nxt = {"t": tok[:, seq + t]}
        logits, cache = steps.placed_decode(model, P, cache,
                                            S.place(nxt, S.batch_shardings(mesh, nxt))["t"])
        served.append(logits.full_tensor().clone())
    out["served"] = served
    return out


def _rank_main(rank, world, rdv, out_dir, inbox):
    faulthandler.enable()               # a native crash prints each thread's stack
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        from torch.distributed.device_mesh import init_device_mesh

        meshes = {shape: init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
                  for shape in MESHES}
        spec = inbox.get(timeout=JOIN_TIMEOUT_S)      # the reference's weights by head size
        out = {"coord": {shape: tuple(m.get_coordinate()) for shape, m in meshes.items()}}
        for hs, shape, seq in CASES:
            out[(hs, shape, seq)] = _case(spec[hs], hs, meshes[shape], seq)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


DRY_TAGS = ("1x4", "4x1")   # the dry run's meshes, a subprocess each
_DRY = textwrap.dedent(f"""
    import json, sys
    from repro_torch import configs
    from repro_torch.launch import dryrun
    smoke = configs.get_smoke
    configs.get_smoke = lambda arch: smoke(arch).replace(rwkv_head_size={HEAD_SIZE})
    dryrun.fake_world(4)
    print("RESULT " + json.dumps(dryrun.run_cell("{ARCH}", "train_4k", sys.argv[1],
                                                 smoke=True)))
""")


def _reference(ref, rp, hs):
    """Per S the reference's ``ce``, its gradient and its prefill(S + t)
    logits for t = 0..DECODE, at head size ``hs``."""
    import jax
    import jax.numpy as jnp

    grad = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))
    prefill = jax.jit(ref.prefill)
    out = {}
    for seq in sorted({s for h, _, s in CASES if h == hs}):
        tok = _tokens(seq + DECODE)
        (_, m), g = grad(rp, {"tokens": jnp.asarray(tok[:, :seq])})
        out[seq] = {"ce": float(m["ce"]), "grads": [np.asarray(x) for x in jax.tree.leaves(g)],
                    "logits": [np.asarray(prefill(rp, {"tokens": jnp.asarray(tok[:, :seq + t])})[0])
                               for t in range(DECODE + 1)]}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of 4 ranks' records (the ranks start at once and take the
    reference's weights when they are made), the reference's computed
    meanwhile, and the dry-run cells'."""
    import jax

    from repro import configs as rconfigs
    from repro.models import Model as RefModel
    from repro_torch import convert

    tmp = tmp_path_factory.mktemp("tp_rwkv")
    dry = [subprocess.Popen([sys.executable, "-c", _DRY, tag], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
           for tag in DRY_TAGS]
    procs = []
    try:
        ctx = multiprocessing.get_context("spawn")
        inboxes = [ctx.Queue() for _ in range(4)]
        procs = [ctx.Process(target=_rank_main, args=(r, 4, str(tmp / "rdv"), str(tmp), box))
                 for r, box in enumerate(inboxes)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        refs = {hs: RefModel(_cfg(hs, rconfigs)) for hs in (HEAD_SIZE, WHOLE)}
        rps = {hs: ref.init(jax.random.PRNGKey(0)) for hs, ref in refs.items()}
        spec = {hs: convert.lm_stacked(rp, "cpu") for hs, rp in rps.items()}
        for box in inboxes:
            box.put(spec)
        want = {hs: _reference(refs[hs], rps[hs], hs) for hs in refs}
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        assert not hung, f"{len(hung)} rank(s) did not finish within {JOIN_TIMEOUT_S}s"
        assert [p.exitcode for p in procs] == [0] * 4
        ranks = []
        for r in range(4):
            with open(tmp / f"rank{r}.pkl", "rb") as fh:
                ranks.append(pickle.load(fh))
        cells = {}
        for tag, proc in zip(DRY_TAGS, dry):
            stdout, stderr = proc.communicate(timeout=JOIN_TIMEOUT_S)
            assert proc.returncode == 0, stderr[-3000:]
            line = next(x for x in stdout.splitlines() if x.startswith("RESULT "))
            cells[tag] = json.loads(line[len("RESULT "):])
    finally:
        for proc in dry:
            proc.kill()
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return {"ref": want, "spec": spec, "ranks": ranks, "dry": cells}


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_placed_loss_and_gradients_match_reference(runs, case):
    want = runs["ref"][case[0]][case[2]]
    names = paths(runs["spec"][case[0]])
    for leaf in ("ln_x", "cr", "w0", "u", "wA", "mu", "mu_c"):
        assert f"layers.mix.{leaf}" in names
    for rank, res in enumerate(runs["ranks"]):
        got = res[case]
        assert abs(got["loss"] - want["ce"]) <= LOSS_RTOL * abs(want["ce"]), rank
        assert len(got["grads"]) == len(want["grads"])
        for name, a, b in zip(names, got["grads"], want["grads"]):
            _close(a.numpy(), b, GRAD_RTOL, f"rank {rank} {name}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wkv_runs_on_the_ranks_heads(runs, case):
    """Each layer's WKV forward, its remat recompute and the prefill's see
    the rank's H/tp heads (all H where tp does not divide them); the
    prefill's state holds them, its ``x_last`` pair the rank's D/tp
    columns."""
    (hs, shape, _), cfg = case, _cfg(case[0])
    H, L, tp = cfg.d_model // hs, cfg.n_layers, shape[1]
    n = H // tp if H % tp == 0 else H
    for res in runs["ranks"]:
        got = res[case]
        assert got["train_heads"] == [n] * (2 * L)
        assert got["prefill_heads"] == [n] * L
        rows = B // shape[0]
        assert got["cache_shapes"] == {"S": (rows, n, hs, hs),
                                       "x_last_tm": (rows, cfg.d_model // tp),
                                       "x_last_cm": (rows, cfg.d_model // tp)}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_placed_prefill_and_decode_match_reference(runs, case):
    want = runs["ref"][case[0]][case[2]]["logits"]
    for rank, res in enumerate(runs["ranks"]):
        for t, (got, ref) in enumerate(zip(res[case]["served"], want)):
            _close(got.numpy(), ref, LOGIT_RTOL, f"rank {rank} step {t}")


@pytest.mark.parametrize("shape", MESHES, ids=["x".join(map(str, m)) for m in MESHES])
def test_no_rank_holds_a_whole_split_projection(runs, shape):
    """The split projections are the rank's slices: its heads' columns of
    ``wr``, ``wk``, ``wv``, ``wg`` and ``wB``, their rows of ``wo``, its d_ff
    slice of ``ck`` and ``cv`` (an fsdp share beside, but for ``wB``, which
    the rules split over tp alone)."""
    cfg = _cfg()
    D, Fw, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    full = {f"layers.mix.{n}": (L, D, D) for n in ("wr", "wk", "wv", "wg", "wo")}
    full.update({"layers.mix.ck": (L, D, Fw), "layers.mix.cv": (L, Fw, D)})
    for res in runs["ranks"]:
        local = res[(HEAD_SIZE, shape, SEQ)]["local_shapes"]
        for name, whole in full.items():
            assert np.prod(local[name]) * shape[0] * shape[1] == np.prod(whole), (name,
                                                                                 local[name])
        assert local["layers.mix.wB"][-1] * shape[1] == D, local["layers.mix.wB"]


def test_dry_run_flops_a_rank_split_over_tp(runs):
    """RWKV-6 train_4k (smoke, 4 heads): (1, 4)'s FLOPs a rank within 1.5× of
    (4, 1)'s, where every rank of a tp group once computed every head."""
    one_by_four = runs["dry"]["1x4"]["cost_analysis"]["flops_per_device"]
    four_by_one = runs["dry"]["4x1"]["cost_analysis"]["flops_per_device"]
    assert one_by_four <= 1.5 * four_by_one, (one_by_four, four_by_one)
    assert runs["dry"]["1x4"]["collectives"]["reduce-scatter"]["count"] > 0
