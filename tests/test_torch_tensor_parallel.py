"""Tensor and sequence parallelism (``distributed/tp.py``) for the dense
LMs on gloo ranks on the CPU, against the JAX reference.

One spawn of a world of 4 ranks runs the meshes (1, 4) and (2, 2), each
rank joined with a timeout.  Configs: the smoke TinyLlama (8 heads, 1 K/V
head, d_ff 256, vocab 512: K/V whole, heads, d_ff and vocab split) and
the smoke Qwen (2 K/V heads, ``qkv_bias``), float32, the reference's
weights carried across by ``convert``.  For each, on each mesh:

- the placed step's gradient stage (``steps.make_train_step(...).grads``,
  one microbatch) on a 4 × 32 batch (tp divides S: the residual stream
  sequence-parallel): its loss within 1e-5 relative of the reference's
  ``ce`` and every gathered gradient leaf within 1e-4·max|g| of
  ``jax.value_and_grad(Model.loss)`` (the norm scales' and ``wk``/``wv``'s
  among them: a missed sum over tp shows there);
- ``steps.placed_prefill`` of 4 × 32 tokens with room for 4 more, then 4
  ``placed_decode`` steps of the batch's next tokens: each step's logits
  within 1e-4·max|logit| of the reference's prefill(S + t); the decode
  cache's slot writes on the owning rank only (the other ranks' slots
  bit-equal to theirs before the step).

TinyLlama on (1, 4) also trains and serves at S = 30, which tp 4 does
not divide (the stream whole, its gradient partial over tp), and Qwen's
smoke config cut to 6 heads (2 groups of 3) on (1, 4): tp 4 divides no
head count, so every rank computes every head and takes its sequence
slice of the output (``wq``, ``wo`` gathered; the MLP and vocab split).
Each rank records its local shards' shapes: no rank holds a whole
``wq``, ``wo``, ``w_gate``, ``w_up``, ``w_down`` or head.  The smoke
Hymba (a hybrid config) on (2, 2) holds its tensor-parallel path on a tp
axis of 2 (both branches on the rank's heads, the meta tokens in the
sequence-parallel stream, decode on the rank's slots and SSM heads)
against the port in one process on the same weights (the port's init
from seed 0), unplaced, with the same limits and checks (the port's
Hymba is held against the reference by ``tests/test_torch_hymba*.py``,
its tp path by ``tests/test_torch_tp_hybrid_encdec.py``).  A dry-run smoke cell beside the
spawn: TinyLlama train_4k on (1, 4) does at most 1.5× the FLOPs a rank of
(4, 1) (it did 4× before the blocks split over tp).  In this process:
``layers.local_kv`` gives each of a rank's query heads its GQA group's K/V
head, and every config on a mesh with a "model" axis of more than one
rank gets a tp context.

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
from repro_torch.distributed import tp as TP
from repro_torch.launch import steps
from repro_torch.models import Model, layer_views, stack_layers
from repro_torch.optim import adamw
from repro_torch.tree import leaves, paths

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 240.0
ARCHS = ("tinyllama_1_1b", "qwen2_5_32b")
SIX_HEADS = "qwen2_5_32b@6heads"    # 6 heads of 16 in 2 groups: tp 4 divides no head count
HYBRID = "hymba_1_5b"               # its tp path, held against the port in one process
MESHES = ((1, 4), (2, 2))
B, SEQ, ODD, DECODE = 4, 32, 30, 4
LOSS_RTOL, GRAD_RTOL, LOGIT_RTOL = 1e-5, 1e-4, 1e-4
# (arch, mesh, S): the cases each rank runs
CASES = ([(a, m, SEQ) for a in ARCHS for m in MESHES]
         + [("tinyllama_1_1b", (1, 4), ODD), (SIX_HEADS, (1, 4), SEQ), (HYBRID, (2, 2), SEQ)])


def _cfg(arch, configs=configs):
    """The smoke config in float32 (``SIX_HEADS``: Qwen's with 6 heads)."""
    cfg = configs.get_smoke(arch.split("@")[0]).replace(dtype="float32")
    return cfg.replace(n_heads=6, n_kv_heads=2, d_head=16) if arch == SIX_HEADS else cfg


def _tokens(arch, n):
    rng = np.random.default_rng(7)
    return rng.integers(0, _cfg(arch).vocab, (B, n)).astype(np.int32)


def _case(params, arch, mesh, seq):
    """One case on this rank: its gradients, loss, serve logits, the
    cache's slot writes and its local shards' shapes."""
    model = Model(_cfg(arch), device="cpu")
    P = S.place(params, S.param_shardings(mesh, params))
    tok = torch.from_numpy(_tokens(arch, seq + DECODE))
    batch = {"tokens": tok[:, :seq]}
    fn = steps.make_train_step(model, adamw.AdamWConfig(), 1)
    g, loss = fn.grads(P, S.place(batch, S.batch_shardings(mesh, batch)))
    out = {"loss": float(loss), "grads": [t.clone() for t in leaves(S.gathered(g))],
           "local_shapes": {n: tuple(t.to_local().shape) for n, t in zip(paths(P), leaves(P))}}
    logits, cache = steps.placed_prefill(model, P, S.place(batch, S.batch_shardings(mesh, batch)),
                                         max_len=seq + DECODE)
    served, writes = [logits.full_tensor().clone()], []
    for t in range(DECODE):
        nxt = {"t": tok[:, seq + t]}
        before = [lc["k"].to_local().clone() for lc in cache["layers"]]
        logits, cache = steps.placed_decode(model, P, cache,
                                            S.place(nxt, S.batch_shardings(mesh, nxt))["t"])
        served.append(logits.full_tensor().clone())
        k0 = cache["layers"][0]["k"]
        writes.append({"changed": [sorted(set(torch.nonzero((lc["k"].to_local() != b)
                                                             .any(-1).any(-1))[:, 1].tolist()))
                                   for lc, b in zip(cache["layers"], before)],
                       "span": k0.shape[1], "local": k0.to_local().shape[1],
                       "kpos": cache["layers"][0]["kpos"].to_local().clone()})
    out.update(served=served, writes=writes)
    return out


def _rank_main(rank, world, rdv, out_dir, spec):
    faulthandler.enable()               # a native crash prints each thread's stack
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        from torch.distributed.device_mesh import init_device_mesh

        meshes = {shape: init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
                  for shape in MESHES}
        out = {"coord": {shape: tuple(m.get_coordinate()) for shape, m in meshes.items()}}
        for arch, shape, seq in CASES:
            out[(arch, shape, seq)] = _case(spec[arch], arch, meshes[shape], seq)
        if rank == 0:                   # the hybrid case's reference, off the parent's path
            out["one_process"] = _one_process(HYBRID, spec[HYBRID])
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


_DRY = textwrap.dedent("""
    import json
    from repro_torch.launch import dryrun
    dryrun.fake_world(4)
    out = {tag: dryrun.run_cell("tinyllama_1_1b", "train_4k", tag, smoke=True)
           for tag in ("1x4", "4x1")}
    print("RESULT " + json.dumps(out))
""")


def _ref_model(arch):
    """The reference's model and weights."""
    import jax

    from repro import configs as rconfigs
    from repro.models import Model as RefModel

    ref = RefModel(_cfg(arch, rconfigs))
    return ref, ref.init(jax.random.PRNGKey(0))


def _reference(arch, ref, rp):
    """Per S the reference's ``ce``, its gradient and its prefill(S + t)
    logits for t = 0..DECODE."""
    import jax
    import jax.numpy as jnp

    out = {}
    for seq in sorted({s for a, _, s in CASES if a == arch}):
        tok = _tokens(arch, seq + DECODE)
        (_, m), g = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
            rp, {"tokens": jnp.asarray(tok[:, :seq])})
        prefill = jax.jit(ref.prefill)
        out[seq] = {"ce": float(m["ce"]),
                    "grads": [np.asarray(x) for x in jax.tree.leaves(g)],
                    "logits": [np.asarray(prefill(rp, {"tokens": jnp.asarray(tok[:, :seq + t])})[0])
                               for t in range(DECODE + 1)]}
    return out


def _one_process(arch, params):
    """The port in one process on the same weights, unplaced: at S =
    ``SEQ`` the loss's ``ce``, its gradient and prefill(S + t)'s logits,
    as :func:`_reference` gives the reference's (rank 0 runs it, after
    its cases)."""
    model = Model(_cfg(arch), device="cpu")
    tok = torch.from_numpy(_tokens(arch, SEQ + DECODE))
    g, loss = steps.make_train_step(model, adamw.AdamWConfig(), 1).grads(
        params, {"tokens": tok[:, :SEQ]})
    with torch.no_grad():
        logits = [model.prefill(layer_views(params), {"tokens": tok[:, :SEQ + t]})[0].numpy()
                  for t in range(DECODE + 1)]
    return {SEQ: {"ce": float(loss), "grads": [t.numpy() for t in leaves(g)], "logits": logits}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of 4 ranks' records, the reference's computed here
    meanwhile (each rank gets the weights first), and the dry-run cells'."""
    import jax  # noqa: F401  (the reference, in this process only)

    from repro_torch import convert

    tmp = tmp_path_factory.mktemp("tp")
    dry = subprocess.Popen([sys.executable, "-c", _DRY], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True,
                           env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    try:
        models = {arch: _ref_model(arch) for arch in (*ARCHS, SIX_HEADS)}
        spec = {arch: convert.lm_stacked(rp, "cpu") for arch, (_, rp) in models.items()}
        spec[HYBRID] = stack_layers(Model(_cfg(HYBRID), device="cpu").init(
            torch.Generator().manual_seed(0)))
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(r, 4, str(tmp / "rdv"), str(tmp), spec))
                 for r in range(4)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        ref = {arch: {**_reference(arch, *m), "params": spec[arch]} for arch, m in models.items()}
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        assert not hung, f"{len(hung)} rank(s) did not finish within {JOIN_TIMEOUT_S}s"
        assert [p.exitcode for p in procs] == [0] * 4
        ranks = []
        for r in range(4):
            with open(tmp / f"rank{r}.pkl", "rb") as fh:
                ranks.append(pickle.load(fh))
        stdout, stderr = dry.communicate(timeout=JOIN_TIMEOUT_S)
        assert dry.returncode == 0, stderr[-3000:]
        line = next(x for x in stdout.splitlines() if x.startswith("RESULT "))
    finally:
        dry.kill()
    ref[HYBRID] = {**ranks[0]["one_process"], "params": spec[HYBRID]}
    return {"ref": ref, "ranks": ranks, "dry": json.loads(line[len("RESULT "):])}


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


IDS = [f"{a}-{'x'.join(map(str, m))}-S{s}" for a, m, s in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_placed_loss_and_gradients_match_reference(runs, case):
    arch, _, seq = case
    want = runs["ref"][arch][seq]
    names = paths(runs["ref"][arch]["params"])
    for rank, res in enumerate(runs["ranks"]):
        got = res[case]
        assert abs(got["loss"] - want["ce"]) <= LOSS_RTOL * abs(want["ce"]), rank
        assert len(got["grads"]) == len(want["grads"])
        for name, a, b in zip(names, got["grads"], want["grads"]):
            _close(a.numpy(), b, GRAD_RTOL, f"rank {rank} {name}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_placed_prefill_and_decode_match_reference(runs, case):
    arch, _, seq = case
    want = runs["ref"][arch][seq]["logits"]
    for rank, res in enumerate(runs["ranks"]):
        for t, (got, ref) in enumerate(zip(res[case]["served"], want)):
            _close(got.numpy(), ref, LOGIT_RTOL, f"rank {rank} step {t}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decode_writes_the_new_slot_on_its_owner_only(runs, case):
    """Position p (the meta tokens counted) goes to slot p mod span, held
    by tp rank slot // (span / tp): that rank's local cache changes at
    that one slot every layer, the other ranks' not at all; where tp does
    not divide the span (S = 30) every rank holds every slot and writes
    it."""
    arch, shape, seq = case
    meta = _cfg(arch).meta_tokens
    for res in runs["ranks"]:
        tp_rank = res["coord"][shape][1]
        for t, w in enumerate(res[case]["writes"]):
            pos = meta + seq + t
            slot, n = pos % w["span"], w["local"]
            assert w["span"] == meta + seq + DECODE
            if w["span"] % shape[1]:                # tp does not divide it: whole on every rank
                assert n == w["span"]
                tp_rank = 0
            else:
                assert n * shape[1] == w["span"]
            mine = slot // n == tp_rank
            want = [slot - tp_rank * n] if mine else []
            assert all(c == want for c in w["changed"]), (t, tp_rank, w["changed"])
            if mine:
                assert bool((w["kpos"][:, slot - tp_rank * n] == pos).all())


@pytest.mark.parametrize("shape", MESHES, ids=["x".join(map(str, m)) for m in MESHES])
def test_no_rank_holds_a_whole_split_weight(runs, shape):
    """The dense weights that tp divides are the rank's slices: a quarter
    or a half of the heads, d_ff and vocab on (1, 4) and (2, 2)."""
    for arch in ARCHS:
        cfg = _cfg(arch)
        full = {"embed.tok": (cfg.padded_vocab, cfg.d_model),
                "layers.attn.wq": (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim),
                "layers.attn.wo": (cfg.n_layers, cfg.n_heads * cfg.head_dim, cfg.d_model),
                "layers.mlp.w_gate": (cfg.n_layers, cfg.d_model, cfg.d_ff),
                "layers.mlp.w_up": (cfg.n_layers, cfg.d_model, cfg.d_ff),
                "layers.mlp.w_down": (cfg.n_layers, cfg.d_ff, cfg.d_model)}
        if not cfg.tie_embeddings:
            full["embed.head"] = (cfg.d_model, cfg.padded_vocab)
        for res in runs["ranks"]:
            local = res[(arch, shape, SEQ)]["local_shapes"]
            for name, whole in full.items():
                assert np.prod(local[name]) * shape[0] * shape[1] == np.prod(whole), (name,
                                                                                     local[name])


def test_tp_context_is_dense_only(monkeypatch):
    """Every config gets a tp context on a mesh whose "model" axis has more
    than one rank (the MoE, RWKV, hybrid and encdec blocks' own tp paths:
    ``tests/test_torch_tp_moe.py``, ``tests/test_torch_tp_rwkv.py``,
    ``tests/test_torch_tp_hybrid_encdec.py``), their smoke configs too; a
    mesh without a "model" axis of more than one rank has no tp context."""
    from repro_torch.distributed.sharding import AbstractMesh

    class _Mesh(AbstractMesh):
        def get_group(self, dim):
            raise AssertionError("no group is needed to refuse")

    monkeypatch.setattr(TP, "axis", lambda mesh, dim: ("tp", dim))
    mesh1, mesh4 = _Mesh((4, 1), ("data", "model")), _Mesh((1, 4), ("data", "model"))
    for arch in ("dbrx_132b", "llama4_scout_17b_a16e", "hymba_1_5b", "seamless_m4t_medium",
                 "rwkv6_1_6b", "tinyllama_1_1b"):
        for cfg in (configs.get(arch), configs.get_smoke(arch)):
            assert TP.context(mesh1, cfg) is None
            assert TP.context(mesh4, cfg) == ("tp", 1), arch


def test_dry_run_flops_a_rank_split_over_tp(runs):
    """TinyLlama train_4k (smoke): (1, 4)'s FLOPs a rank within 1.5× of
    (4, 1)'s, where every rank of a tp group once computed the whole."""
    one_by_four = runs["dry"]["1x4"]["cost_analysis"]["flops_per_device"]
    four_by_one = runs["dry"]["4x1"]["cost_analysis"]["flops_per_device"]
    assert one_by_four <= 1.5 * four_by_one, (one_by_four, four_by_one)
    assert runs["dry"]["1x4"]["collectives"]["reduce-scatter"]["count"] > 0


@pytest.mark.parametrize("N,Kh,tp", [(8, 1, 4), (8, 2, 2), (32, 4, 16), (12, 3, 2)],
                         ids=["groups-in-one-head", "whole-groups", "tinyllama-tp16", "irregular"])
def test_local_kv_gives_each_local_head_its_group(N, Kh, tp):
    """``layers.local_kv``: the K/V heads a rank's query heads read, each
    query head j of the rank's N/tp reading K/V head (head0 + j) // G, as
    the kernel's GQA grouping of the selection gives it (12 heads in groups
    of 4 over tp 2: no whole number of groups a rank, one K/V head a query
    head)."""
    from repro_torch.models.layers import local_kv

    G, n = N // Kh, N // tp
    k = torch.randn(2, 5, Kh, 8)
    v = torch.randn(2, 5, Kh, 8)
    for r in range(tp):
        ks, vs = local_kv(k, v, r * n, n, G)
        assert n % ks.shape[2] == 0 and ks.shape == vs.shape
        per_head = n // ks.shape[2]
        own = slice(r * n, (r + 1) * n)
        assert torch.equal(ks.repeat_interleave(per_head, 2), k.repeat_interleave(G, 2)[:, :, own])
        assert torch.equal(vs.repeat_interleave(per_head, 2), v.repeat_interleave(G, 2)[:, :, own])
