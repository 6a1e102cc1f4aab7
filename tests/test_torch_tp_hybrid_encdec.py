"""The hybrid block (Hymba) and the encoder–decoder (seamless-M4T) over tp
(``distributed/tp.py``, the hybrid and encdec branches of
``models/lm.py``, ``models/ssm.local_view``) on gloo ranks on the CPU,
against the JAX reference.

One spawn of a world of 4 ranks runs the meshes (1, 4) and (2, 2), each
rank joined with a timeout.  Configs, float32, the port's init from seed 0
carried to the reference (``convert.to_numpy``: the same tree):

- the smoke Hymba (4 attention heads over 2 K/V heads, 4 SSM heads, 8
  meta tokens, window 64 on layer 1): tp 4 and tp 2 split both branches'
  heads; on (1, 4) at S = 72 tokens (M + S = 80 positions, which tp
  divides: the residual stream sequence-parallel, and past the window)
  and at S = 70 (78 positions: the stream whole on every rank), on (2, 2)
  at S = 70 (sequence-parallel over tp 2);
- the smoke Hymba cut to 6 attention and 6 SSM heads over 2 K/V heads, on
  (1, 4) at S = 72: tp 4 divides neither head count (as the full config's
  25 at tp 2 and 16), so every rank computes both branches whole and
  splits only the MLP, the vocab and the stream; its SSM's d_inner (192)
  is split by the rules, so the decode cache keeps the rank's slice of the
  conv tail;
- the smoke seamless-M4T (8 heads, 8 K/V heads, 2 + 2 layers) with S = 30
  tokens over Se = 42 frames on both meshes: tp 2 divides both (the
  encoder's and the decoder's streams sequence-parallel), tp 4 neither.

For each case:

- the placed step's gradient stage (one microbatch of 4 rows): its loss
  within 1e-5 relative of the reference's ``ce`` and every gathered
  gradient leaf within 1e-4·max|g| of ``jax.value_and_grad(Model.loss)``
  (``bn_a``, ``bn_s``, ``meta``, ``A_log``, ``Dskip``, ``ln_x`` and
  ``enc_ln_f`` among them: a missed sum over tp shows there);
- every flash_attention call (the training forward, its remat recompute,
  the prefill) sees the rank's heads (all of them where tp does not divide
  them), and every cross-attention call has Sk ≠ S;
- ``steps.placed_prefill`` with room for 4 more tokens, then 4
  ``placed_decode`` steps of the batch's next tokens: each step's logits
  within 1e-4·max|logit| of the reference's at that position.  The
  reference's logits come from its forward over S + 4 tokens (the trunk
  its ``Model.loss`` runs), whose position S + t − 1 is what its
  prefill(S + t) returns, which the test holds at t = 0 against its
  prefill itself (for each config's first case);
- the cache holds the rank's shards as the rules place them: the SSM
  state its heads, the conv tail its columns, the cross k, v its K/V
  heads, ``enc_out`` and ``enc_pos`` its slice of the frames where tp
  divides them;
- no rank holds a whole split leaf.

Smoke dry-run cells beside the spawn, a subprocess an arch: prefill_32k
on (1, 4) does at most 1.5× the FLOPs a rank of (4, 1) and reduce-scatters
the stream; decode_32k on (1, 4) all-reduces the partial sums.

This module imports no JAX at module level: the parent does.
"""
import datetime
import faulthandler
import json
import multiprocessing
import os
import pickle
import re
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
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.launch import steps
from repro_torch.models import Model, stack_layers
from repro_torch.models import layers as LY
from repro_torch.optim import adamw
from repro_torch.tree import leaves, paths

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 240.0
HYMBA, SIX, ENCDEC = "hymba_1_5b", "hymba_1_5b@6heads", "seamless_m4t_medium"
MESHES = ((1, 4), (2, 2))
B, DECODE = 4, 4
FRAMES = {30: 42}                   # seamless: the encoder's frames at each token length
LOSS_RTOL, GRAD_RTOL, LOGIT_RTOL = 1e-5, 1e-4, 1e-4
# (arch, mesh, S): the cases each rank runs
CASES = [(HYMBA, MESHES[0], 72), (HYMBA, MESHES[0], 70), (HYMBA, MESHES[1], 70),
         (SIX, MESHES[0], 72), (ENCDEC, MESHES[0], 30), (ENCDEC, MESHES[1], 30)]
IDS = [f"{a.replace('@', '-')}-{'x'.join(map(str, m))}-S{s}" for a, m, s in CASES]
LEAVES = {HYMBA: ("layers.bn_a.scale", "layers.bn_s.scale", "meta", "layers.ssm.A_log",
                  "layers.ssm.Dskip", "layers.ssm.dt_bias", "layers.ssm.wdt"),
          ENCDEC: ("layers.ln_x.scale", "enc_ln_f.scale", "layers.xattn.wk", "enc_layers.attn.wq")}


def _cfg(arch, configs=configs):
    """The smoke config in float32 (``SIX``: Hymba's with 6 heads of each
    branch)."""
    cfg = configs.get_smoke(arch.split("@")[0]).replace(dtype="float32")
    return cfg.replace(n_heads=6, ssm_heads=6, n_kv_heads=2) if arch == SIX else cfg


def _batch(arch, seq):
    """The tokens (B, S + DECODE) and, for seamless, the frames (B, Se, D)."""
    cfg, rng = _cfg(arch), np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, seq + DECODE)).astype(np.int32)}
    if cfg.kind == "encdec":
        out["src_frames"] = rng.standard_normal((B, FRAMES[seq], cfg.d_model)).astype(np.float32)
    return out


class _Calls:
    """Records each flash_attention call's (heads, S, Sk, causal), standing
    in for the wrapper in its ops module and in ``models/layers``."""

    def __init__(self):
        self.real, self.calls = fops.flash_attention_gqa, []
        fops.flash_attention_gqa = LY.flash_attention_gqa = self

    def __call__(self, q, k, v, causal=True, *a, **kw):
        self.calls.append((q.shape[2], q.shape[1], k.shape[1], bool(causal)))
        return self.real(q, k, v, causal, *a, **kw)

    def take(self):
        out, self.calls = self.calls, []
        return out

    def restore(self):
        fops.flash_attention_gqa = LY.flash_attention_gqa = self.real


def _case(params, arch, mesh, seq):
    """One case on this rank: its gradients, loss, the attention calls,
    served logits, its cache's local shapes and its local shards' shapes."""
    model = Model(_cfg(arch), device="cpu")
    P = S.place(params, S.param_shardings(mesh, params))
    full = {k: torch.from_numpy(v) for k, v in _batch(arch, seq).items()}
    batch = {**full, "tokens": full["tokens"][:, :seq]}
    placed = lambda: S.place(batch, S.batch_shardings(mesh, batch))
    calls = _Calls()
    try:
        g, loss = steps.make_train_step(model, adamw.AdamWConfig(), 1).grads(P, placed())
        train_calls = calls.take()
        logits, cache = steps.placed_prefill(model, P, placed(), max_len=seq + DECODE)
        prefill_calls = calls.take()
    finally:
        calls.restore()
    out = {"loss": float(loss), "grads": [t.clone() for t in leaves(S.gathered(g))],
           "local_shapes": {n: tuple(t.to_local().shape) for n, t in zip(paths(P), leaves(P))},
           "train_calls": train_calls, "prefill_calls": prefill_calls,
           "cache_shapes": {n: tuple(t.to_local().shape)
                            for n, t in zip(paths(cache), leaves(cache))}}
    served = [logits.full_tensor().clone()]
    for t in range(DECODE):
        nxt = {"t": full["tokens"][:, seq + t]}
        logits, cache = steps.placed_decode(model, P, cache,
                                            S.place(nxt, S.batch_shardings(mesh, nxt))["t"])
        served.append(logits.full_tensor().clone())
    out["served"] = served
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
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


_DRY = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    dryrun.fake_world(4)
    cells = (("prefill_32k", "1x4"), ("prefill_32k", "4x1"), ("decode_32k", "1x4"))
    print("RESULT " + json.dumps({f"{s}@{t}": dryrun.run_cell(sys.argv[1], s, t, smoke=True)
                                  for s, t in cells}))
""")


def _trunk_logits(ref, rp, batch):
    """The reference's logits at every token position: the trunk of its
    ``Model.loss`` (the encoder, the embedding with the meta tokens, the
    blocks, ``ln_f``) and its head over every position."""
    import jax.numpy as jnp
    from repro.models import layers as RL
    from repro.models.lm import GLOBAL_WINDOW

    cfg, kw = ref.cfg, {}
    if cfg.is_encdec:
        enc = batch["src_frames"].astype(jnp.float32)
        Bn, Se = enc.shape[:2]
        pos = jnp.broadcast_to(jnp.arange(Se, dtype=jnp.int32)[None], (Bn, Se))
        enc, _ = ref._run_stack(rp["enc_layers"], enc, pos, causal=False,
                                windows=jnp.full((cfg.enc_layers,), GLOBAL_WINDOW, jnp.int32))
        kw = {"enc_out": RL.rmsnorm(enc, rp["enc_ln_f"]["scale"], cfg.norm_eps), "enc_pos": pos}
    h, positions, n_prefix = ref._embed_inputs(rp, batch)
    h, _ = ref._run_stack(rp["layers"], h, positions, **kw)
    h = RL.rmsnorm(h, rp["ln_f"]["scale"], cfg.norm_eps)[:, n_prefix:]
    return RL.mask_pad_logits(cfg, RL.unembed(rp["embed"], cfg, h).astype(jnp.float32))


def _reference(ref, rp, arch, seq, prefill: bool):
    """At S: the reference's ``ce``, its gradient, its logits at every
    position of the S + DECODE tokens and (``prefill``) its prefill(S)'s,
    one jit."""
    import jax
    import jax.numpy as jnp

    full = {k: jnp.asarray(v) for k, v in _batch(arch, seq).items()}
    batch = {**full, "tokens": full["tokens"][:, :seq]}
    fn = jax.jit(lambda rp, b, bl: (jax.value_and_grad(ref.loss, has_aux=True)(rp, b),
                                    _trunk_logits(ref, rp, bl),
                                    ref.prefill(rp, b)[0] if prefill else None))
    ((_, m), g), logits, first = fn(rp, batch, full)
    return {"ce": float(m["ce"]), "grads": [np.asarray(x) for x in jax.tree.leaves(g)],
            "logits": [np.asarray(logits[:, seq - 1 + t]) for t in range(DECODE + 1)],
            "prefill": None if first is None else np.asarray(first)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of 4 ranks' records, the reference's computed meanwhile on
    the same weights, and the dry-run cells'."""

    tmp = tmp_path_factory.mktemp("tp_hybrid_encdec")
    dry = {arch: subprocess.Popen([sys.executable, "-c", _DRY, arch], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
           for arch in (HYMBA, ENCDEC)}
    procs = []
    try:
        spec = {a: stack_layers(Model(_cfg(a), device="cpu").init(torch.Generator().manual_seed(0)))
                for a in sorted({a for a, _, _ in CASES})}
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(r, 4, str(tmp / "rdv"), str(tmp), spec))
                 for r in range(4)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        import jax

        from repro import configs as rconfigs
        from repro.models import Model as RefModel
        from repro_torch import convert

        refs = {a: RefModel(_cfg(a, rconfigs)) for a in spec}
        rps = {a: jax.tree.map(jax.numpy.asarray, convert.to_numpy(p)) for a, p in spec.items()}
        want = {}
        for a, _, s in CASES:           # the prefill held against the trunk once an arch
            if (a, s) not in want:
                want[a, s] = _reference(refs[a], rps[a], a, s, not any(k[0] == a for k in want))
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
        for arch, proc in dry.items():
            stdout, stderr = proc.communicate(timeout=JOIN_TIMEOUT_S)
            assert proc.returncode == 0, stderr[-3000:]
            line = next(x for x in stdout.splitlines() if x.startswith("RESULT "))
            cells[arch] = json.loads(line[len("RESULT "):])
    finally:
        for proc in dry.values():
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
    arch, _, seq = case
    want = runs["ref"][(arch, seq)]
    names = paths(runs["spec"][arch])
    for leaf in LEAVES[arch.split("@")[0]]:
        assert leaf in names, leaf
    for rank, res in enumerate(runs["ranks"]):
        got = res[case]
        assert abs(got["loss"] - want["ce"]) <= LOSS_RTOL * abs(want["ce"]), rank
        assert len(got["grads"]) == len(want["grads"])
        for name, a, b in zip(names, got["grads"], want["grads"]):
            _close(a.numpy(), b, GRAD_RTOL, f"rank {rank} {name}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_attention_runs_on_the_ranks_heads(runs, case):
    """Each flash_attention call (every layer's forward and its remat
    recompute in training, the prefill's) sees the rank's N/tp heads (all
    N where tp does not divide them); the cross-attention's calls are the
    non-causal ones of the decoder, over Se ≠ S keys; a prefill launches
    once an attention."""
    (arch, shape, seq), cfg = case, _cfg(case[0])
    tp, N = shape[1], cfg.n_heads
    heads = N // tp if N % tp == 0 else N
    per_pass = cfg.n_layers + (cfg.n_layers + cfg.enc_layers if cfg.kind == "encdec" else 0)
    for res in runs["ranks"]:
        for calls, passes in ((res[case]["train_calls"], 2 if cfg.remat else 1),
                              (res[case]["prefill_calls"], 1)):
            assert len(calls) == per_pass * passes
            assert {h for h, _, _, _ in calls} == {heads}
            if cfg.kind == "encdec":
                Se = FRAMES[seq]
                cross = [(s, sk) for _, s, sk, causal in calls if not causal and sk != s]
                encoder = [(s, sk) for _, s, sk, causal in calls if not causal and sk == s]
                assert cross == [(seq, Se)] * (cfg.n_layers * passes)
                assert encoder == [(Se, Se)] * (cfg.enc_layers * passes)
            else:
                assert all(causal and sk == s == cfg.meta_tokens + seq
                           for _, s, sk, causal in calls)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_placed_prefill_and_decode_match_reference(runs, case):
    arch, _, seq = case
    want = runs["ref"][(arch, seq)]
    if want["prefill"] is not None:
        _close(want["logits"][0], want["prefill"], LOGIT_RTOL, "the reference's trunk and prefill")
    for rank, res in enumerate(runs["ranks"]):
        for t, (got, ref) in enumerate(zip(res[case]["served"], want["logits"])):
            _close(got.numpy(), ref, LOGIT_RTOL, f"rank {rank} step {t}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cache_holds_the_ranks_shards(runs, case):
    """The prefill's cache as the rules place it: a hybrid layer's SSM
    state (B, H, N, P) over the rank's H/tp heads and its conv tail's
    d_inner over tp wherever tp divides them; an encdec layer's cross k, v
    over the rank's K/V heads, ``enc_out`` and ``enc_pos`` over its slice
    of the frames where tp divides them."""
    (arch, shape, seq), cfg = case, _cfg(case[0])
    tp, rows = shape[1], B // shape[0]
    cut = lambda n: n // tp if n % tp == 0 else n
    for res in runs["ranks"]:
        got = res[case]["cache_shapes"]
        for i in range(cfg.n_layers):
            if cfg.kind == "hybrid":
                H, d_inner = cfg.ssm_heads, cfg.n_heads * cfg.head_dim
                assert got[f"layers.{i}.ssm.h"] == (rows, cut(H), cfg.ssm_state, d_inner // H)
                assert got[f"layers.{i}.ssm.conv"] == (rows, 4, cut(d_inner))
            else:
                Se = FRAMES[seq]
                for k in ("xk", "xv"):
                    assert got[f"layers.{i}.{k}"] == (rows, Se, cut(cfg.kv_heads), cfg.head_dim)
                assert got["enc_out"] == (rows, cut(Se), cfg.d_model)
                assert got["enc_pos"] == (rows, cut(Se))


SPLIT = {HYMBA: r"^(embed\.(tok|head)|layers\.(attn\.w[qo]|mlp\.w_\w+|ssm\.(wx|wB|wC|conv|wo)))$",
         ENCDEC: r"^(embed\.(tok|head)|(enc_)?layers\.(attn\.w[qo]|mlp\.w_\w+)"
                 r"|enc_layers\.attn\.w[kv]|layers\.xattn\.w[qkvo])$"}


@pytest.mark.parametrize("shape", MESHES, ids=["x".join(map(str, m)) for m in MESHES])
def test_no_rank_holds_a_whole_split_leaf(runs, shape):
    """The leaves that tp divides are the rank's slices (an fsdp share
    beside): the attention's, the SSM's and the MLP's projections of
    Hymba; the self- and cross-attention's and the MLP's of seamless's
    encoder and decoder (the encoder's ``wk`` and ``wv`` too: no cache
    holds its k, v); the embeddings."""
    for arch in (HYMBA, ENCDEC):
        seq = next(s for a, m, s in CASES if (a, m) == (arch, shape))
        names = [n for n in paths(runs["spec"][arch]) if re.match(SPLIT[arch], n)]
        assert len(names) >= (11 if arch == HYMBA else 16), names
        whole = dict(zip(paths(runs["spec"][arch]),
                         (tuple(t.shape) for t in leaves(runs["spec"][arch]))))
        for res in runs["ranks"]:
            local = res[(arch, shape, seq)]["local_shapes"]
            for name in names:
                assert np.prod(local[name]) * shape[1] <= np.prod(whole[name]), (name, local[name])


@pytest.mark.parametrize("arch", (HYMBA, ENCDEC))
def test_dry_run_cells_split_over_tp(runs, arch):
    """Smoke prefill_32k on (1, 4): FLOPs a rank within 1.5× of (4, 1)'s
    (the gathered path once did every head on every rank of a tp group),
    the stream reduce-scattered; decode_32k on (1, 4): the partial sums
    all-reduced."""
    cells = runs["dry"][arch]
    one_by_four = cells["prefill_32k@1x4"]["cost_analysis"]["flops_per_device"]
    four_by_one = cells["prefill_32k@4x1"]["cost_analysis"]["flops_per_device"]
    assert one_by_four <= 1.5 * four_by_one, (one_by_four, four_by_one)
    assert cells["prefill_32k@1x4"]["collectives"]["reduce-scatter"]["count"] > 0
    assert cells["prefill_32k@4x1"]["collectives"]["reduce-scatter"]["count"] == 0
    assert cells["decode_32k@1x4"]["collectives"]["all-reduce"]["count"] > 0
