"""Expert parallelism (``models/moe.moe_ffn_tp`` under ``distributed/tp.py``)
for the MoE LMs on gloo ranks on the CPU, against the JAX reference.

One spawn of a world of 4 ranks runs the meshes (1, 4) and (2, 2), each
rank joined with a timeout.  Configs: the smoke DBRX (4 experts, top 2)
and the smoke Llama-4-Scout (4 experts, top 1, a shared expert), float32,
the reference's weights carried across by ``convert``.  For each, on
each mesh, at S = 32 (tp divides it: the residual stream
sequence-parallel) and on (1, 4) at S = 30 (the stream whole on every
rank); and both cut to 6 experts on (1, 4) at S = 32, where the rules
keep the expert stacks whole (tp 4 divides no count of 6): DBRX's output
is then every rank's whole, Scout's a partial sum over tp of its shared
expert's d_ff slices and tp rank 0's routed part:

- the placed step's gradient stage (one microbatch of 4 rows): its loss
  within 1e-5 relative of the reference's ``ce`` and every gathered
  gradient leaf within 1e-4·max|g| of ``jax.value_and_grad(Model.loss)``
  (the router's among them: a missed or doubled sum over tp, or an aux
  loss counted on every rank, shows there).  Each dp rank routes its own
  rows (``launch/steps.py``), so on (2, 2) the reference is the mean of
  its loss and gradient over the two dp ranks' rows;
- the routing: every route call of the gradient stage and the prefill
  replays the reference's top-k choices (``moe.route(..., expert=...)``,
  as chip_smoke's ``moe_twin`` does), and the port's own choices, ranks
  and keep mask must equal the reference's, a choice differing only where
  the reference's two probabilities lie within ``TIE`` of each other
  (printed: how many);
- ``steps.placed_prefill`` of 4 × S tokens with room for 4 more, then 4
  ``placed_decode`` steps of the batch's next tokens: each step's logits
  within 1e-4·max|logit| of the reference's prefill(S + t);
- each rank's local shards: no rank holds a whole expert stack, a whole
  shared expert or a whole ``wq``/``wo``.

A dry-run smoke cell beside the spawn: DBRX train_4k on (1, 4) does at
most 1.5× the FLOPs a rank of (4, 1) (every rank of a tp group once ran
every expert).

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.distributed import sharding as S
from repro_torch.launch import steps
from repro_torch.models import Model, moe
from repro_torch.optim import adamw
from repro_torch.tree import leaves, paths

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 240.0
ARCHS = ("dbrx_132b", "llama4_scout_17b_a16e")
WHOLE = tuple(f"{a}@6experts" for a in ARCHS)   # 6 experts: tp 4 divides no expert count
MESHES = ((1, 4), (2, 2))
B, SEQ, ODD, DECODE = 4, 32, 30, 4
LOSS_RTOL, GRAD_RTOL, LOGIT_RTOL = 1e-5, 1e-4, 1e-4
TIE = 1e-5                  # two probabilities this close may order either way in float32
# (arch, mesh, S): the cases each rank runs
CASES = ([(a, m, s) for a in ARCHS for m, s in ((MESHES[0], SEQ), (MESHES[1], SEQ),
                                                  (MESHES[0], ODD))]
         + [(a, MESHES[0], SEQ) for a in WHOLE])
IDS = [f"{a}-{'x'.join(map(str, m))}-S{s}" for a, m, s in CASES]


def _cfg(arch, configs=configs):
    """The smoke config in float32 (``WHOLE``'s with 6 experts)."""
    cfg = configs.get_smoke(arch.split("@")[0]).replace(dtype="float32")
    return cfg.replace(n_experts=6) if arch in WHOLE else cfg


def _tokens(arch, n):
    return np.random.default_rng(7).integers(0, _cfg(arch).vocab, (B, n)).astype(np.int32)


class _Replay:
    """A stand-in for ``moe.route``: each call routes as the port would
    (recorded) and returns the routing of the reference's choices for
    that call.  ``want``: the reference's (T, K) choices by layer; a
    gradient stage routes layers 0..L−1, then L−1..0 again in the remat
    recomputes, a prefill 0..L−1."""

    def __init__(self, want, route=moe.route):
        self.want, self.route, self.calls = want, route, 0
        self.own, self.used = [], []

    def __call__(self, p, cfg, xt, capacity_factor=None, expert=None, aux_rows=None):
        L, i = len(self.want), self.calls % (2 * len(self.want))
        self.calls += 1
        want = torch.from_numpy(self.want[i if i < L else 2 * L - 1 - i]).long()
        with torch.no_grad():
            own = self.route(p, cfg, xt, capacity_factor)
        r = self.route(p, cfg, xt, capacity_factor, expert=want, aux_rows=aux_rows)
        if i < L:
            self.own.append({k: getattr(own, k).numpy().copy() for k in ("expert", "rank", "keep")})
            self.used.append({"rank": r.rank.detach().numpy().copy(),
                              "keep": r.keep.numpy().copy(), "capacity": r.capacity})
        return r


def _swap_route(stand_in):
    moe.route, old = stand_in, moe.route
    return old


def _case(params, arch, mesh, seq, routes):
    """One case on this rank: its gradients, loss, routing, served logits
    and its local shards' shapes."""
    model = Model(_cfg(arch), device="cpu")
    P = S.place(params, S.param_shardings(mesh, params))
    group = mesh.get_coordinate()[0]                     # this rank's dp group
    tok = torch.from_numpy(_tokens(arch, seq + DECODE))
    batch = {"tokens": tok[:, :seq]}
    fn = steps.make_train_step(model, adamw.AdamWConfig(), 1)
    train = _Replay(routes["train"][group])
    old = _swap_route(train)
    try:
        g, loss = fn.grads(P, S.place(batch, S.batch_shardings(mesh, batch)))
    finally:
        _swap_route(old)
    out = {"group": group, "loss": float(loss),
           "grads": [t.clone() for t in leaves(S.gathered(g))],
           "local_shapes": {n: tuple(t.to_local().shape) for n, t in zip(paths(P), leaves(P))},
           "train_calls": train.calls, "train_own": train.own, "train_used": train.used}
    pre = _Replay(routes["prefill"][group])
    old = _swap_route(pre)
    try:
        logits, cache = steps.placed_prefill(model, P, S.place(batch, S.batch_shardings(
            mesh, batch)), max_len=seq + DECODE)
    finally:
        _swap_route(old)
    out.update(prefill_own=pre.own, prefill_used=pre.used)
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
        out = {}
        for _ in ARCHS + WHOLE:         # each arch's weights and routes as the parent has them
            arch, spec, routes = inbox.get(timeout=JOIN_TIMEOUT_S)
            for case in (c for c in CASES if c[0] == arch):
                out[case] = _case(spec, arch, meshes[case[1]], case[2], routes[case])
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


DRY_TAGS = ("1x4", "4x1")   # the dry run's meshes, a subprocess each
_DRY = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    dryrun.fake_world(4)
    print("RESULT " + json.dumps(dryrun.run_cell("dbrx_132b", "train_4k", sys.argv[1],
                                                 smoke=True)))
""")


_SINKS = {}                 # by (name, experts): where a config's routings go (None: nowhere)


def _recording(real):
    """The reference's ``moe_ffn`` that records each call's probabilities
    and top-k choices into its config's sink (``jax.debug.callback``: read
    when a function is traced, it records whenever the traced function
    runs, before the call returns)."""
    import functools

    import jax
    import jax.numpy as jnp

    def record(name, probs, idx):
        if _SINKS.get(name) is not None:
            _SINKS[name].append((np.asarray(probs), np.asarray(idx)))

    def recording(p, cfg, x, capacity_factor=None):
        probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"], -1)
        jax.debug.callback(functools.partial(record, (cfg.name, cfg.n_experts)), probs,
                           jax.lax.top_k(probs, cfg.top_k)[1])
        return real(p, cfg, x, capacity_factor)
    return recording


class _Reference:
    """The reference's model of ``arch``, its weights and its jitted
    gradient and prefill."""

    def __init__(self, arch):
        import jax

        from repro import configs as rconfigs
        from repro.models import Model as RefModel

        self.name = (_cfg(arch).name, _cfg(arch).n_experts)
        self.model = RefModel(_cfg(arch, rconfigs))
        self.params = self.model.init(jax.random.PRNGKey(0))
        self.grad = jax.jit(jax.value_and_grad(lambda p, b: self.model.loss(p, b), has_aux=True))
        self.prefill = jax.jit(lambda p, b: self.model.prefill(p, b))

    def routed(self, fn, rows, first: int):
        """``fn`` on these token rows, and the first ``first`` routings it
        made (a gradient's forward comes before its remat recomputes)."""
        import jax
        import jax.numpy as jnp

        _SINKS[self.name] = []
        out = jax.block_until_ready(fn(self.params, {"tokens": jnp.asarray(rows)}))
        got, _SINKS[self.name] = _SINKS[self.name][:first], None
        return out, got


def _reference_routed(ref, arch):
    """Per case of ``arch``: the reference's (dp-group mean) ``ce`` and
    gradient, and by dp group its routing of the gradient's forward and
    of the prefill of S tokens."""
    import jax

    L, out = _cfg(arch).n_layers, {}
    for arch_, shape, seq in CASES:
        if arch_ != arch:
            continue
        ce, gs, train, pre = 0.0, None, [], []
        for rows in np.split(_tokens(arch, seq + DECODE)[:, :seq], shape[0]):
            ((_, m), g), r = ref.routed(ref.grad, rows, L)
            g = [np.asarray(x) / shape[0] for x in jax.tree.leaves(g)]
            ce += float(m["ce"]) / shape[0]
            gs = g if gs is None else [a + b for a, b in zip(gs, g)]
            train.append(r)
            pre.append(ref.routed(ref.prefill, rows, L)[1])
        out[(arch, shape, seq)] = {"ce": ce, "grads": gs, "train": train, "prefill": pre}
    return out


def _reference_logits(ref, arch, out):
    """The reference's prefill(S + t) logits for t = 0..DECODE, by case."""
    import jax.numpy as jnp

    logits = {}
    for case in out:
        seq = case[2]
        if seq not in logits:
            tok = _tokens(arch, seq + DECODE)
            logits[seq] = [np.asarray(ref.prefill(ref.params,
                                                  {"tokens": jnp.asarray(tok[:, :seq + t])})[0])
                           for t in range(DECODE + 1)]
        out[case]["logits"] = logits[seq]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of 4 ranks' records, the dry-run cells' and the
    reference's: each arch's gradients and routing computed while the
    ranks start (they replay its routing, and begin on an arch once it is
    sent), then the logits while they run."""
    from repro.models import moe as RMOE  # the reference, in this process only
    from repro_torch import convert

    tmp = tmp_path_factory.mktemp("tp_moe")
    dry = [subprocess.Popen([sys.executable, "-c", _DRY, tag], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
           for tag in DRY_TAGS]
    refs, procs, real = {}, [], RMOE.moe_ffn
    RMOE.moe_ffn = _recording(real)
    try:
        ctx = multiprocessing.get_context("spawn")
        inboxes = [ctx.Queue() for _ in range(4)]
        procs = [ctx.Process(target=_rank_main, args=(r, 4, str(tmp / "rdv"), str(tmp), box))
                 for r, box in enumerate(inboxes)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        ref, spec = {}, {}

        def one(arch):                  # the ranks start on an arch once its routes are sent
            refs[arch] = _Reference(arch)
            ref[arch] = _reference_routed(refs[arch], arch)
            spec[arch] = convert.lm_stacked(refs[arch].params, "cpu")
            routes = {case: {k: [[idx for _, idx in layers] for layers in ref[arch][case][k]]
                             for k in ("train", "prefill")} for case in ref[arch]}
            for box in inboxes:
                box.put((arch, spec[arch], routes))
            _reference_logits(refs[arch], arch, ref[arch])
        with ThreadPoolExecutor(len(ARCHS)) as pool:   # two archs' compiles overlap
            list(pool.map(one, ARCHS + WHOLE))
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
        RMOE.moe_ffn = real
    return {"ref": ref, "spec": spec, "ranks": ranks, "dry": cells}


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_placed_loss_and_gradients_match_reference(runs, case):
    want = runs["ref"][case[0]][case]
    names = paths(runs["spec"][case[0]])
    assert any(n.endswith("moe.router") for n in names)
    for rank, res in enumerate(runs["ranks"]):
        got = res[case]
        assert abs(got["loss"] - want["ce"]) <= LOSS_RTOL * abs(want["ce"]), rank
        assert len(got["grads"]) == len(want["grads"])
        for name, a, b in zip(names, got["grads"], want["grads"]):
            _close(a.numpy(), b, GRAD_RTOL, f"rank {rank} {name}")


def _ref_rank_keep(expert, E, C):
    """The reference's rule: a pair's rank in its expert in arrival order
    (the flattened (T·K) pairs), kept below the capacity C."""
    flat = expert.reshape(-1)
    onehot = np.eye(E, dtype=np.int64)[flat]
    rank = np.take_along_axis(np.cumsum(onehot, 0) - onehot, flat[:, None], 1)[:, 0]
    return rank, rank < C


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_routing_matches_reference(runs, case):
    """The gradient stage's forward routing and the prefill's, on every
    rank: the port's own top-k choices are the reference's but where its
    two probabilities tie within ``TIE``; the replayed routing's ranks
    and keep are the reference's rule applied to its choices, and the
    port's own ranks and keep equal them where no choice differed."""
    arch, shape, _ = case
    cfg = _cfg(arch)
    want = runs["ref"][arch][case]
    ties = 0
    for res in runs["ranks"]:
        got = res[case]
        assert got["train_calls"] == 2 * cfg.n_layers           # forward, then the recomputes
        for stage in ("train", "prefill"):
            own, used = got[f"{stage}_own"], got[f"{stage}_used"]
            assert len(own) == cfg.n_layers
            for (probs, idx), o, u in zip(want[stage][got["group"]], own, used):
                differ = (o["expert"] != idx).any(1)
                if differ.any():
                    srt = np.sort(probs[differ], 1)[:, ::-1]
                    gap = srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]
                    assert (gap <= TIE).all(), (stage, gap)
                    ties += int(differ.sum())
                rank, keep = _ref_rank_keep(idx, cfg.n_experts, u["capacity"])
                np.testing.assert_array_equal(u["rank"], rank)
                np.testing.assert_array_equal(u["keep"], keep)
                if not differ.any():
                    np.testing.assert_array_equal(o["rank"], rank)
                    np.testing.assert_array_equal(o["keep"], keep)
    print(f"{case}: {ties} token choices differed from the reference's (replayed) across "
          f"the ranks")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_placed_prefill_and_decode_match_reference(runs, case):
    want = runs["ref"][case[0]][case]["logits"]
    for rank, res in enumerate(runs["ranks"]):
        for t, (got, ref) in enumerate(zip(res[case]["served"], want)):
            _close(got.numpy(), ref, LOGIT_RTOL, f"rank {rank} step {t}")


@pytest.mark.parametrize("shape", MESHES, ids=["x".join(map(str, m)) for m in MESHES])
def test_no_rank_holds_a_whole_expert_stack(runs, shape):
    """The expert stacks are the rank's E/tp experts, the shared expert its
    d_ff slice, ``wq`` and ``wo`` its heads: a quarter or a half of each
    on (1, 4) and (2, 2), its fsdp share beside."""
    for arch in ARCHS:
        cfg = _cfg(arch)
        E, D, Fw, L = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.n_layers
        full = {"layers.moe.w_gate": (L, E, D, Fw), "layers.moe.w_up": (L, E, D, Fw),
                "layers.moe.w_down": (L, E, Fw, D),
                "layers.attn.wq": (L, D, cfg.n_heads * cfg.head_dim),
                "layers.attn.wo": (L, cfg.n_heads * cfg.head_dim, D)}
        if cfg.shared_expert:
            full.update({"layers.moe.shared.w_gate": (L, D, Fw),
                         "layers.moe.shared.w_up": (L, D, Fw),
                         "layers.moe.shared.w_down": (L, Fw, D)})
        for res in runs["ranks"]:
            local = res[(arch, shape, SEQ)]["local_shapes"]
            for name, whole in full.items():
                assert np.prod(local[name]) * shape[0] * shape[1] == np.prod(whole), (
                    name, local[name])
            for name in ("layers.moe.w_gate", "layers.moe.w_up", "layers.moe.w_down"):
                assert local[name][1] == E // shape[1], (name, local[name])


def test_dry_run_flops_a_rank_split_over_tp(runs):
    """DBRX train_4k (smoke): (1, 4)'s FLOPs a rank within 1.5× of (4, 1)'s,
    where every rank of a tp group once ran every expert."""
    one_by_four = runs["dry"]["1x4"]["cost_analysis"]["flops_per_device"]
    four_by_one = runs["dry"]["4x1"]["cost_analysis"]["flops_per_device"]
    assert one_by_four <= 1.5 * four_by_one, (one_by_four, four_by_one)
    assert runs["dry"]["1x4"]["collectives"]["reduce-scatter"]["count"] > 0
