"""The placed train step (``launch/steps.py`` on DTensors placed by
``distributed/sharding.py``) over gloo ranks on the CPU, against one
process and against the reference.

TinyLlama's smoke config in float32 with count-sketch compression 8
(the reference's hashes injected, ``tests/test_torch_train.py::_inject``),
from the reference's weights carried across by ``convert``, one step on
an 8 × 40 batch (2 microbatches), on the meshes (2, 2) and (4, 1) of a
world of 4 ranks and (2, 1) of a world of 2, one spawn per world size
for the module, each rank joined with a timeout.  Against one process on
the same batch: the loss within 1e-6 relative, every gradient leaf
before AdamW (raw, then compressed) within 1e-4·max|g|, the grad norm
within 1e-6 relative, and AdamW on the shards bit-equal to AdamW in one
process given the same gradient and norm.  Against the reference's
``make_train_step`` (eager): the (2, 2) step within the same limits.
The explicit reduction: DTensor's backward of ``full_tensor()`` leaves a
rank only its own rows' gradient, while ``sharding.take``'s is summed over
the dp ranks.  Elastic: the (2, 2) world's state saved, restored in one
process and onto ``rebuild_mesh(1)`` of the world of 2, each rank's shard
the whole's slice; and the twin of ``tests/test_substrate.py``'s
``test_elastic_restore_other_device_count``: a tensor saved in one
process restored onto a (2, 2) mesh.  Serving: ``steps.placed_prefill``
and one ``placed_decode`` step on (2, 2) (the KV span split over
"model") against one process's logits, within 1e-5·max|logit|; and
``sharding.constrain`` redistributing a DTensor under ``use_mesh``.

This module imports no JAX at module level: the spawned ranks import it.
"""
import datetime
import faulthandler
import multiprocessing
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint import Checkpointer
from repro_torch.distributed import sharding as S
from repro_torch.launch import steps
from repro_torch.launch import train as T
from repro_torch.models import Model, layer_views
from repro_torch.optim import CountSketchCompressor, adamw
from repro_torch.runtime import elastic
from repro_torch.tree import leaves, map_tree, paths, unflatten

JOIN_TIMEOUT_S = 240.0
ARCH = "tinyllama_1_1b"
B, SEQ, N_MICRO = 8, 40, 2
LOSS_RTOL, GRAD_RTOL, NORM_RTOL = 1e-6, 1e-4, 1e-6
MESHES = {4: ((2, 2), (4, 1)), 2: ((2, 1),)}
OCFG = adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=3)


def _model():
    return Model(configs.get_smoke(ARCH).replace(dtype="float32"), device="cpu")


def _batch():
    rng = np.random.default_rng(10)
    return {"tokens": torch.from_numpy(rng.integers(0, 512, (B, SEQ)).astype(np.int32))}


def _compressor(hashes, record):
    """Ratio 8 with the given (leaf → Hash2) of round 0; ``record`` gets
    each compressed leaf, whole."""
    comp = CountSketchCompressor(ratio=8)
    comp._leaf_hash = lambda i, n: hashes[i]

    def run(g):
        comp(g)
        record.extend(t.clone() for t in leaves(g))
        return g
    return run


def _step(params, batch, hashes, mesh=None):
    """One step (from copies of ``params``); returns its whole tensors:
    raw and compressed gradients, loss, norm, params, m, v."""
    model, comp = _model(), []
    params = map_tree(torch.clone, params)
    state = adamw.init(OCFG, params)
    if mesh is not None:
        shard = T.state_shardings(mesh, (params, state))
        params, state = S.place(params, shard[0]), S.place(state, shard[1])
        batch = S.place(batch, S.batch_shardings(mesh, batch))
    fn = steps.make_train_step(model, OCFG, N_MICRO, compressor=_compressor(hashes, comp))
    g, loss = fn.grads(params, batch)
    raw = [t.clone() for t in leaves(S.gathered(g))]
    params, state, m = fn.update(params, state, g, loss)
    return {"raw": raw, "compressed": comp, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "params": [t.clone() for t in leaves(S.gathered(params))],
            "m": [t.clone() for t in leaves(S.gathered(state.m))],
            "v": [t.clone() for t in leaves(S.gathered(state.v))],
            "placed": (params, state)}


def _serve(params, mesh=None):
    """Prefill 8 × 24 tokens with room for 2 more, then one greedy decode
    step: (prefill logits, decode logits), whole; placed on ``mesh``
    through ``steps.placed_prefill``/``placed_decode`` where one is given."""
    model = _model()
    batch = {"tokens": _batch()["tokens"][:, :24]}
    with torch.no_grad():
        if mesh is None:
            views = layer_views(params)
            logits, cache = model.prefill(views, batch, max_len=26)
            nxt, _ = model.decode_step(views, cache, logits.argmax(-1).int())
            return logits, nxt
        P = S.place(params, S.param_shardings(mesh, params))
        logits, cache = steps.placed_prefill(model, P, S.place(batch, S.batch_shardings(mesh,
                                                                                          batch)),
                                             max_len=26)
        tok = {"t": logits.full_tensor().argmax(-1).int()}
        nxt, _ = steps.placed_decode(model, P, cache,
                                     S.place(tok, S.batch_shardings(mesh, tok))["t"])
        return logits.full_tensor(), nxt.full_tensor()


def _fault(mesh):
    """A [Shard(0), Shard(1)] weight gathered two ways, each dp rank's loss
    on its own data (zero on dp rank 0): the local gradient of DTensor's
    ``full_tensor()`` and of ``sharding.take``."""
    from torch.distributed.tensor import DTensor

    whole = torch.arange(16.0).reshape(4, 4)
    sh = S.NamedSharding(mesh, ("data", "model"))
    d = mesh.get_coordinate()[0]
    x = torch.full((4, 4), float(d))                 # dp rank 0's data is zero
    w = S.place(whole, sh).detach().requires_grad_()
    (w.full_tensor() * x).sum().backward()
    local = w.to_local().detach().clone().requires_grad_()
    (S.take(S.wrap(local, sh)) * x).sum().backward()
    return {"dtensor": w.grad.to_local().clone(), "take": local.grad.clone(),
            "slice": S.shard_slices((4, 4), mesh, sh.placements)}


def _rank_main(rank, world, rdv, out_dir, spec):
    faulthandler.enable()               # a native crash prints each thread's stack
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor

        out = {}
        for shape in MESHES[world]:
            # the world of 2 trains on the mesh that an elastic restart rebuilds, (2, 1)
            mesh = (elastic.rebuild_mesh(1, device="cpu") if world == 2 else
                    init_device_mesh("cpu", shape, mesh_dim_names=("data", "model")))
            assert tuple(mesh.shape) == shape
            res = _step(spec["params"], _batch(), spec["hashes"], mesh)
            placed = res.pop("placed")
            out[shape] = res
            if shape == (2, 2):
                out["serve"] = _serve(spec["params"], mesh)
                x = S.place(torch.arange(8.0 * 4 * 16).reshape(8, 4, 16), S.NamedSharding(mesh))
                with S.use_mesh(mesh):
                    y = S.constrain(x, "dp", "tp", None)
                out["constrain"] = (tuple(y.placements), S.constrain(x, "dp") is x,
                                    torch.equal(y.full_tensor(), x.full_tensor()))
                Checkpointer(spec["ckpt"]).save(1, placed, blocking=True)
                out["fault"] = _fault(mesh)
                like = {"w": torch.zeros(64, 32)}
                got = Checkpointer(spec["twin"]).restore(
                    3, like, {"w": S.NamedSharding(mesh, ("data", "model"))})["w"]
                out["twin"] = (got.placements, got.to_local().clone(),
                               S.shard_slices((64, 32), mesh, got.placements))
        if world == 2:                  # the (2, 2) world's checkpoint onto this world's mesh
            back = elastic.restore_elastic(Checkpointer(spec["ckpt"]), 1, placed, mesh,
                                           T.state_shardings)
            out["restored"] = (tuple(mesh.shape), [
                (t.to_local().clone(), S.shard_slices(t.shape, t.device_mesh, t.placements))
                if isinstance(t, DTensor) else (t.clone(), ()) for t in leaves(back)])
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def _start(world, tmp, spec):
    ctx = multiprocessing.get_context("spawn")
    d = tmp / f"world{world}"
    d.mkdir()
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(d / "rdv"), str(d), spec))
             for r in range(world)]
    for p in procs:
        p.start()
    return d, procs


def _join(d, procs, deadline):
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f"{len(hung)} rank(s) did not finish within {JOIN_TIMEOUT_S}s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    outs = []
    for r in range(len(procs)):
        with open(d / f"rank{r}.pkl", "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worlds of 4 and then 2 ranks (the second restores the first's
    checkpoint), with one process's step and the reference's computed
    here meanwhile."""
    import jax
    import jax.numpy as jnp

    from repro import configs as rconfigs
    from repro.launch.steps import make_train_step as ref_make_train_step
    from repro.models import Model as RefModel
    from repro.optim import adamw as ref_adamw
    from repro.optim.grad_compress import CountSketchCompressor as RefCompressor
    from repro_torch import convert

    ref = RefModel(rconfigs.get_smoke(ARCH).replace(dtype="float32"))
    rp = ref.init(jax.random.PRNGKey(0))
    params = convert.lm_stacked(rp, "cpu")
    hasher = RefCompressor(ratio=8)
    hashes = {i: convert.hash2(hasher._leaf_hash(i, t.numel()))
              for i, t in enumerate(leaves(params))}
    tmp = tmp_path_factory.mktemp("placed")
    Checkpointer(str(tmp / "twin")).save(3, {"w": torch.arange(64.0 * 32).reshape(64, 32)},
                                         blocking=True)
    spec = {"params": params, "hashes": hashes, "ckpt": str(tmp / "ckpt"),
            "twin": str(tmp / "twin")}
    out = {"params0": params, "ckpt": spec["ckpt"]}
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    started = _start(4, tmp, spec)
    try:
        one = _step(params, _batch(), hashes)
        one.pop("placed")
        out["one"] = one
        out["serve"] = _serve(params)
        rcomp, rec = RefCompressor(ratio=8), []

        def rcompress(g):
            rec.append(rcomp(g))
            return rec[-1]
        rcfg = ref_adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=3)
        rstep = ref_make_train_step(ref, rcfg, N_MICRO, compressor=rcompress)
        _, _, rm = rstep(rp, ref_adamw.init(rcfg, rp),
                         {"tokens": jnp.asarray(_batch()["tokens"].numpy())})
        out["ref"] = {"loss": float(rm["loss"]), "grad_norm": float(rm["grad_norm"]),
                      "compressed": [np.asarray(g) for g in jax.tree.leaves(rec[-1])]}
    finally:
        out[4] = _join(*started, deadline)
    out[2] = _join(*_start(2, tmp, spec), time.monotonic() + JOIN_TIMEOUT_S)
    return out


def _ranks(runs, shape):
    world = 4 if shape in MESHES[4] else 2
    return [r[shape] for r in runs[world]]


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


SHAPES = [s for w in (4, 2) for s in MESHES[w]]
IDS = ["x".join(map(str, s)) for s in SHAPES]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_placed_loss_and_norm_match_one_process(runs, shape):
    one = runs["one"]
    for res in _ranks(runs, shape):
        assert abs(res["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
        assert abs(res["grad_norm"] - one["grad_norm"]) <= NORM_RTOL * one["grad_norm"]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_placed_gradients_match_one_process(runs, shape):
    one = runs["one"]
    names = paths(runs["params0"])
    for rank, res in enumerate(_ranks(runs, shape)):
        for kind in ("raw", "compressed"):
            for name, a, b in zip(names, res[kind], one[kind]):
                _close(a, b, GRAD_RTOL, f"rank {rank} {kind} {name}")


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_adamw_on_shards_is_bit_equal_to_one_process(runs, shape):
    """AdamW in one process, given the placed step's compressed gradient
    and its norm, gives the placed step's parameters and moments bit for
    bit."""
    res = _ranks(runs, shape)[0]
    params = map_tree(torch.clone, runs["params0"])
    grads = unflatten(params, [g.clone() for g in res["compressed"]])
    state = adamw.init(OCFG, params)
    params, state, stats = adamw.apply(OCFG, params, grads, state,
                                       gn=torch.tensor(res["grad_norm"]))
    for name, a, b in zip(paths(params), leaves(params), res["params"]):
        assert torch.equal(a, b), name
    for a, b in zip(leaves(state.m) + leaves(state.v), res["m"] + res["v"]):
        assert torch.equal(a, b)


def test_placed_step_matches_reference(runs):
    ref = runs["ref"]
    names = paths(runs["params0"])
    for res in _ranks(runs, (2, 2)):
        assert abs(res["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
        assert abs(res["grad_norm"] - ref["grad_norm"]) <= NORM_RTOL * ref["grad_norm"]
        for name, a, b in zip(names, res["compressed"], ref["compressed"]):
            _close(a.numpy(), b, GRAD_RTOL, f"compressed {name}")


def test_full_tensor_gradient_is_rank_local_and_take_sums_it(runs):
    """DTensor's backward of a gather leaves each rank its own rows'
    share; the placed step's gather sums it over the dp ranks."""
    whole = torch.arange(16.0).reshape(4, 4)
    for rank, res in enumerate(runs[4]):
        f = res["fault"]
        d = rank // 2                              # the (2, 2) mesh's data coordinate
        own = torch.full((4, 4), float(d))[f["slice"]]
        total = torch.full((4, 4), 0.0 + 1.0)[f["slice"]]      # Σ_d d over dp ranks 0, 1
        assert torch.equal(f["dtensor"], own), rank
        assert torch.equal(f["take"], total), rank
        assert whole[f["slice"]].shape == f["take"].shape


def test_placed_state_is_each_ranks_slice(runs):
    """Every rank computes the same step, and holds its slice of it."""
    ranks = _ranks(runs, (2, 2))
    for res in ranks[1:]:
        assert res["loss"] == ranks[0]["loss"]
        for a, b in zip(res["params"], ranks[0]["params"]):
            assert torch.equal(a, b)


def test_elastic_restore_from_four_ranks_to_two_and_one(runs):
    """The (2, 2) world's checkpoint, restored in one process (plain) and
    onto ``rebuild_mesh(1)`` of the world of 2, every shard exact."""
    ranks = _ranks(runs, (2, 2))
    params = map_tree(torch.clone, runs["params0"])
    whole = Checkpointer(runs["ckpt"]).restore(1, (params, adamw.init(OCFG, params)))
    flat = leaves(whole)
    n = len(leaves(params))
    for a, b in zip(flat[:n], ranks[0]["params"]):
        assert torch.equal(a, b)
    for rank, res in enumerate(runs[2]):
        shape, parts = res["restored"]
        assert shape == (2, 1)
        assert len(parts) == len(flat)
        for i, ((part, sl), w) in enumerate(zip(parts, flat)):
            assert torch.equal(part, w[sl]), (rank, i)
        sharded = [i for i, (part, _) in enumerate(parts) if part.shape != flat[i].shape]
        assert sharded, "no leaf was sharded on the (2, 1) mesh"


def test_restore_onto_another_rank_count(runs):
    """The twin of the reference's elastic test: saved in one process,
    restored onto a (2, 2) mesh of 4 ranks with ("data", "model")."""
    from torch.distributed.tensor import Shard

    whole = torch.arange(64.0 * 32).reshape(64, 32)
    for rank, res in enumerate(runs[4]):
        placements, part, sl = res["twin"]
        assert tuple(placements) == (Shard(0), Shard(1))
        assert part.shape == (32, 16) and torch.equal(part, whole[sl]), rank


def test_placed_prefill_and_decode_match_one_process(runs):
    """``steps.placed_prefill`` and ``placed_decode`` on (2, 2): each rank
    prefills its rows tensor- and sequence-parallel over "model" and
    decodes on its block of the cache's slots (the span split over
    "model"); the logits within 1e-5·max|logit| of one process's."""
    want = runs["serve"]
    for rank, res in enumerate(runs[4]):
        for name, got, ref in zip(("prefill", "decode"), res["serve"], want):
            _close(got, ref, 1e-5, f"rank {rank} {name}")


def test_constrain_redistributes_a_dtensor_on_the_active_mesh(runs):
    """``sharding.constrain`` on (2, 2): a replicated (8, 4, 16) DTensor
    constrained to ("dp", "tp", None) under ``use_mesh`` comes back
    Shard(0) over "data" and Shard(1) over "model", the same values; outside
    a mesh it is the tensor itself."""
    from torch.distributed.tensor import Shard

    for res in runs[4]:
        placements, untouched, same = res["constrain"]
        assert placements == (Shard(0), Shard(1)) and untouched and same
