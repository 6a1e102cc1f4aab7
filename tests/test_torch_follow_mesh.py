"""A WAL follower sharded over a data mesh (``serve_relational``'s
``open_mesh_follower``, ``incremental.wal.MeshFollower``) on two gloo ranks
on the CPU, against the port's one-process follower and the reference's
``MaintainedScorer``.

One spawn of two ranks (each joined with a timeout).  The writer is this
process: a one-process ``MaintainedScorer`` over a small star with a
``WalWriter``, which writes records 1-4, a checkpoint, record 5, and then,
once both ranks have recovered, records 6-10 while they follow live.  The
ranks recover (rank 0 picks the checkpoint, the log past it arrives by
broadcast), rank 0 tails the log and serves requests on the published
snapshots meanwhile, rank 1 stays in the follower's rounds until rank 0
stops it.  Gates:

- every rank recovered to LSN 5 and applied through 10, the writer's;
- at the checkpoint and after every record, both roots' grouped (Σŷ,
  count) on every rank are bit-equal to the port's one-process
  follower's at that LSN;
- at LSN 10, counts equal to the reference's ``MaintainedScorer``
  recovered from the same log and checkpoint (the format is shared) and
  totals within 1e-6·Σ|ŷ| a row;
- each answer rank 0 served equals the means of the version it was served
  at, and no collective ran on rank 0's request thread after the
  follower started (``spmd.psum_message``, ``replicate`` and
  ``broadcast_object`` wrapped and counted by thread);
- ``serve_relational.main([... "--mesh", "2", "--follow", ...])`` then runs
  on both ranks (it used to refuse a follower on a mesh): recovery from
  the same log and checkpoint, 200 requests, every rank at LSN 10;
- where rank 0 fails, the other rank fails with its error and does not
  wait for the group's timeout: the CLI again with rank 0's traffic
  raising (``drive``), and with rank 0's log reads raising in recovery
  (a damaged log), each run within ``FAIL_S``.
"""
import asyncio
import datetime
import faulthandler
import multiprocessing
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

JOIN_TIMEOUT_S = 240.0
SEED, N_FACT, N_DIM = 0, 400, 24
ROOTS = ("fact", "dim0")
CHECKPOINT, BEFORE, LAST = 4, 5, 10        # the writer's checkpoint, LSN at recovery, last LSN
TOTAL_RTOL = 1e-6
FAIL_S = 30.0                              # a failing CLI run's limit on each rank


def _schema(inp, dev="cpu"):
    from repro_torch.core import Schema, Table

    return Schema([Table(n, cols, fc) for n, cols, fc in inp["tables"]], label=inp["label"],
                  device=dev)


def _grouped(snap):
    return {r: [x.clone() for x in snap.grouped_cached(r)] for r in ROOTS}


def _serve(served, follower, ids, final_box):
    """Rank 0's traffic while the follower runs: chunks of 64 requests on
    the published versions until the follower applied the final LSN; each
    chunk with the version before and after it."""
    from repro_torch.serving import ModelRegistry, RelationalScoringService

    registry = ModelRegistry()
    registry.publish(served)
    svc = RelationalScoringService(registry, "fact", max_batch=16, max_wait_ms=0.5,
                                   cache_size=0)
    chunks, final = [], None

    async def go():
        nonlocal final
        await svc.start()
        k, deadline = 0, time.monotonic() + JOIN_TIMEOUT_S / 2
        while final is None or follower.applied_lsn < final:
            if time.monotonic() > deadline:
                raise AssertionError(f"follower at {follower.applied_lsn}, final {final}")
            if final is None and not final_box.empty():
                final = final_box.get()
            chunk = ids[(k * 64) % len(ids):][:64]
            before = served.data_version
            got = await svc.score_many(chunk.tolist())
            chunks.append((before, chunk, np.asarray(got, np.float32), served.data_version))
            k += 1
            await asyncio.sleep(0.002)
        await svc.stop()

    asyncio.run(go())
    return chunks


def _counting(rec):
    """Wrap the relational collectives: each call's thread and time."""
    from repro_torch.distributed import spmd

    for name in ("psum_message", "replicate", "broadcast_object"):
        real = getattr(spmd, name)

        def counted(*a, _real=real, _name=name, **kw):
            rec.append((_name, threading.get_ident(), time.monotonic()))
            return _real(*a, **kw)
        setattr(spmd, name, counted)


def _follow(rank, inp, wal_dir, outbox, inbox):
    from repro_torch.core import QueryCounter
    from repro_torch.core.tree import TreeArrays
    from repro_torch.distributed import spmd
    from repro_torch.launch import serve_relational as sr
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.serving import compile_ensemble

    mesh = make_data_mesh(2, device="cpu")
    schema = _schema(inp)
    trees = [TreeArrays(*t) for t in inp["trees"]]
    calls = []
    if rank == 0:
        _counting(calls)
    with spmd.use_data_mesh(mesh):
        ens = compile_ensemble(schema, trees, counter=QueryCounter())
    seen = {}
    served, follower, rep = sr.open_mesh_follower(
        ens, wal_dir, 2.0, mesh, ROOTS, on_publish=lambda lsn, snap: seen.__setitem__(
            lsn, _grouped(snap)))
    out = {"recovered": rep.recovered_lsn, "checkpoint": rep.checkpoint_lsn,
           "replayed": rep.replayed, "sharded": spmd.is_row_sharded(
               served.replica.factors["fact"], mesh, rows=served.replica.n_rows("fact"))}
    if rank == 0:
        t_start = time.monotonic()
        follower.start()
        fid = follower._thread.ident
        outbox.put(("ready", rank))
        ids = np.random.default_rng(3).integers(0, N_FACT, 4096)
        out["chunks"] = _serve(served, follower, ids, inbox)
        follower.stop(drain=True)
        out["follower_calls"] = sum(1 for _, ident, t in calls if t >= t_start and ident == fid)
        out["request_calls"] = [n for n, ident, t in calls if t >= t_start and ident != fid]
    else:
        outbox.put(("ready", rank))
        follower.run()
    out["applied"] = follower.applied_lsn
    out["seen"] = seen
    return out


def _cli(rank, wal_dir):
    from repro_torch.launch import serve_relational as sr

    return sr.main(["--device", "cpu", "--mesh", "2", "--follow", wal_dir,
                    "--seed", str(SEED), "--n-fact", str(N_FACT), "--n-dim", str(N_DIM),
                    "--trees", "2", "--depth", "2", "--requests", "200",
                    "--concurrency", "50", "--follow-poll-ms", "2"])


def _cli_failing(rank, wal_dir, where):
    """The CLI with rank 0 failing ``where`` ("serving": its traffic raises;
    "recovery": its log reads raise as on a damaged log); each rank's
    error and seconds."""
    from repro_torch.incremental import wal
    from repro_torch.launch import serve_relational as sr

    real = (sr.drive, wal.WalReader.poll)
    if rank == 0:
        if where == "serving":
            async def drive(*a, **kw):
                raise RuntimeError("the traffic failed")
            sr.drive = drive
        else:
            def poll(self):
                raise wal.WalCorruptError("damaged log")
            wal.WalReader.poll = poll
    t0 = time.monotonic()
    try:
        _cli(rank, wal_dir)
        err = None
    except Exception as e:  # noqa: BLE001 — the error is the result
        err = f"{type(e).__name__}: {e}"
    finally:
        sr.drive, wal.WalReader.poll = real
    return err, time.monotonic() - t0


def _rank_main(rank, rdv, out_dir, inbox, outbox):
    faulthandler.enable()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        inp, wal_dir = inbox.get(timeout=JOIN_TIMEOUT_S)
        out = _follow(rank, inp, wal_dir, outbox, inbox)
        cli = _cli(rank, wal_dir)
        out["cli"] = {k: cli[k] for k in ("applied_lsn", "answers", "evals") if k in cli}
        out["cli_failing"] = {w: _cli_failing(rank, wal_dir, w) for w in ("serving", "recovery")}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def _one_process_follower(ps, pt, wal_dir):
    """The port's one-process follower: the checkpoint, then each record
    applied alone; both roots' grouped outputs at every LSN."""
    from repro_torch.incremental import MaintainedScorer
    from repro_torch.incremental.recover import load_checkpoint
    from repro_torch.incremental.wal import read_records, wal_path
    from repro_torch.serving import compile_ensemble

    ms = MaintainedScorer(compile_ensemble(ps, pt))
    state, lsn, _ = load_checkpoint(ps, os.path.join(wal_dir, "ckpt"))
    ms.adopt_state(state)
    out = {lsn: {r: [x.clone() for x in ms.grouped_cached(r)] for r in ROOTS}}
    for rec_lsn, deltas, _, _ in read_records(wal_path(wal_dir)):
        if rec_lsn > lsn:
            ms.apply(deltas)
            out[rec_lsn] = {r: [x.clone() for x in ms.grouped_cached(r)] for r in ROOTS}
    return ms, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro.core import BoostConfig as RConfig, Booster as RBooster
    from repro.incremental.recover import recover_scorer as rrecover_scorer
    from repro.relational.generators import star_schema as rstar
    from repro.serving import compile_ensemble as rcompile
    from repro_torch import convert
    from repro_torch.incremental import MaintainedScorer
    from repro_torch.incremental.recover import save_checkpoint
    from repro_torch.incremental.wal import WalWriter
    from repro_torch.relational.generators import delta_stream, star_schema
    from repro_torch.serving import compile_ensemble

    tmp = tmp_path_factory.mktemp("follow_mesh")
    wal_dir = str(tmp / "wal")
    ctx = multiprocessing.get_context("spawn")
    inboxes, outbox = [ctx.Queue() for _ in range(2)], ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp / "rdv"), str(tmp), box, outbox))
             for r, box in enumerate(inboxes)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        rs = rstar(seed=SEED, n_fact=N_FACT, n_dim=N_DIM)
        ps = convert.schema(rs, device="cpu")
        mine = star_schema(seed=SEED, n_fact=N_FACT, n_dim=N_DIM, device="cpu")
        for a, b in zip(ps.tables, mine.tables):      # the CLI's own schema is the same star
            assert a.name == b.name and all(np.array_equal(a.columns[c], b.columns[c])
                                            for c in a.columns)
        rt, _ = RBooster(rs, RConfig(n_trees=2, depth=2, mode="sketch", ssr_mode="off")).fit()
        pt = convert.trees(rt, device="cpu")
        writer = MaintainedScorer(compile_ensemble(ps, pt))
        wal = WalWriter(wal_dir, sync_every=1).attach(writer.state)
        stream = delta_stream(ps, writer.live_rows, seed=17, n_batches=LAST, ops_per_batch=6)
        for lsn in range(1, BEFORE + 1):
            writer.apply(next(stream))
            if lsn == CHECKPOINT:
                save_checkpoint(writer.state, os.path.join(wal_dir, "ckpt"))
        inp = {"tables": [(t.name, t.columns, t.feature_columns) for t in ps.tables],
               "label": (ps.label_table, ps.label_column),
               "trees": [(t.feat, t.thr, t.leaf) for t in pt]}
        for box in inboxes:
            box.put((inp, wal_dir))
        ready = set()
        while len(ready) < 2:
            ready.add(outbox.get(timeout=max(1.0, deadline - time.monotonic()))[1])
        for lsn in range(BEFORE + 1, LAST + 1):       # live, while the ranks follow
            time.sleep(0.02)
            writer.apply(next(stream))
        wal.close()
        inboxes[0].put(writer.data_version)
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        assert not hung, f"{len(hung)} rank(s) did not finish within {JOIN_TIMEOUT_S}s"
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    ranks = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    one, per_lsn = _one_process_follower(ps, pt, wal_dir)
    ref, _ = rrecover_scorer(rcompile(rs, rt), wal_dir, os.path.join(wal_dir, "ckpt"))
    return {"ranks": ranks, "writer_lsn": writer.data_version, "one": one,
            "per_lsn": per_lsn, "ref": ref}


def test_every_rank_recovers_and_applies_to_the_writers_lsn(runs):
    assert runs["writer_lsn"] == LAST
    for res in runs["ranks"]:
        assert (res["checkpoint"], res["recovered"], res["replayed"]) == (
            CHECKPOINT, BEFORE, BEFORE - CHECKPOINT)
        assert res["applied"] == LAST
        assert res["sharded"]                   # the fact factor is a row block


def test_roots_bit_equal_to_one_process_follower_after_every_record(runs):
    want = runs["per_lsn"]
    for rank, res in enumerate(runs["ranks"]):
        assert sorted(res["seen"]) == list(range(CHECKPOINT, LAST + 1)), rank
        for lsn, got in res["seen"].items():
            for r in ROOTS:
                for a, b in zip(got[r], want[lsn][r]):
                    assert torch.equal(a, b), (rank, lsn, r)


def test_final_scores_match_the_reference(runs):
    from repro_torch.serving import contract

    one, ref = runs["one"], runs["ref"]
    assert ref.data_version == LAST
    for r in ROOTS:
        rt, rc = (np.array(x) for x in ref.score_grouped(r))
        pt, pc = runs["ranks"][0]["seen"][LAST][r]
        np.testing.assert_array_equal(pc.numpy(), rc)
        mag = contract(one._counts(r), one.leaf_values.abs(), one.tree0_leaves)[0]
        assert bool(((pt.double() - torch.from_numpy(rt).double()).abs()
                     <= TOTAL_RTOL * mag.double() + 1e-30).all()), r


def test_rank0_answers_are_the_means_of_their_versions(runs):
    res = runs["ranks"][0]
    checked = 0
    for before, ids, got, after in res["chunks"]:
        if before != after:                     # a publication inside the chunk
            continue
        tot, cnt = res["seen"][before]["fact"] if before in res["seen"] else (None, None)
        if tot is None:
            continue
        want = (tot / torch.clamp(cnt, min=1.0))[torch.from_numpy(ids)].numpy()
        np.testing.assert_array_equal(got, want)
        checked += len(ids)
    print(f"{checked} answers checked over {len(res['chunks'])} chunks")
    assert checked >= 256


def test_no_collective_on_rank0_request_thread(runs):
    """After the follower started, every collective on rank 0 ran on the
    follower's thread, none on the thread that served the requests."""
    res = runs["ranks"][0]
    assert res["request_calls"] == []
    assert res["follower_calls"] > 0


def test_cli_follows_on_a_mesh(runs):
    for res in runs["ranks"]:
        assert res["cli"]["applied_lsn"] == LAST
    assert len(runs["ranks"][0]["cli"]["answers"]) == 200


@pytest.mark.parametrize("where", ["serving", "recovery"])
def test_cli_rank0_failure_reaches_every_rank(runs, where):
    """Rank 0 fails (its traffic, or its log reads in recovery): it raises
    its error, and the other rank raises it too, well inside the group's
    timeout, where it would otherwise wait in the follower's rounds."""
    want = {"serving": "the traffic failed", "recovery": "damaged log"}[where]
    for rank, res in enumerate(runs["ranks"]):
        err, seconds = res["cli_failing"][where]
        assert err is not None and want in err, (rank, err)
        assert seconds < FAIL_S, (rank, seconds)
