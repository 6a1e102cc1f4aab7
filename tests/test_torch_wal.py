"""The port's write-ahead log and checkpoints against the JAX package's.

The byte format is shared: ``encode_record`` gives byte-equal payloads in
both packages, a port ``WalFollower`` tails a log the reference's
``WalWriter`` writes, the reference's ``read_records`` reads a port log,
and a checkpoint written by either package recovers in the other.  A
recovered scorer's counts equal the live scorer's of the other package
exactly and its totals within 1e-6·Σ|ŷ| per row; within the port,
recovery is bit-equal to the recompute oracle.  Also the port's own
torn-tail semantics, LSN monotonicity (a seeded loop) and a few crash
points of the tests' fault harness (``_faultfs``)."""
import os
import tempfile

import numpy as np
import pytest
import torch

from _faultfs import CrashPoint, FaultPlan, flip_tail_bit
from repro.core import BoostConfig as RConfig, Booster as RBooster
from repro.incremental import MaintainedScorer as RScorer, TableDelta as RDelta
from repro.incremental.recover import recover_scorer as rrecover_scorer
from repro.incremental.recover import save_checkpoint as rsave_checkpoint
from repro.incremental.wal import WalWriter as RWalWriter
from repro.incremental.wal import encode_record as rencode_record
from repro.incremental.wal import read_records as rread_records
from repro.relational.generators import delta_stream as rdelta_stream
from repro.serving import compile_ensemble as rcompile

from repro_torch import convert
from repro_torch.incremental import MaintainedScorer, TableDelta
from repro_torch.incremental.recover import load_checkpoint, recover_scorer, save_checkpoint
from repro_torch.incremental.wal import (WalCorruptError, WalFollower, WalWriter,
                                         decode_record, encode_record, read_records,
                                         scan_wal, wal_path)
from repro_torch.relational.generators import delta_stream
from repro_torch.serving import compile_ensemble, contract


@pytest.fixture(scope="module")
def model(star):
    """(ref schema, port schema, ref trees, port trees) on the star."""
    rs = star[0]
    rt, _ = RBooster(rs, RConfig(n_trees=2, depth=2, mode="sketch", ssr_mode="off")).fit()
    return rs, convert.schema(rs, device="cpu"), rt, convert.trees(rt, device="cpu")


def _random_deltas(rng, cls, n):
    """n deltas of random columns, dtypes and ops (the reference's
    ``tests/test_wal.py`` mix), built as ``cls`` from one draw."""
    dtypes = [np.float32, np.float64, np.int64, np.int32]
    out = []
    for _ in range(n):
        ins = dele = upd = None
        if rng.random() < 0.7:
            k = int(rng.integers(1, 5))
            ins = {f"c{i}": rng.standard_normal(k).astype(rng.choice(dtypes))
                   for i in range(int(rng.integers(1, 4)))}
        if rng.random() < 0.5:
            dele = rng.integers(0, 1000, int(rng.integers(1, 6))).astype(np.int64)
        if rng.random() < 0.5:
            k = int(rng.integers(1, 4))
            upd = (rng.integers(0, 1000, k).astype(np.int64),
                   {f"u{i}": rng.standard_normal(k).astype(rng.choice(dtypes))
                    for i in range(int(rng.integers(1, 3)))})
        out.append(cls(table=f"t{int(rng.integers(3))}", inserts=ins, deletes=dele,
                       updates=upd))
    return out


def _same_scores(port_ms, ref_ms, root):
    """Counts exact, totals within 1e-6·Σ|ŷ| per row."""
    rt, rc = (np.array(a) for a in ref_ms.score_grouped(root))
    pt, pc = port_ms.score_grouped(root)
    np.testing.assert_array_equal(pc.numpy(), rc)
    mag = contract(port_ms._counts(root), port_ms.leaf_values.abs(), port_ms.tree0_leaves)[0]
    assert bool(((pt.double() - torch.from_numpy(rt).double()).abs()
                 <= 1e-6 * mag.double() + 1e-30).all())


def _oracle_exact(ms, root):
    tot, cnt = ms.score_grouped(root)
    ot, oc = ms.recompute_oracle(root)
    assert torch.equal(tot, ot) and torch.equal(cnt, oc)


def test_encode_record_is_byte_equal_to_the_reference():
    for seed in range(12):
        mine = _random_deltas(np.random.default_rng(seed), TableDelta, 3)
        ref = _random_deltas(np.random.default_rng(seed), RDelta, 3)
        payload = encode_record(seed + 1, mine, t_wall=1234.5 + seed)
        assert payload == rencode_record(seed + 1, ref, t_wall=1234.5 + seed)
        lsn, back, tw = decode_record(payload)
        assert (lsn, tw) == (seed + 1, 1234.5 + seed)
        assert encode_record(lsn, back, t_wall=tw) == payload


def test_port_follower_tails_a_reference_log_and_reference_reads_a_port_log(model, tmp_path):
    rs, ps, rt, pt = model
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    rms = RScorer(rcompile(rs, rt))
    rw = RWalWriter(rdir, sync_every=1).attach(rms.state)
    replica = MaintainedScorer(compile_ensemble(ps, pt))
    fol = WalFollower(rdir, replica.apply, poll_interval_s=0.001)
    for i, b in enumerate(rdelta_stream(rs, rms.live_rows, seed=29, n_batches=4,
                                        ops_per_batch=6)):
        rms.apply(b)
        if i == 0:
            rw.heartbeat()
            assert fol.step() == 1 and fol.applied_lsn == 1
    rw.close()
    fol.step()
    assert fol.applied_lsn == rms.data_version == replica.data_version == 4
    for root in ("fact", "dim0"):
        _same_scores(replica, rms, root)
        _oracle_exact(replica, root)

    # the other way: the port writes, the reference reads the same records
    pms = MaintainedScorer(compile_ensemble(ps, pt))
    pw = WalWriter(pdir, sync_every=2).attach(pms.state)
    for _, deltas, _, _ in read_records(wal_path(rdir)):
        if deltas:
            pms.apply(deltas)
    pw.close()
    mine = [(l, encode_record(l, ds, t)) for l, ds, t, _ in read_records(wal_path(pdir))]
    theirs = [(l, rencode_record(l, ds, t)) for l, ds, t, _ in rread_records(wal_path(pdir))]
    assert [l for l, _ in mine] == [1, 2, 3, 4] and mine == theirs


def test_torn_tail_stops_cleanly_and_midlog_damage_raises(tmp_path):
    d = str(tmp_path)
    w = WalWriter(d, sync_every=1)
    rng = np.random.default_rng(3)
    for i in range(1, 5):
        w.append(i, _random_deltas(rng, TableDelta, 1))
    w.close()
    path = wal_path(d)
    good = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(b"\x07\x00\x00\x00garbage")
    assert [l for l, _, _, _ in read_records(path)] == [1, 2, 3, 4]
    assert scan_wal(path)[:2] == (4, good)
    with pytest.raises(WalCorruptError):
        WalWriter(d, sync_every=1)
    w2 = WalWriter(d, sync_every=1, repair=True)
    assert w2.last_lsn == 4 and os.path.getsize(path) == good
    w2.append(5, _random_deltas(rng, TableDelta, 1))
    w2.close()
    with open(path, "r+b") as f:                  # damage a record before the tail
        f.seek(good - 3)
        b = f.read(1)
        f.seek(good - 3)
        f.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(WalCorruptError):
        list(read_records(path))


def test_lsns_are_monotonic_over_seeded_batch_sizes(tmp_path):
    rng = np.random.default_rng(11)
    for trial in range(8):
        sizes = rng.integers(1, 7, int(rng.integers(1, 10)))
        d = str(tmp_path / f"w{trial}")
        w = WalWriter(d, sync_every=3)
        for i, k in enumerate(sizes, start=1):
            w.append(i, _random_deltas(rng, TableDelta, int(k)))
        with pytest.raises(ValueError):
            w.append(len(sizes) + 2, [])          # gap
        with pytest.raises(ValueError):
            w.append(len(sizes), [])              # repeat
        w.close()
        assert [l for l, _, _, _ in read_records(wal_path(d))] == list(range(1, len(sizes) + 1))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_recovers_across_packages(model, tmp_path, writer):
    """Checkpoint at batch 2 and a log through batch 5, written by one
    package; the other recovers to lsn 5 and scores as the writer."""
    rs, ps, rt, pt = model
    wd, cd = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    if writer == "reference":
        live = RScorer(rcompile(rs, rt))
        w, save, stream = RWalWriter(wd, sync_every=1), rsave_checkpoint, rdelta_stream
    else:
        live = MaintainedScorer(compile_ensemble(ps, pt))
        w, save, stream = WalWriter(wd, sync_every=1), save_checkpoint, delta_stream
    w.attach(live.state)
    for i, b in enumerate(stream(live.schema, live.live_rows, seed=3, n_batches=5,
                                 ops_per_batch=6)):
        live.apply(b)
        if i == 1:
            save(live.state, cd)
    w.close()
    if writer == "reference":
        got, rep = recover_scorer(compile_ensemble(ps, pt), wd, cd)
        assert load_checkpoint(ps, cd)[1] == 2
        for root in ("fact", "dim1"):
            _same_scores(got, live, root)
            _oracle_exact(got, root)
    else:
        got, rep = rrecover_scorer(rcompile(rs, rt), wd, cd)
        for root in ("fact", "dim1"):
            _same_scores(live, got, root)
    assert (rep.checkpoint_lsn, rep.recovered_lsn, rep.replayed) == (2, 5, 3)
    assert got.data_version == 5


@pytest.mark.parametrize("point,tear", [("append.write", 5), ("sync.before", None),
                                        ("ckpt.after_rename", None)])
def test_crash_points_recover_to_the_oracle(model, point, tear):
    _, ps, _, pt = model
    with tempfile.TemporaryDirectory() as wd, tempfile.TemporaryDirectory() as cd:
        plan = FaultPlan(crash_at=point, on_hit=1 if point.startswith("ckpt") else 3, tear=tear)
        ms = MaintainedScorer(compile_ensemble(ps, pt))
        w = WalWriter(wd, sync_every=1, fault=plan).attach(ms.state)
        applied = 0
        try:
            for i, b in enumerate(delta_stream(ps, ms.live_rows, seed=3, n_batches=6,
                                               ops_per_batch=4)):
                ms.apply(b)
                applied = ms.data_version
                if i == 2:
                    save_checkpoint(ms.state, cd, fault=plan)
        except CrashPoint:
            pass
        else:
            w.close()
        got, rep = recover_scorer(compile_ensemble(ps, pt), wd, cd)
        assert 0 < rep.recovered_lsn <= applied + 1
        assert got.data_version == rep.recovered_lsn
        _oracle_exact(got, "fact")
        resumed = WalWriter(wd, sync_every=1, repair=True)
        assert resumed.last_lsn == rep.recovered_lsn
        resumed.attach(got.state).close()


def test_bit_flip_in_the_tail_is_discarded(model, tmp_path):
    _, ps, _, pt = model
    d = str(tmp_path)
    ms = MaintainedScorer(compile_ensemble(ps, pt))
    w = WalWriter(d, sync_every=1).attach(ms.state)
    for b in delta_stream(ps, ms.live_rows, seed=3, n_batches=4, ops_per_batch=4):
        ms.apply(b)
    w.close()
    flip_tail_bit(wal_path(d), back=3)
    got, rep = recover_scorer(compile_ensemble(ps, pt), d)
    assert rep.recovered_lsn == 3 and rep.tail_bytes_discarded > 0
    _oracle_exact(got, "fact")
