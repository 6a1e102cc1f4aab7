"""The CLIs' telemetry and follower wiring on the CPU, at their smallest
sizes: ``stream_deltas --wal-dir`` writes a log with the telemetry flags
on; ``serve_relational --follow`` serves a replica of it with ``--trace``,
``--slo``, ``--flight``, ``--metrics-port 0`` and ``--sample`` and writes
its files; a ``WalFollower`` replica tails a live writer and ends bit-equal
to it while a service with a degrade-only staleness objective answers from
it; ``retrain_stream --trace`` writes a Chrome trace.  Exact: log positions,
counts, scores (the replica replays the writer's deltas through the same
code), span counts."""
import asyncio
import json

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import BoostConfig, Booster, QueryCounter
from repro_torch.incremental import MaintainedScorer
from repro_torch.incremental.recover import save_checkpoint
from repro_torch.incremental.wal import WalWriter
from repro_torch.launch import retrain_stream, serve_relational, stream_deltas
from repro_torch.obs import get_tracer, tracing_enabled
from repro_torch.relational.generators import delta_stream
from repro_torch.serving import ModelRegistry, RelationalScoringService, compile_ensemble

SMALL = ["--device", "cpu", "--n-fact", "300", "--n-dim", "24", "--trees", "2", "--depth", "2"]


def _lines(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_stream_deltas_with_telemetry_writes_a_log_and_serve_follows_it(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    wal = tmp_path / "wal"
    err = stream_deltas.main(SMALL + [
        "--batches", "4", "--wal-dir", str(wal), "--checkpoint-every", "2",
        "--metrics-port", "0", "--slo", "latency=500ms@0.9,staleness=5s",
        "--flight", "64", "--sample", str(tmp_path / "deltas.jsonl"),
        "--sample-interval", "60"])
    assert err == 0.0 and (wal / "wal.log").stat().st_size > 0
    assert (wal / "ckpt").is_dir()
    sampled = _lines(tmp_path / "deltas.jsonl")
    assert sampled and sampled[-1]["data_version"] == 4 and "staleness_s" in sampled[-1]
    assert not tracing_enabled()

    trace = tmp_path / "serve.json"
    out = serve_relational.main(SMALL + [
        "--requests", "300", "--follow", str(wal), "--follow-poll-ms", "5",
        "--trace", str(trace), "--slo", "latency=1000ms@0.9,errors=0.01,staleness=5s",
        "--flight", "4096", "--metrics-port", "0", "--sample", str(tmp_path / "serve.jsonl"),
        "--sample-interval", "60"])
    assert out["applied_lsn"] == 4 and out["shed_chunks"] == 0
    assert len(out["answers"]) == 300 and all(np.isfinite(out["answers"]))
    assert out["slo"]["objectives"]["errors"]["bad"] == 0
    doc = json.loads(trace.read_text())
    names = [e["name"] for e in doc["traceEvents"]]
    assert out["trace_spans"] == len(names) < 4096
    assert names.count("service.batch") == out["batches"] > 0
    assert "sumprod.emit" in names and len(_lines(tmp_path / "serve.json.jsonl")) == len(names)
    assert out["flight"]["capacity"] == 4096 and out["flight"]["dumps"] == []
    assert {"slo_state", "series"} <= set(_lines(tmp_path / "serve.jsonl")[-1])
    assert not tracing_enabled() and get_tracer().ring_capacity is None


def test_follower_replica_tails_a_live_writer_bit_for_bit(star, tmp_path):
    """Phase 9(c) of chip_smoke.py at the fixture's size: a writer logs and
    checkpoints, a replica recovers and tails it while the writer applies
    more batches and a service answers from the replica."""
    sch = convert.schema(star[0], device="cpu")
    trees, _ = Booster(sch, BoostConfig(n_trees=2, depth=2, mode="sketch",
                                        ssr_mode="off")).fit()
    roots = ("fact", "dim0")
    writer = MaintainedScorer(compile_ensemble(sch, trees), counter=QueryCounter())
    wal_dir = str(tmp_path / "wal")
    wal = WalWriter(wal_dir, sync_every=1).attach(writer.state)
    batches = list(delta_stream(sch, writer.live_rows, seed=4, n_batches=6, ops_per_batch=3))
    for b in batches[:2]:
        writer.apply(b)
    save_checkpoint(writer.state, str(tmp_path / "wal" / "ckpt"))
    replica, follower, rep = serve_relational.open_follower(
        compile_ensemble(sch, trees), wal_dir, poll_ms=1.0)
    assert (rep.checkpoint_lsn, rep.replayed, rep.recovered_lsn) == (2, 0, 2)
    slo = serve_relational.make_slo("staleness=5s", follower=True)
    assert all(o.degrade_only for o in slo.objectives.values())
    extra = serve_relational.follower_staleness(follower, grace_s=5.0)
    registry = ModelRegistry()
    registry.publish(replica)
    svc = RelationalScoringService(registry, "fact", slo=slo, extra_staleness=extra)

    async def run():
        await svc.start()
        answered = 0
        for b in batches[2:]:
            writer.apply(b)
            answered += len(await svc.score_many(list(range(0, 300, 7))))
        await svc.stop()
        return answered

    answered = asyncio.run(run())
    follower.stop(drain=True)
    assert follower.applied_lsn == writer.data_version == replica.data_version == 6
    for r in roots:
        for a, b in zip(replica.grouped_cached(r), writer.grouped_cached(r)):
            assert torch.equal(a, b)
    registry2 = ModelRegistry()
    registry2.publish(replica)
    svc2 = RelationalScoringService(registry2, "fact")

    async def final():
        await svc2.start()
        try:
            return await svc2.score_many(list(range(256)))
        finally:
            await svc2.stop()

    got = np.asarray(asyncio.run(final()), np.float32)
    tot, cnt = replica.grouped_cached("fact")
    want = (tot / torch.clamp(cnt, min=1.0))[:256].numpy()
    np.testing.assert_array_equal(got, want)
    assert answered == 4 * 43 and svc.stats.shed == 0
    assert slo.evaluate()["objectives"]["staleness"]["state"] != "unhealthy"
    wal.close()


def test_retrain_stream_trace_is_a_chrome_trace(tmp_path):
    trace = tmp_path / "retrain.json"
    retrain_stream.main(["--device", "cpu", "--batches", "2", "--n-fact", "120", "--n-dim", "8",
                         "--trees", "1", "--depth", "1", "--audit-every", "2",
                         "--drift-threshold", "-1", "--trace", str(trace)])
    doc = json.loads(trace.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"retrain.refit", "retrain.drift_check", "boost.level", "sumprod.emit"} <= names
    assert all(e["ph"] == "X" and e["dur"] >= 0.0 for e in doc["traceEvents"])
    assert len(_lines(tmp_path / "retrain.json.jsonl")) == len(doc["traceEvents"])
    assert not tracing_enabled()
