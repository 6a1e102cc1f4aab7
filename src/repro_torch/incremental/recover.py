"""Checkpoint + WAL-tail recovery for the dynamic relational store.

Recovery contract (the invariant every fault-injection test pins):
after ANY crash — torn append, bit-flipped tail, death at any
checkpoint/rename step, SIGKILL mid-stream — recovery lands on a valid
LSN ``L`` (the newest durable version), and the recovered
:class:`~repro_torch.incremental.state.DynamicState` scores **bit-equal** to
the pinned recompute oracle at ``data_version == L``.

Checkpoints reuse the atomic publication pattern of
``checkpoint/checkpointer.py`` (tmp dir → fsync'd files → rename →
``LATEST`` pointer replaced last), but serialize the *dynamic* store —
capacity-padded columns, liveness masks, append-only key dictionaries,
version counters — as plain ``.npy`` files with per-file CRC32s in the
manifest, so a bit-flipped checkpoint is detected and recovery falls
back to the previous one (plus a longer WAL replay) instead of loading
garbage.

Layout::

    <ckpt_dir>/ckpt_<lsn>/
        manifest.json        versions, capacities, edge specs, file CRCs
        t.<table>.<col>.npy  one file per column (full capacity)
        t.<table>.live.npy   liveness mask
        e<i>.key<j>.npy      edge i's key dictionary, column j, id order
        e<i>.ids.<table>.npy maintained key-id array per incident table
    <ckpt_dir>/LATEST        newest lsn (written last, replaced atomically)

Entry points:

- :func:`save_checkpoint` — atomic snapshot of a live state (captured
  under ``state.lock``), with retention GC.
- :func:`recover_state` — newest valid checkpoint + replay of the WAL
  tail, torn tail discarded at the last valid LSN.
- :func:`recover_scorer` — the same, rebuilt into a fresh
  :class:`~repro_torch.incremental.maintain.MaintainedScorer` (factor rows
  re-evaluated for the recovered live slots; replay runs through
  ``scorer.apply`` so maintained factors stay exact).
- :func:`recover_scorer_on_mesh` — every rank of a data mesh at the
  checkpoint rank 0 chose; the log follows through a ``MeshFollower``.

Checkpoint format 1 is the JAX package's: a checkpoint written by either
package recovers in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs import get_registry
from ..core.schema import Schema
from .deltas import DynamicEdge, DynamicTable
from .state import DynamicState
from .wal import MAGIC, read_records, wal_path

__all__ = [
    "RecoveryError", "RecoveryReport",
    "save_checkpoint", "load_checkpoint", "latest_checkpoint_lsn",
    "recover_state", "recover_scorer",
]

_FORMAT = 1


class RecoveryError(RuntimeError):
    """Unrecoverable inconsistency (e.g. an LSN gap between the newest
    valid checkpoint and the first WAL record after it)."""


@dataclasses.dataclass
class RecoveryReport:
    """What one recovery did — the evidence trail the tests assert on."""

    checkpoint_lsn: int          # 0 = no usable checkpoint (fresh state)
    recovered_lsn: int           # final data_version after tail replay
    replayed: int                # WAL records applied past the checkpoint
    tail_bytes_discarded: int    # torn/corrupt tail dropped at recovery
    checkpoints_skipped: int     # invalid checkpoints skipped (bit rot)
    replay_s: float


def _crc(path: str) -> int:
    with open(path, "rb") as f:
        return zlib.crc32(f.read())


def _fault_call(fault: Optional[Callable], point: str, **ctx):
    if fault is not None:
        fault(point, **ctx)


# ------------------------------------------------------------------- save --
def save_checkpoint(state: DynamicState, ckpt_dir: str, keep: int = 3,
                    fault: Optional[Callable] = None) -> str:
    """Atomically publish ``<ckpt_dir>/ckpt_<data_version>``.

    The snapshot is captured under ``state.lock`` (column/mask/id
    copies), so it is one consistent version even while a writer keeps
    applying.  Publication order — files, fsync, dir rename, ``LATEST``
    replace — means a crash at ANY point leaves either the previous
    checkpoint set intact or the new one fully visible; fault points
    (``ckpt.before_rename`` / ``ckpt.after_rename`` / ``ckpt.after``)
    let the tests die at each step and prove it.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    with state.lock:
        lsn = state.data_version
        jtv = state.jt_version
        cols = {t: {c: v.copy() for c, v in dt.columns.items()}
                for t, dt in state.tables.items()}
        live = {t: dt.live.copy() for t, dt in state.tables.items()}
        caps = {t: dt.capacity for t, dt in state.tables.items()}
        edges = []
        for key, e in state.edges.items():
            keys_mat = None
            if e.key_to_id:
                # insertion order IS the id order: row i of the matrix
                # is the key tuple with id i
                ordered = sorted(e.key_to_id.items(), key=lambda kv: kv[1])
                keys_mat = [np.asarray([k[j] for k, _ in ordered])
                            for j in range(len(e.key_cols))]
            edges.append({
                "tables": sorted(key),
                "key_cols": list(e.key_cols),
                "pair": e.tables,
                "keys": keys_mat,
                "ids": {t: a.copy() for t, a in e.ids.items()},
            })

    tmp = os.path.join(ckpt_dir, f".tmp_ckpt_{lsn}")
    final = os.path.join(ckpt_dir, f"ckpt_{lsn}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)

    def put(name: str, arr: np.ndarray):
        np.save(os.path.join(tmp, name + ".npy"), arr)
        return name + ".npy"

    files: Dict[str, int] = {}
    man_tables = {}
    for t, dt in cols.items():
        man_tables[t] = {"capacity": caps[t], "columns": sorted(dt)}
        for c, v in dt.items():
            files[put(f"t.{t}.{c}", v)] = 0
        files[put(f"t.{t}.live", live[t])] = 0
    man_edges = []
    for i, e in enumerate(edges):
        spec = {"tables": e["tables"], "key_cols": e["key_cols"],
                "pair": list(e["pair"]),
                "n_keys": 0 if e["keys"] is None else len(e["keys"][0])}
        if e["keys"] is not None:
            for j, kcol in enumerate(e["keys"]):
                files[put(f"e{i}.key{j}", kcol)] = 0
        for t, a in e["ids"].items():
            files[put(f"e{i}.ids.{t}", a)] = 0
        man_edges.append(spec)
    for name in files:
        files[name] = _crc(os.path.join(tmp, name))
    manifest = {"format": _FORMAT, "lsn": lsn, "jt_version": jtv,
                "tables": man_tables, "edges": man_edges, "files": files,
                "t_wall": time.time()}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    _fault_call(fault, "ckpt.before_rename", lsn=lsn)
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    _fault_call(fault, "ckpt.after_rename", lsn=lsn)
    latest_tmp = os.path.join(ckpt_dir, ".LATEST_tmp")
    with open(latest_tmp, "w") as f:
        f.write(str(lsn))
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    _fault_call(fault, "ckpt.after", lsn=lsn)
    _gc(ckpt_dir, keep)
    get_registry().counter("recovery.checkpoints").inc()
    return final


def _gc(ckpt_dir: str, keep: int):
    lsns = sorted(_all_lsns(ckpt_dir))
    for l in lsns[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"ckpt_{l}"),
                      ignore_errors=True)


def _all_lsns(ckpt_dir: str) -> List[int]:
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    return [int(d.split("_", 1)[1]) for d in names
            if d.startswith("ckpt_") and d.split("_", 1)[1].isdigit()]


def latest_checkpoint_lsn(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    try:
        with open(p) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


# ------------------------------------------------------------------- load --
def _load_one(schema: Schema, d: str) -> Tuple[DynamicState, int]:
    """Load one checkpoint dir (raises on any validation failure)."""
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    if man.get("format") != _FORMAT:
        raise RecoveryError(f"{d}: unknown checkpoint format {man.get('format')}")
    for name, crc in man["files"].items():
        p = os.path.join(d, name)
        if _crc(p) != crc:
            raise RecoveryError(f"{d}/{name}: checksum mismatch (bit rot)")

    def get(name: str) -> np.ndarray:
        return np.load(os.path.join(d, name + ".npy"))

    state = DynamicState.__new__(DynamicState)
    state.schema = schema
    state.tables = {}
    for t in schema.tables:
        spec = man["tables"][t.name]
        dt = DynamicTable.__new__(DynamicTable)
        dt.name = t.name
        dt.feature_columns = tuple(t.feature_columns)
        dt.capacity = spec["capacity"]
        dt.columns = {c: get(f"t.{t.name}.{c}") for c in spec["columns"]}
        dt.live = get(f"t.{t.name}.live").astype(bool)
        state.tables[t.name] = dt
    state.edges = {}
    for i, spec in enumerate(man["edges"]):
        e = DynamicEdge.__new__(DynamicEdge)
        e.key_cols = tuple(spec["key_cols"])
        e.tables = tuple(spec["pair"])
        e.ids = {t: get(f"e{i}.ids.{t}").astype(np.int32)
                 for t in spec["tables"]}
        e.versions = {t: 0 for t in spec["tables"]}
        e.key_to_id = {}
        if spec["n_keys"]:
            kcols = [get(f"e{i}.key{j}")
                     for j in range(len(spec["key_cols"]))]
            for kid, key in enumerate(zip(*kcols)):
                e.key_to_id[tuple(key)] = kid
        state.edges[frozenset(spec["tables"])] = e
    state.data_version = man["lsn"]
    state.jt_version = man["jt_version"]
    state._init_runtime()
    return state, man["lsn"]


def load_checkpoint(schema: Schema, ckpt_dir: str
                    ) -> Tuple[Optional[DynamicState], int, int]:
    """Newest VALID checkpoint → ``(state | None, lsn, skipped)``.

    Tries the ``LATEST`` pointer first, then every checkpoint dir
    newest-first; a checkpoint that fails validation (missing file, CRC
    mismatch, truncated manifest) is skipped — recovery falls back to
    an older one and replays a longer WAL tail instead.
    """
    candidates = sorted(set(_all_lsns(ckpt_dir)), reverse=True)
    latest = latest_checkpoint_lsn(ckpt_dir)
    if latest in candidates:                 # pointer first, then the rest
        candidates.remove(latest)
        candidates.insert(0, latest)
    skipped = 0
    for lsn in candidates:
        d = os.path.join(ckpt_dir, f"ckpt_{lsn}")
        try:
            state, at = _load_one(schema, d)
            return state, at, skipped
        except Exception:
            skipped += 1
    return None, 0, skipped


# ---------------------------------------------------------------- recover --
def _replay_tail(apply_fn, current_lsn: int, wal_dir: str
                 ) -> Tuple[int, int, int]:
    """Replay WAL records with lsn > current_lsn through ``apply_fn``.
    Returns (final_lsn, n_replayed, tail_bytes_discarded)."""
    path = wal_path(wal_dir)
    if not os.path.exists(path):
        return current_lsn, 0, 0
    size = os.path.getsize(path)
    if size < len(MAGIC):                    # crash at log creation
        return current_lsn, 0, size
    lsn = current_lsn
    n = 0
    end = len(MAGIC)
    for rec_lsn, deltas, _, off in read_records(path):
        end = off
        if rec_lsn == 0 or rec_lsn <= current_lsn:
            continue                         # heartbeat / pre-checkpoint
        if rec_lsn != lsn + 1:
            raise RecoveryError(
                f"WAL gap: checkpoint at {current_lsn}, replay reached "
                f"{lsn}, next record is {rec_lsn}")
        apply_fn(deltas)
        lsn = rec_lsn
        n += 1
    return lsn, n, max(0, size - end)


def recover_state(schema: Schema, wal_dir: str,
                  ckpt_dir: Optional[str] = None
                  ) -> Tuple[DynamicState, RecoveryReport]:
    """Newest valid checkpoint + WAL tail replay → a live state at the
    last durable LSN.  A torn/corrupt tail record is discarded (its
    version never committed durably); mid-log corruption raises
    :class:`~repro_torch.incremental.wal.WalCorruptError`."""
    t0 = time.perf_counter()
    state = None
    ckpt_lsn = 0
    skipped = 0
    if ckpt_dir is not None:
        state, ckpt_lsn, skipped = load_checkpoint(schema, ckpt_dir)
    if state is None:
        state = DynamicState(schema)
        ckpt_lsn = 0
    final, n, discarded = _replay_tail(state.apply, ckpt_lsn, wal_dir)
    rep = RecoveryReport(
        checkpoint_lsn=ckpt_lsn, recovered_lsn=final, replayed=n,
        tail_bytes_discarded=discarded, checkpoints_skipped=skipped,
        replay_s=time.perf_counter() - t0,
    )
    _note_metrics(rep)
    return state, rep


def recover_scorer(ens, wal_dir: str, ckpt_dir: Optional[str] = None,
                   **scorer_kw) -> Tuple["MaintainedScorer", RecoveryReport]:
    """Recover into a fresh serving view: a
    :class:`~repro_torch.incremental.maintain.MaintainedScorer` over ``ens``
    (compiled on the BASE schema — the t=0 schema the log started
    from), its dynamic state replaced by the recovered one, stacked
    leaf-mask factor rows re-evaluated for every recovered live slot
    (bit-identical to having maintained them all along — factor rows
    are pure per-row functions of current column values), and the WAL
    tail replayed through ``scorer.apply`` so factors track the replay.
    """
    from .maintain import MaintainedScorer

    t0 = time.perf_counter()
    ms = MaintainedScorer(ens, **scorer_kw)
    state = None
    ckpt_lsn = 0
    skipped = 0
    if ckpt_dir is not None:
        state, ckpt_lsn, skipped = load_checkpoint(ens.schema, ckpt_dir)
    if state is not None:
        ms.adopt_state(state)
    final, n, discarded = _replay_tail(ms.apply, ckpt_lsn, wal_dir)
    rep = RecoveryReport(
        checkpoint_lsn=ckpt_lsn, recovered_lsn=final, replayed=n,
        tail_bytes_discarded=discarded, checkpoints_skipped=skipped,
        replay_s=time.perf_counter() - t0,
    )
    _note_metrics(rep)
    return ms, rep


def recover_scorer_on_mesh(ens, ckpt_dir: str, mesh, **scorer_kw
                           ) -> Tuple["MaintainedScorer", int, int]:
    """The recovery of a replica sharded over a data mesh (``ens``
    compiled on it), each rank one process: rank 0 picks the newest valid
    checkpoint in ``ckpt_dir`` (none where the directory is not there),
    its LSN is broadcast, and every other rank loads that same checkpoint;
    no rank replays the log here.  The log past the checkpoint
    reaches every rank through a
    :class:`~repro_torch.incremental.wal.MeshFollower`'s rounds instead,
    rank 0 reading it and broadcasting its records, which every rank
    applies at the same points.  A replay on each rank
    (:func:`recover_scorer`'s) would stop wherever that rank found the end
    of a log the writer is still appending, and the collectives of the
    ranks' applies would then pair different records.  Returns (the
    scorer at the checkpoint's LSN, that LSN (0 without one), the
    checkpoints rank 0 skipped)."""
    from ..distributed import spmd
    from .maintain import MaintainedScorer

    with spmd.use_data_mesh(mesh):
        ms = MaintainedScorer(ens, **scorer_kw)
    state, lsn, skipped = None, 0, 0
    if mesh.rank == 0 and os.path.isdir(ckpt_dir):
        state, lsn, skipped = load_checkpoint(ens.schema, ckpt_dir)
    lsn, skipped = spmd.broadcast_object((lsn, skipped), mesh)
    if mesh.rank != 0 and lsn:
        state, _ = _load_one(ens.schema, os.path.join(ckpt_dir, f"ckpt_{lsn}"))
    if state is not None:
        ms.adopt_state(state)
    return ms, lsn, skipped


def _note_metrics(rep: RecoveryReport):
    reg = get_registry()
    reg.counter("recovery.runs").inc()
    reg.counter("recovery.replayed_records").inc(rep.replayed)
    reg.counter("recovery.tail_bytes_discarded").inc(rep.tail_bytes_discarded)
    reg.counter("recovery.checkpoints_skipped").inc(rep.checkpoints_skipped)
    reg.gauge("recovery.recovered_lsn").set(rep.recovered_lsn)
    reg.histogram("recovery.replay_ms").observe(rep.replay_s * 1e3)
