"""Durable write-ahead log of :class:`TableDelta` batches.

The dynamic store (:mod:`repro_torch.incremental.state`) keeps everything in
process memory: a crash loses every applied delta, and a serving
replica in another process has no way to observe the writer's stream.
This module gives the delta stream the durability story databases give
theirs (the machinery JoinBoost leans on, see PAPERS.md):

- :class:`WalWriter` — an append-only, length-prefixed,
  CRC32-checksummed log of encoded delta batches.  One record per
  applied batch; the record's LSN **is** the ``data_version`` the batch
  produced, so the log and the in-memory version counter can never
  disagree about what a version means.  ``fsync`` is batched
  (``sync_every`` records / ``sync_interval_s`` seconds) — the
  classic group-commit trade: bounded loss window, negligible
  per-append cost.
- :class:`WalReader` / :func:`read_records` — replay with torn-tail
  semantics: a short header, short payload, or CRC mismatch at the tail
  is *expected* after a crash (a record was mid-write) and cleanly ends
  the stream at the last valid LSN; the same corruption anywhere before
  the tail raises :class:`WalCorruptError` (bit rot, not a torn write).
- :class:`WalFollower` — a tailing reader on its own thread that drives
  a read-only replica (any ``apply(deltas)`` consumer, e.g. a
  :class:`~repro_torch.incremental.maintain.MaintainedScorer`) in another
  process than the writer.  A checksum-invalid tail is retried with
  jittered backoff (it is usually an in-flight append); the follower
  keeps serving its last applied version while the log lags or the
  writer dies — replication lag is exported for the SLO staleness
  objective to burn against (degraded, not dead).

Attachment: ``WalWriter.attach(state)`` sets ``state.wal``;
:meth:`DynamicState.apply` then logs every batch *under the existing
state lock*, after the mutations succeed and immediately before the
``data_version`` bump — so the log contains exactly the committed
versions, in order, and a concurrent snapshot can never observe a
version the log will not eventually carry.

Record layout (little-endian)::

    file   := magic(8B = b"RBRTWAL1") record*
    record := u32 payload_len | u32 crc32(payload) | payload
    payload: json header (lsn, wall time, array descriptors)
             + concatenated raw array bytes

Fault injection: every durability-relevant step calls
``fault(point, ...)`` on the injected :class:`FaultPlan`-like hook
(``tests/_faultfs.py``), which can raise ``CrashPoint`` — or tear an
append mid-buffer — to simulate process death at that exact point.

The byte format is the JAX package's, byte for byte: a log written by
either package replays in the other.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import get_registry
from ..runtime.fault import Backoff
from .deltas import TableDelta

__all__ = [
    "MAGIC", "WalCorruptError", "WalWriter", "WalReader", "WalFollower",
    "encode_record", "decode_record", "read_records", "scan_wal", "wal_path",
]

MAGIC = b"RBRTWAL1"
_HDR = struct.Struct("<II")              # payload_len, crc32


class WalCorruptError(RuntimeError):
    """Checksum/structure failure NOT at the tail — real corruption."""


def wal_path(wal_dir: str) -> str:
    return os.path.join(wal_dir, "wal.log")


# ------------------------------------------------------------------ codec --
def _arr_token(name: str, a: np.ndarray, blobs: List[bytes]) -> dict:
    a = np.ascontiguousarray(a)
    blobs.append(a.tobytes())
    return {"n": name, "d": a.dtype.str, "s": list(a.shape),
            "b": len(blobs[-1])}


def encode_record(lsn: int, deltas: Sequence[TableDelta],
                  t_wall: Optional[float] = None) -> bytes:
    """One applied batch → payload bytes (json header + raw arrays).

    The encoding is exact: dtypes and shapes round-trip bit-for-bit, so
    a replayed delta is indistinguishable from the original (the
    recovery bit-equality invariant depends on this).
    """
    if isinstance(deltas, TableDelta):
        deltas = [deltas]
    blobs: List[bytes] = []
    ds = []
    for d in deltas:
        ins = upd = dele = None
        if d.inserts:
            ins = [_arr_token(c, np.asarray(v), blobs)
                   for c, v in d.inserts.items()]
        if d.deletes is not None:
            dele = _arr_token("", np.asarray(d.deletes), blobs)
        if d.updates is not None:
            slots, cols = d.updates
            upd = {"slots": _arr_token("", np.asarray(slots), blobs),
                   "cols": [_arr_token(c, np.asarray(v), blobs)
                            for c, v in cols.items()]}
        ds.append({"t": d.table, "i": ins, "x": dele, "u": upd})
    head = json.dumps({
        "lsn": int(lsn),
        "tw": time.time() if t_wall is None else t_wall,
        "ds": ds,
    }).encode()
    return struct.pack("<I", len(head)) + head + b"".join(blobs)


def decode_record(payload: bytes) -> Tuple[int, List[TableDelta], float]:
    """Inverse of :func:`encode_record` → (lsn, deltas, wall time)."""
    (hlen,) = struct.unpack_from("<I", payload)
    head = json.loads(payload[4:4 + hlen].decode())
    off = 4 + hlen

    def take(tok) -> np.ndarray:
        nonlocal off
        a = np.frombuffer(payload[off:off + tok["b"]],
                          dtype=np.dtype(tok["d"])).reshape(tok["s"])
        off += tok["b"]
        return a.copy()                  # writable, detached from payload

    deltas = []
    for d in head["ds"]:
        inserts = ({t["n"]: take(t) for t in d["i"]}
                   if d["i"] is not None else None)
        deletes = take(d["x"]) if d["x"] is not None else None
        updates = None
        if d["u"] is not None:
            slots = take(d["u"]["slots"])
            updates = (slots, {t["n"]: take(t) for t in d["u"]["cols"]})
        deltas.append(TableDelta(table=d["t"], inserts=inserts,
                                 deletes=deletes, updates=updates))
    return int(head["lsn"]), deltas, float(head["tw"])


# ----------------------------------------------------------------- writer --
class WalWriter:
    """Append-only durable log, one record per applied delta batch.

    ``sync_every`` / ``sync_interval_s`` batch the fsync (group
    commit): an append is acknowledged once buffered to the OS; the
    durability horizon is the last sync.  ``sync_every=1`` gives
    per-record durability for the crash tests.  Thread-safe — appends
    normally arrive under ``state.lock`` already, but the writer keeps
    its own lock so direct use (e.g. the benchmarks) is safe too.

    ``fault`` is the fault-injection hook: called at each durability
    point (``append.before`` / ``append.write`` / ``append.after`` /
    ``sync.before`` / ``sync.after``) and may raise to simulate a
    crash; ``append.write`` additionally lets the plan tear the buffer
    (write a prefix, then die).
    """

    def __init__(self, wal_dir: str, sync_every: int = 8,
                 sync_interval_s: float = 0.05,
                 fault: Optional[Callable] = None, repair: bool = False):
        self.dir = wal_dir
        os.makedirs(wal_dir, exist_ok=True)
        self.path = wal_path(wal_dir)
        self.sync_every = max(1, int(sync_every))
        self.sync_interval_s = sync_interval_s
        self.fault = fault
        self._lock = threading.Lock()
        self._unsynced = 0
        self._last_sync = time.perf_counter()
        fresh = not os.path.exists(self.path) or os.path.getsize(self.path) == 0
        if fresh:
            with open(self.path, "ab") as f:
                f.write(MAGIC)
                f.flush()
                os.fsync(f.fileno())
        last, valid_end, size = scan_wal(self.path)
        if valid_end < size:
            # trailing bytes that don't checksum: a torn append from a
            # crashed writer.  Appending AFTER them would bury garbage
            # mid-log — repair (truncate at the last valid record) or
            # refuse, never continue past it.
            if not repair:
                raise WalCorruptError(
                    f"{self.path}: {size - valid_end} invalid tail bytes — "
                    f"recover first (repro_torch.incremental.recover) or open "
                    f"with repair=True to truncate them")
            with open(self.path, "r+b") as f:
                f.truncate(valid_end)
                if valid_end < len(MAGIC):   # torn file header: restart file
                    f.truncate(0)
                    f.seek(0)
                    f.write(MAGIC)
                f.flush()
                os.fsync(f.fileno())
            get_registry().counter("wal.tail_bytes_discarded").inc(
                size - valid_end)
        self._f = open(self.path, "ab")
        self.last_lsn = last
        self.synced_lsn = self.last_lsn
        reg = get_registry()
        self._c_appends = reg.counter("wal.appends")
        self._c_syncs = reg.counter("wal.syncs")
        self._h_append_ms = reg.histogram("wal.append_ms")
        self._g_synced = reg.gauge("wal.synced_lsn")
        self._g_synced.set(self.synced_lsn)

    def _fault(self, point: str, **ctx):
        if self.fault is not None:
            self.fault(point, **ctx)

    # ------------------------------------------------------------- append --
    def append(self, lsn: int, deltas: Sequence[TableDelta]) -> int:
        """Log one batch as ``lsn`` (must be ``last_lsn + 1``).  Returns
        the byte offset of the record's end."""
        t0 = time.perf_counter()
        with self._lock:
            if lsn != self.last_lsn + 1:
                raise ValueError(
                    f"non-monotonic append: lsn {lsn} after {self.last_lsn}")
            payload = encode_record(lsn, deltas)
            buf = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
            self._fault("append.before", lsn=lsn)
            torn = None
            if self.fault is not None:
                torn = self.fault("append.write", lsn=lsn, buf=buf)
            if torn is not None:                 # injected torn write
                self._f.write(buf[:torn])
                self._f.flush()
                os.fsync(self._f.fileno())
                raise _crashpoint(f"torn append at lsn {lsn} ({torn} bytes)")
            self._f.write(buf)
            self._f.flush()                      # to the OS, not the disk
            self.last_lsn = lsn
            self._unsynced += 1
            self._fault("append.after", lsn=lsn)
            now = time.perf_counter()
            if (self._unsynced >= self.sync_every
                    or now - self._last_sync >= self.sync_interval_s):
                self._sync_locked()
            end = self._f.tell()
        self._c_appends.inc()
        self._h_append_ms.observe((time.perf_counter() - t0) * 1e3)
        return end

    def sync(self) -> int:
        """Force-fsync the log; returns the durable LSN."""
        with self._lock:
            self._sync_locked()
            return self.synced_lsn

    def heartbeat(self) -> None:
        """Append a liveness marker (LSN 0, no deltas) and sync it.

        Followers use record wall times to judge writer liveness; an
        idle-but-alive writer heartbeats so its replicas can tell
        "nothing to replicate" apart from "writer died" and degrade
        only in the second case."""
        with self._lock:
            payload = encode_record(0, [])
            buf = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
            self._f.write(buf)
            self._f.flush()
            self._sync_locked()

    def _sync_locked(self):
        self._fault("sync.before", lsn=self.last_lsn)
        os.fsync(self._f.fileno())
        self.synced_lsn = self.last_lsn
        self._unsynced = 0
        self._last_sync = time.perf_counter()
        self._fault("sync.after", lsn=self.last_lsn)
        self._c_syncs.inc()
        self._g_synced.set(self.synced_lsn)

    def close(self):
        with self._lock:
            if not self._f.closed:
                os.fsync(self._f.fileno())
                self._f.close()

    # --------------------------------------------------------- attachment --
    def attach(self, state) -> "WalWriter":
        """Hook this log into a :class:`DynamicState`: every ``apply``
        appends its batch (under ``state.lock``, post-mutation,
        pre-version-bump) with ``lsn == the new data_version``."""
        if state.data_version != self.last_lsn:
            raise ValueError(
                f"state at data_version {state.data_version} but log ends "
                f"at lsn {self.last_lsn} — recover first, then attach")
        state.wal = self
        return self


def _crashpoint(msg: str):
    """Late import so src/ never depends on tests/: the torn-write path
    only runs under injection, where tests/_faultfs is importable."""
    try:
        from _faultfs import CrashPoint          # type: ignore
        return CrashPoint(msg)
    except ImportError:                          # pragma: no cover
        return RuntimeError(msg)


# ----------------------------------------------------------------- reader --
def read_records(path: str, start_offset: int = 0
                 ) -> Iterator[Tuple[int, List[TableDelta], float, int]]:
    """Yield ``(lsn, deltas, t_wall, end_offset)`` for every valid record.

    Ends cleanly at a torn/truncated/corrupt TAIL record (the crash
    signature); raises :class:`WalCorruptError` if a corrupt record is
    followed by more bytes that parse — that is mid-log damage replay
    must not silently skip.
    """
    with open(path, "rb") as f:
        if start_offset:
            f.seek(start_offset)
        else:
            magic = f.read(len(MAGIC))
            if len(magic) < len(MAGIC):
                return                    # torn file header (crash at create)
            if magic != MAGIC:
                raise WalCorruptError(f"{path}: bad magic {magic!r}")
        pending_err: Optional[str] = None
        while True:
            hdr = f.read(_HDR.size)
            if not hdr:
                return                        # clean EOF
            if len(hdr) < _HDR.size:
                return                        # torn header at tail
            plen, crc = _HDR.unpack(hdr)
            payload = f.read(plen)
            if len(payload) < plen:
                return                        # torn payload at tail
            if zlib.crc32(payload) != crc:
                # only a tail record may be invalid; probe for more data
                if f.read(1):
                    raise WalCorruptError(
                        f"{path}: checksum failure before EOF "
                        f"(mid-log corruption)")
                return
            try:
                lsn, deltas, tw = decode_record(payload)
            except Exception as e:            # valid CRC, bad structure
                raise WalCorruptError(f"{path}: undecodable record: {e}")
            yield lsn, deltas, tw, f.tell()


def scan_wal(path: str) -> Tuple[int, int, int]:
    """Walk the whole log → ``(last_lsn, valid_end_offset, file_size)``.

    ``last_lsn`` is the newest delta record's LSN (heartbeats ignored);
    ``valid_end_offset`` is where the last checksum-valid record ends —
    anything between it and ``file_size`` is a torn/corrupt tail.
    Raises :class:`WalCorruptError` on mid-log damage.
    """
    size = os.path.getsize(path)
    if size < len(MAGIC):
        return 0, 0, size                # torn at creation: no valid prefix
    last = 0
    end = len(MAGIC)
    for lsn, _, _, off in read_records(path):
        if lsn:
            last = lsn
        end = off
    return last, end, os.path.getsize(path)


class WalReader:
    """Stateful tail-reader over one log file (follower building block).

    :meth:`poll` yields any NEW complete, checksum-valid records past
    the last read offset and remembers where it stopped; an invalid
    tail is left un-consumed (the writer may still be appending it) and
    simply yields nothing this round.
    """

    def __init__(self, wal_dir: str):
        self.path = wal_path(wal_dir)
        self.offset = 0
        self.last_lsn = 0

    def poll(self) -> List[Tuple[int, List[TableDelta], float]]:
        if not os.path.exists(self.path):
            return []
        if self.offset == 0:
            with open(self.path, "rb") as f:
                magic = f.read(len(MAGIC))
            if len(magic) < len(MAGIC):
                return []                     # header mid-write
            if magic != MAGIC:
                raise WalCorruptError(f"{self.path}: bad magic {magic!r}")
            self.offset = len(MAGIC)
        out = []
        for lsn, deltas, tw, end in read_records(self.path, self.offset):
            if lsn:                              # lsn 0 = heartbeat
                if self.last_lsn and lsn != self.last_lsn + 1:
                    raise WalCorruptError(
                        f"{self.path}: lsn gap {self.last_lsn} → {lsn}")
                self.last_lsn = lsn
            self.offset = end
            out.append((lsn, deltas, tw))
        return out


# --------------------------------------------------------------- follower --
class WalFollower:
    """Tail a writer's log from another process and drive a replica.

    ``apply_fn(deltas)`` is called once per record, in LSN order —
    typically ``MaintainedScorer.apply`` on a read-only replica.  The
    loop polls at ``poll_interval_s`` and, when a poll errors (an
    in-flight append read mid-write, a transient IO failure), retries
    with the jittered :class:`~repro_torch.runtime.fault.Backoff` rather than
    tearing the replica down.

    Liveness: ``replication_lag_s()`` is the age of the newest record
    the replica has NOT yet applied (0 while caught up).  While the
    writer is down the log stops growing, the lag reads 0 once drained,
    and ``writer_idle_s()`` grows instead — the serving CLI feeds
    ``max(scorer staleness, replication lag)`` to its staleness
    objective, so a dead writer degrades the replica (serve stale) but
    never kills it.
    """

    def __init__(self, wal_dir: str, apply_fn: Callable, start_lsn: int = 0,
                 poll_interval_s: float = 0.01,
                 backoff: Optional[Backoff] = None):
        self.reader = WalReader(wal_dir)
        self.apply_fn = apply_fn
        self.start_lsn = start_lsn
        self.poll_interval_s = poll_interval_s
        self.backoff = backoff if backoff is not None else Backoff(
            base_s=0.01, cap_s=0.5, budget_s=30.0)
        self.applied_lsn = start_lsn
        self._pending = False            # undrained bytes past the offset
        self._last_record_wall = None    # wall time of newest seen record
        self._t_started = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        reg = get_registry()
        self._c_applied = reg.counter("wal.follower.applied")
        self._c_retries = reg.counter("wal.follower.retries")
        self._g_lag = reg.gauge("wal.follower.lag_s")
        self._g_lsn = reg.gauge("wal.follower.applied_lsn")
        self.apply_lag_s = reg.histogram("wal.follower.apply_lag_s")

    # -------------------------------------------------------------- status --
    def replication_lag_s(self) -> float:
        """Seconds the replica trails the newest durable record: 0 when
        fully caught up (including a dead writer whose drained log has
        simply stopped growing); while bytes sit unread past our offset
        the lag is approximated by time since the last applied record
        (the pending record's own timestamp is unreadable until its
        write completes)."""
        if not self._pending:
            return 0.0
        base = self._last_record_wall
        return max(0.0, time.time() - (base if base is not None
                                       else self._t_started))

    def writer_idle_s(self) -> float:
        """Seconds since the writer last wrote ANYTHING (delta record or
        heartbeat) — the liveness signal: growth past the writer's
        heartbeat cadence means it likely died.  0 before any record."""
        if self._last_record_wall is None:
            return 0.0
        return max(0.0, time.time() - self._last_record_wall)

    # ------------------------------------------------------------ tail loop --
    def step(self) -> int:
        """One poll+apply round (also the synchronous test surface).
        Returns the number of records applied."""
        records = self.reader.poll()
        n = 0
        for lsn, deltas, tw in records:
            self._last_record_wall = max(self._last_record_wall or tw, tw)
            if lsn == 0 or lsn <= self.start_lsn:
                continue                 # heartbeat / below the checkpoint
            if lsn != self.applied_lsn + 1:
                raise WalCorruptError(
                    f"follower lsn gap: {self.applied_lsn} → {lsn}")
            self.apply_fn(deltas)
            self.applied_lsn = lsn
            self.apply_lag_s.observe(max(0.0, time.time() - tw))
            self._c_applied.inc()
            n += 1
        try:                             # undrained tail (e.g. mid-write)?
            size = os.path.getsize(self.reader.path)
        except OSError:
            size = self.reader.offset
        self._pending = size > self.reader.offset
        self._g_lag.set(self.replication_lag_s())
        self._g_lsn.set(self.applied_lsn)
        return n

    def _run(self):
        retry = self.backoff.clone()
        while not self._stop.is_set():
            try:
                self.step()
                retry.reset()
                self._stop.wait(self.poll_interval_s)
            except WalCorruptError:
                # possibly an append observed mid-write; back off and
                # re-poll — if it never heals the budget expires
                self._c_retries.inc()
                try:
                    delay = retry.next_delay()
                except RuntimeError as e:
                    self.error = e
                    return
                self._stop.wait(delay)
            except BaseException as e:   # replica apply blew up: stop
                self.error = e
                return

    def start(self) -> "WalFollower":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True):
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
        if drain and self.error is None:
            self.step()                  # pick up the final records
        if self.error is not None:
            raise self.error
