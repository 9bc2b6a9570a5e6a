"""Durable store backend: a file write-ahead log behind the storage boundary.

A copy of ``minisched_tpu/controlplane/durable.py`` over the port's
``ObjectStore``.  The reference's L0 is a real etcd process
(hack/etcd.sh:26-44; k8sapiserver.go:93-105 wires the apiserver's
storage to it): every write is durable before the API call returns, and
restarting the process recovers the cluster.  ``DurableObjectStore``
appends one framed JSON record per mutation to a WAL before the call
returns (``walio``: length + CRC frames, byte for byte JAX's), and
re-opening the same path replays the log.  ``compact()`` is etcd's
snapshot and compaction in miniature: the live state lands in
``<path>.ckpt`` (atomic replace, sha256 sidecar, one previous generation
kept as ``.prev``) and the WAL truncates, so recovery is checkpoint ⊕
WAL tail.  A WAL and checkpoint written by the JAX package's store open
here, and the reverse (``checkpoint``'s codec writes JAX's bytes).

What it keeps of JAX's, each as JAX has it:

* group commit: a mutation validates and reserves its rv under a short
  lock hold, stages its frame and parks on a commit barrier; a
  leader-elected caller writes the whole stage in one write (+ one fsync
  when armed), then publishes in rv order.  ``MINISCHED_GROUP_COMMIT=0``
  is the kill-switch (the per-mutation path) and
  ``MINISCHED_FSYNC_FLOOR_US`` a floor on every fsync's duration, both
  read at construction;
* degraded read-only mode: an append failure (ENOSPC/EIO) refuses every
  later mutation with ``StorageDegraded`` before it touches memory, reads
  keep serving, and a rate-limited recovery probe re-arms writes;
* replay with rv-skip below the checkpoint, the history floor at the
  checkpoint's rv, ``salvage="covered"``, and the checkpoint fallback
  chain (current, then ``.prev``, then a full replay with the archive);
* ``archive_compacted`` (``<path>.history``), ``scrub()`` and
  ``start_scrub()``, ``storage_stats()``, ``wal_end()``;
* the volatile ``ack`` and shard ``lease`` records (``record_acks``,
  ``recovered_acks``, ``record_shard_lease``,
  ``recovered_shard_leases``), which a WAL may hold and replay accepts;
* the fault fabric's disk points (``wal.append``, ``disk.enospc``,
  ``wal.bitflip``, ``wal.torn_mid``, ``ckpt.corrupt``), read off
  ``self.faults`` (a ``faults.FaultFabric``, None unless armed), as are
  the replication plane's ``repl.ship`` and ``repl.ack``.

Where the port differs: uids come from the store's own sequence
(``ObjectStore._uid_seq``), so recovery floors that sequence past every
recovered uid and the checkpoint's ``uid_floor``, and compaction writes
the sequence's top as ``uid_floor``.  The port's ``_fanout`` takes a list
of events.

The replication half (JAX ``:1867-2114``): ``wal_range_crc32c``,
``promote_leader``, ``fence``, ``checkpoint_ship_blob``,
``apply_replicated`` (``_apply``'s ``collect`` sink fans a shipped
group into live watchers) and ``replica_reset``; the checkpoint
generation counter a leader's compaction publishes (the hub's
``rebase``); and the group-commit barrier's quorum wait on the attached
``repl.ReplicationHub`` (``storage.quorum_wait_s``; on timeout the group
is truncated off the WAL, the hub ``retract``s and every waiter gets a
typed ``ETIMEDOUT`` under ``StorageDegraded``).  A fenced store (a
follower, or a leader that lost its arbiter majority) refuses writes
with ``NotLeader``.

A sharded façade's ``shards.ShardRuntime`` points its ``ShardInfo``'s
lease journal at ``record_shard_lease`` and re-arms the leases
``recovered_shard_leases`` returns (``ShardInfo.adopt_leases``), so a
replica restarted inside a split's freeze keeps refusing until the TTL.
"""

from __future__ import annotations

import errno
import hashlib
import json
import os
import threading
import time
from contextlib import nullcontext as _null_ctx
from typing import Any, Dict, Optional

from minisched_tpu_torch.controlplane.checkpoint import (
    CHECKPOINT_VERSION,
    KIND_TYPES,
    _decode,
    _encode,
    build_snapshot_doc,
)
from minisched_tpu_torch.controlplane.store import (
    DEFAULT_HISTORY_BYTES,
    DEFAULT_HISTORY_EVENTS,
    Conflict,
    EventType,
    NotLeader,
    ObjectStore,
    StorageDegraded,
    WatchEvent,
    compute_node_agg,
)
from minisched_tpu_torch.controlplane.walio import (
    HEADER_SIZE,
    WalCorrupt,
    WalReader,
    _rec_rv,
    decode_group,
    encode_frame,
    group_crc32c,
    resync_scan,
    scan_file,
)
from minisched_tpu_torch.observability import counters, hist


class CheckpointCorrupt(Exception):
    """Every arm of the checkpoint fallback chain failed AND no archived
    history exists to rebuild from — recovery would be silently partial
    (the WAL holds only the post-compaction tail).  Refused loudly; the
    operator decides (restore a checkpoint, or accept the loss by
    deleting the artifacts)."""


#: ack records replayed from the WAL are bounded the same way as the
#: HTTP façade's in-memory registry (oldest evicted first)
ACK_REPLAY_CAP = 65536

#: sha256 sidecar suffix for checkpoint files
CKPT_DIGEST_SUFFIX = ".sha256"

#: overlay marker for a staged-but-unpublished DELETE (see _gc_pending)
_GC_TOMB = object()


class _GroupEntry:
    """One staged mutation (or one staged batch) awaiting its group's
    commit barrier.  ``frames`` is the already-encoded WAL byte stream
    for the entry — (frame bytes, payload length) pairs, the length kept
    so the leader can mirror ``_append_raw``'s fault-injection offsets.
    ``publish``/``undo`` run under the store lock: publish applies the
    in-memory commit + watch fanout after the group's IO landed; undo
    reverts the reservation-time effects (overlay entry, node-aggregate
    deltas) when the group's IO failed.  ``done``/``err`` are guarded by
    the store's group-commit condition."""

    __slots__ = (
        "frames", "publish", "undo", "result", "key", "kind", "done", "err"
    )

    def __init__(self, frames, publish, undo, result, key="", kind=""):
        self.frames = frames
        self.publish = publish
        self.undo = undo
        self.result = result
        self.key = key
        #: the object kind this entry mutates — the group's publish loop
        #: swaps the COW read snapshot once per distinct kind
        self.kind = kind
        self.done = False
        self.err = None


def _uid_suffix(uid: str) -> int:
    """Numeric tail of a generated uid ('pod-00000018' → 18); 0 for
    foreign and empty uids (JAX ``api/objects.py:54``)."""
    tail = uid.rsplit("-", 1)[-1] if uid else ""
    return int(tail) if tail.isdigit() else 0


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def checkpoint_digest(path: str, data: Optional[bytes] = None) -> dict:
    """Sidecar verdict for one checkpoint file, shared by the restore
    chain, the live scrub, and offline fsck (one parser for the sidecar
    format, so the reserved algorithm byte can't drift three ways):
    ``{"ok": True/False/None, "want": sidecar hex, "got": file hex}``;
    ``ok=None`` means no sidecar (a pre-integrity generation)."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    got = _sha256_hex(data)
    sidecar = path + CKPT_DIGEST_SUFFIX
    if not os.path.exists(sidecar):
        return {"ok": None, "want": "", "got": got}
    with open(sidecar, encoding="utf-8") as f:
        fields = f.read().strip().split()
    want = fields[-1] if fields else ""
    return {"ok": got == want, "want": want, "got": got}


class DurableObjectStore(ObjectStore):
    """ObjectStore whose mutations are logged to ``path`` before committing.

    ``fsync=True`` makes every append an fsync (etcd-grade durability at
    file-IO cost); the default flushes to the OS, surviving process death
    but not host power loss — the right trade for the simulator.

    ``checkpoint_path`` (default ``<path>.ckpt``) holds the compaction
    snapshot; ``archive_compacted=True`` appends every truncated WAL
    segment to ``<path>.history`` first, so the FULL mutation history
    stays auditable (faults.wal_double_binds) across compactions — and
    the checkpoint fallback chain can rebuild from scratch.

    ``salvage`` is the mid-file corruption policy at replay: ``"off"``
    (default) hard-fails with a precise WalCorrupt report; ``"covered"``
    truncates at the first bad frame when the checkpoint covers the
    loss (every decodable lost record has rv ≤ the restored snapshot's).

    ``readonly=True`` replays without opening the append log, without
    truncating torn tails, and with every mutation refused — the fsck
    CLI's view of the artifacts.
    """

    def __init__(
        self,
        path: str,
        fsync: bool = False,
        checkpoint_path: Optional[str] = None,
        archive_compacted: bool = False,
        history_events: int = DEFAULT_HISTORY_EVENTS,
        history_bytes: int = DEFAULT_HISTORY_BYTES,
        salvage: str = "off",
        readonly: bool = False,
        probe_interval_s: float = 0.25,
    ):
        if salvage not in ("off", "covered"):
            raise ValueError(f"salvage must be 'off' or 'covered', got {salvage!r}")
        super().__init__(
            history_events=history_events, history_bytes=history_bytes
        )
        self._path = path
        self._ckpt_path = checkpoint_path or path + ".ckpt"
        self._archive = archive_compacted
        self._fsync = fsync
        # slow-disk emulation: a FLOOR on every fsync's duration, in
        # microseconds (MINISCHED_FSYNC_FLOOR_US; 0 = real device).
        # The bench `wal` role arms it for BOTH its phases so the
        # group-commit comparison models a disk whose durability
        # barrier actually costs something — tmpfs/virtio fsyncs are
        # near-free, which would hide any fsync-coalescing win.
        try:
            self._fsync_floor_s = (
                float(os.environ.get("MINISCHED_FSYNC_FLOOR_US", "0")) / 1e6
            )
        except ValueError:
            self._fsync_floor_s = 0.0
        self._salvage = salvage
        self._readonly = readonly
        self._closed = False
        self._defer_flush = False  # batch mutations share one fsync
        self._log = None  # replay must not re-log
        self._ckpt_rv = 0  # WAL records at/below this are pre-snapshot
        self._ckpt_gen = 0  # checkpoint GENERATION counter (repl shipping)
        self._ckpt_source = "none"  # current | prev | replay | none
        #: binding acks recovered from WAL ``ack`` records (insertion
        #: order == append order; the HTTP façade seeds its registry
        #: from this so retried batches stay idempotent across restarts)
        self._acks: Dict[str, dict] = {}
        #: shard freeze leases recovered from WAL ``lease`` records
        #: (DESIGN.md §31): ns → lease doc; the façade re-arms its
        #: ShardInfo from these so a restart inside a split's freeze
        #: window keeps refusing the namespace until the lease TTL
        self._shard_leases: Dict[str, dict] = {}
        # -- degraded-mode state (all guarded by the store lock) --------
        self._degraded = False
        self._degraded_reason = ""
        self._degraded_since = 0.0
        self._degraded_seconds_total = 0.0
        self._degraded_episodes = 0
        self._probe_interval_s = probe_interval_s
        self._last_probe = 0.0
        self._scrub_stop: Optional[threading.Event] = None
        self._scrub_thread: Optional[threading.Thread] = None
        # -- group commit (off-lock durability pipeline) ----------------
        # A mutation validates + reserves its rv under a short store-lock
        # hold, stages its framed record, releases the lock, and blocks
        # on the commit barrier: a leader-elected caller drains the
        # stage under _io_lock, writes every pending frame in ONE
        # buffered write (+ one fsync when armed), then publishes the
        # group — in-memory apply + watch fanout in strict rv order —
        # and only then are the waiters acked.  Lock order everywhere:
        # _io_lock → store lock → _gc_cond.  MINISCHED_GROUP_COMMIT=0
        # is the kill-switch restoring the exact per-mutation path.
        self._gc_enabled = (not readonly) and os.environ.get(
            "MINISCHED_GROUP_COMMIT", "1"
        ) != "0"
        self._io_lock = threading.Lock()  # physical WAL IO (leader, acks,
        # compaction, recovery probes) — NEVER taken while holding the
        # store lock, except non-blocking (probe)
        self._gc_cond = threading.Condition()
        self._gc_stage: list = []  # staged _GroupEntry, rv order
        self._gc_leading = False  # exactly one leader at a time
        #: (kind, key) → (token, staged object | _GC_TOMB): the state a
        #: reservation produced but the barrier has not published yet.
        #: Validators resolve "current" through this overlay so two
        #: concurrent creates of one key (or a CAS against a staged rv)
        #: are decided under the reservation lock, not at the barrier.
        self._gc_pending: Dict[tuple, tuple] = {}
        self._gc_token = 0
        self._gc_visible_rv = 0  # highest PUBLISHED rv (≤ _rv while staged)
        # -- replication (DESIGN.md §27) -----------------------------------
        # When a ReplicationHub is attached (controlplane/repl.py, gated
        # by MINISCHED_REPL), the group-commit barrier ALSO waits for a
        # follower quorum between its fsync and its publish; a fenced
        # replica (follower / demoted ex-leader) refuses mutations typed
        # (NotLeader) so only one history can ever accept acks.
        self._repl_hub = None
        self._fenced = False
        self._leader_hint = ""
        #: (end, seconds) of the last compaction: the next one waits out
        #: that long after it ends (compact())
        self._last_compact = (0.0, 0.0)
        t0 = time.monotonic()
        self._replay()
        #: seconds this open spent in recovery (checkpoint ⊕ WAL replay);
        #: the port's own addition, for the recovery wall
        self.replay_s = time.monotonic() - t0
        self._gc_visible_rv = self._rv
        # the replay wrote _objects directly: publish the recovered state
        # to the COW read plane (all kinds, correct rv in either mode)
        self._cow_publish(tuple(self._objects))
        if readonly:
            self._closed = True  # mutations refused; reads keep serving
        else:
            # unbuffered binary appends: every frame is ONE write() that
            # hits the OS immediately, so ENOSPC/EIO surfaces on the
            # failing record itself (pre-commit — store.py orders the
            # append before the in-memory insert), not on a later flush
            # after a whole batch already committed
            self._log = open(self._path, "ab", buffering=0)

    # -- logging -----------------------------------------------------------
    @staticmethod
    def _loggable(kind: str) -> bool:
        # only kinds the checkpoint codec can decode are durable; volatile
        # kinds (Events, and any future unregistered kind) stay in-memory —
        # logging them would make the WAL unopenable at replay
        return kind in KIND_TYPES

    def _check_open(self) -> None:
        """Refuse mutations on a closed store BEFORE touching in-memory
        state — mutating first would fan watch events out to live
        informers and only then fail the append, leaving observers and the
        reopened WAL permanently divergent."""
        if self._closed:
            raise RuntimeError(
                f"durable store {self._path!r} is closed; mutation refused"
            )

    def _check_wal_writable(self, kind: str) -> None:
        """Gate every mutation on the WAL being writable.  Two layers:
        the degraded latch (a previous append hit ENOSPC/EIO — probe for
        recovery, else refuse with the typed StorageDegraded), and the
        ``wal.append`` injection point (faults.FaultFabric), which
        surfaces as a failed API call.  Both fire BEFORE the in-memory
        commit; the append itself is ALSO pre-commit (store.py), so even
        a first-time disk failure never leaves memory ahead of disk.

        A third layer when replication is wired: a FENCED replica (one
        consuming the leader's stream, or an ex-leader that lost its
        arbiter majority) refuses every client mutation typed — its WAL
        belongs to the leader's byte sequence and a local write would
        fork it.  Reads keep serving (stale-bounded by replication
        lag)."""
        if self._fenced:
            counters.inc("storage.repl.fenced_writes")
            hint = f" (leader: {self._leader_hint})" if self._leader_hint \
                else ""
            raise NotLeader(
                f"store {self._path!r} is not leader{hint}; write refused"
            )
        if self._degraded:
            self._maybe_probe_recovery()
            if self._degraded:
                raise StorageDegraded(
                    f"durable store {self._path!r} is read-only "
                    f"(degraded: {self._degraded_reason})"
                )
        faults = self.faults
        if faults is not None and self._loggable(kind):
            faults.check("wal.append", kind)

    def _enter_degraded(self, err: BaseException) -> None:
        if not self._degraded:
            self._degraded = True
            self._degraded_reason = str(err)
            self._degraded_since = time.monotonic()
            self._degraded_episodes += 1
            counters.inc("storage.degraded_enter")

    def _exit_degraded(self) -> None:
        if self._degraded:
            self._degraded = False
            self._degraded_seconds_total += (
                time.monotonic() - self._degraded_since
            )
            self._degraded_reason = ""
            counters.inc("storage.degraded_recovered")

    def _maybe_probe_recovery(self) -> None:
        """Rate-limited write probe while degraded: append a bare rv
        watermark (harmless at replay — it carries the counter the store
        already holds).  Success means the disk came back (space freed,
        IO error cleared) — re-arm writes; failure re-stamps the latch.
        Called with the lock held, from the mutation gate and the scrub
        loop, so recovery needs no operator action."""
        now = time.monotonic()
        if self._log is None or now - self._last_probe < self._probe_interval_s:
            return
        if self._gc_enabled:
            # lock order is io → store and the caller already holds the
            # store lock: probe only when the IO lock is FREE (non-
            # blocking try) — a busy leader's own append outcome re-arms
            # or re-stamps the latch anyway, so a skipped tick is safe
            if not self._io_lock.acquire(blocking=False):
                return
            try:
                self._probe_once(now)
            finally:
                self._io_lock.release()
        else:
            self._probe_once(now)

    def _probe_once(self, now: float) -> None:
        self._last_probe = now
        counters.inc("storage.recovery_probe")
        try:
            self._append_raw({"op": "rv", "rv": self._rv}, probing=True)
        except (OSError, StorageDegraded) as e:
            self._degraded_reason = str(e)
            return
        self._exit_degraded()

    def _append(self, rec: dict) -> None:
        if self._log is None:
            return  # replay: the record being applied is already in the log
        self._append_raw(rec)

    def _append_raw(self, rec: dict, probing: bool = False,
                    ship: bool = True) -> None:
        """Frame and write one record.  The fault fabric's disk points
        live here — AFTER the JSON encode, so the schedule keys on real
        appends:

        ``disk.enospc``  the write fails (OSError) → degraded latch +
                         StorageDegraded to the caller, pre-commit
        ``wal.bitflip``  the write SUCCEEDS but a bit flipped inside the
                         payload after the CRC was computed — the lying
                         disk; memory and every observer proceed, replay
                         and fsck must detect it
        ``wal.torn_mid`` only a prefix of the frame reaches the file and
                         later appends bury it — a torn write replay
                         must locate, not JSONDecodeError past

        ``ship=False`` leaves the replication hub's horizon where it is:
        a caller appending many records advances it once at the end (the
        port's own; see ``record_acks``).
        """
        payload = json.dumps(rec).encode()
        frame = encode_frame(payload)
        faults = self.faults
        if faults is not None:
            # disk.enospc fires for recovery PROBES too: a full disk
            # stays full until the schedule's max_fires "frees space",
            # so an injected episode has real dwell time instead of
            # ending at the first probe tick
            if faults.should_fire("disk.enospc", self._path):
                err = OSError(
                    errno.ENOSPC, "injected: no space left on device"
                )
                self._enter_degraded(err)
                counters.inc("storage.append_error")
                raise StorageDegraded(
                    f"WAL append failed: {err}"
                ) from err
        if faults is not None and not probing:
            if faults.should_fire("wal.bitflip", self._path):
                buf = bytearray(frame)
                buf[HEADER_SIZE + len(payload) // 2] ^= 0x01
                frame = bytes(buf)
                counters.inc("storage.bitflip_injected")
            elif faults.should_fire("wal.torn_mid", self._path):
                frame = frame[: HEADER_SIZE + max(len(payload) // 2, 1)]
                counters.inc("storage.torn_injected")
        try:
            pre_end = self._log.tell()  # append mode: current EOF
        except OSError:
            pre_end = None
        try:
            t0 = time.monotonic()
            n = self._log.write(frame)
            if n is not None and n != len(frame):
                # a SHORT raw write is how a filling disk often says
                # ENOSPC without raising: the record did NOT land —
                # latch degraded, refuse (the partial bytes are cut
                # below so recovery probes never append after garbage)
                raise OSError(
                    errno.ENOSPC,
                    f"short WAL write ({n}/{len(frame)} bytes)",
                )
            if not self._defer_flush and self._fsync:
                self._fsync_now()
            hist.observe("storage.wal_append_s", time.monotonic() - t0)
        except OSError as e:
            if pre_end is not None:
                # a failed/short write may have left a PARTIAL frame at
                # EOF; truncating back (truncate-to-smaller needs no new
                # blocks, so it works on a full disk) keeps the tail
                # clean — otherwise the recovery probe's next append
                # would bury the garbage mid-file and the following
                # restart would refuse the whole WAL as corrupt
                try:
                    self._log.truncate(pre_end)
                except OSError:
                    pass  # garbage stays; replay's detection owns it
            self._enter_degraded(e)
            counters.inc("storage.append_error")
            raise StorageDegraded(f"WAL append failed: {e}") from e
        hub = self._repl_hub
        if hub is not None and ship:
            # non-group bytes (rv watermarks, ack records, recovery
            # probes) advance the shippable horizon too — followers tail
            # them as raw catch-up chunks; they carry no client-visible
            # promise, so no quorum is owed on them
            try:
                hub.advance(self._log.tell())
            except OSError:
                pass
        if self._degraded and probing is False:
            # an organic append succeeded while latched (shouldn't happen
            # — the gate refuses first — but never strand the latch)
            self._exit_degraded()

    # -- group commit (the off-lock durability pipeline) -------------------
    def _visible_rv(self) -> int:
        """Published rv for snapshot stamps (caller holds the store
        lock): while mutations are staged, ``_rv`` runs ahead of what
        the maps (and any watcher) can see — stamping it on a watch or
        list_with_rv would promise events that were never delivered."""
        if self._gc_enabled:
            return self._gc_visible_rv
        return self._rv

    def _gc_frame(self, rec: dict) -> tuple:
        payload = json.dumps(rec).encode()
        return (encode_frame(payload), len(payload))

    def _gc_frame_put(self, kind: str, stored: Any) -> tuple:
        if self._loggable(kind):
            return self._gc_frame(
                {"op": "put", "kind": kind, "obj": _encode(stored)}
            )
        # volatile kinds stage a bare rv watermark (see
        # _append_rv_watermark) so the replayed counter stays exact
        return self._gc_frame(
            {"op": "rv", "rv": stored.metadata.resource_version}
        )

    def _gc_frame_del(self, kind: str, obj: Any, rv: int) -> tuple:
        if self._loggable(kind):
            return self._gc_frame(
                {"op": "del", "kind": kind, "key": obj.metadata.key, "rv": rv}
            )
        return self._gc_frame({"op": "rv", "rv": rv})

    def _gc_current(self, kind: str, key: str) -> Any:
        """Reservation-visible state of one key (caller holds the store
        lock): the staged overlay wins over the published maps, so
        validation against concurrent in-flight mutations is decided
        here — under the reservation lock — never at the barrier.
        Returns None for absent OR staged-deleted."""
        pend = self._gc_pending.get((kind, key))
        if pend is not None:
            return None if pend[1] is _GC_TOMB else pend[1]
        return self._objects.get(kind, {}).get(key)

    def _gc_reserve(self, kind: str, key: str, val: Any) -> int:
        self._gc_token += 1
        self._gc_pending[(kind, key)] = (self._gc_token, val)
        return self._gc_token

    def _gc_release(self, kind: str, key: str, token: int) -> None:
        # token-guarded: a LATER reservation on the same key must not be
        # clobbered by an earlier entry's publish/undo
        cur = self._gc_pending.get((kind, key))
        if cur is not None and cur[0] == token:
            del self._gc_pending[(kind, key)]

    def _gc_run(self, kind: str, build) -> Any:
        """One mutation through the pipeline: the short lock hold
        (gate + validate + reserve + stage via ``build``), then the
        off-lock barrier wait.  ``build`` raises to refuse (Conflict,
        KeyError, fault injection) with nothing staged."""
        with self._lock:
            self._check_open()
            self._check_wal_writable(kind)
            entry = build()
            if not entry.frames:
                # nothing durable to write (every batch item failed
                # validation): publish is a no-op fanout — return now
                entry.publish()
                return entry.result
            with self._gc_cond:
                self._gc_stage.append(entry)
        return self._gc_await(entry)

    def _gc_await(self, entry: _GroupEntry) -> Any:
        """Block until the entry's group commits (or fails).  MySQL-style
        leader election: the first waiter that finds no leader becomes
        it and commits the whole stage; everyone else parks on the
        condition and is acked by the leader's publish."""
        t0 = time.monotonic()
        while True:
            with self._gc_cond:
                while not entry.done and self._gc_leading:
                    self._gc_cond.wait()
                if entry.done:
                    break
                self._gc_leading = True
            try:
                self._gc_lead()
            finally:
                with self._gc_cond:
                    self._gc_leading = False
                    self._gc_cond.notify_all()
        hist.observe(
            "storage.group_wait_s", time.monotonic() - t0, exemplar=entry.key
        )
        if entry.err is not None:
            raise entry.err
        return entry.result

    def _gc_lead(self) -> None:
        """Leader turn: drain the stage UNDER the IO lock (drain order ==
        rv order == WAL byte order — a drain outside it could be
        overtaken by a concurrent drainer and write groups out of
        order), commit the group, publish, ack.  One group per turn:
        entries staged during our IO elect their own leader."""
        with self._io_lock:
            with self._gc_cond:
                group, self._gc_stage = self._gc_stage, []
            if group:
                self._gc_commit_group(group)

    def _gc_commit_group(self, group: list) -> None:
        """Write one group's frames in a single buffered write + at most
        one fsync, then publish in rv order.  Caller holds _io_lock
        (store lock NOT held — that is the whole point).  Failure
        (ENOSPC/EIO, injected or real) fails the WHOLE group typed with
        nothing published — see _gc_fail."""
        faults = self.faults
        err: Optional[OSError] = None
        parts: list = []
        nrecords = 0
        for entry in group:
            for frame, plen in entry.frames:
                # mirror _append_raw's injection points per record, so
                # fault schedules key on real appends in either mode
                if faults is not None and faults.should_fire(
                    "disk.enospc", self._path
                ):
                    err = OSError(
                        errno.ENOSPC, "injected: no space left on device"
                    )
                    break
                if faults is not None:
                    if faults.should_fire("wal.bitflip", self._path):
                        buf = bytearray(frame)
                        buf[HEADER_SIZE + plen // 2] ^= 0x01
                        frame = bytes(buf)
                        counters.inc("storage.bitflip_injected")
                    elif faults.should_fire("wal.torn_mid", self._path):
                        frame = frame[: HEADER_SIZE + max(plen // 2, 1)]
                        counters.inc("storage.torn_injected")
                parts.append(frame)
                nrecords += 1
            if err is not None:
                break
        if err is None and self._log is None:
            err = OSError(errno.EIO, "WAL log unavailable")
        if err is None:
            buf = b"".join(parts)
            try:
                pre_end = self._log.tell()  # append mode: current EOF
            except OSError:
                pre_end = None
            try:
                t0 = time.monotonic()
                n = self._log.write(buf)
                if n is not None and n != len(buf):
                    raise OSError(
                        errno.ENOSPC,
                        f"short WAL write ({n}/{len(buf)} bytes)",
                    )
                hist.observe("storage.wal_append_s", time.monotonic() - t0)
                if self._fsync:
                    t0 = time.monotonic()
                    self._fsync_now()
                    hist.observe(
                        "storage.wal_fsync_s", time.monotonic() - t0
                    )
            except OSError as e:
                if pre_end is not None:
                    # cut any partial frame back off the tail (see
                    # _append_raw: truncate-to-smaller works on a full
                    # disk) so probes never append after garbage
                    try:
                        self._log.truncate(pre_end)
                    except OSError:
                        pass
                err = e
        hub = self._repl_hub
        if err is None and hub is not None and parts:
            # -- the quorum-ack await (DESIGN.md §27) ----------------------
            # The group is durable HERE but not yet published: this is
            # the only point where holding it costs nothing visible.
            # Ship it (note_group wakes every follower stream), then
            # park until a follower quorum has it durable too.  A quorum
            # that never forms fails the WHOLE group typed — the bytes
            # are truncated back off (an unacked group may not survive,
            # exactly like a torn tail) and the stream epoch bumps so
            # followers that buffered it resync.
            start = pre_end if pre_end is not None else hub.durable_end
            hub.note_group(start, buf)
            t0 = time.monotonic()
            ok = hub.wait_quorum(start + len(buf), timeout=hub.ack_timeout_s)
            hist.observe("storage.quorum_wait_s", time.monotonic() - t0)
            if not ok:
                counters.inc("storage.repl.quorum_timeouts")
                try:
                    self._log.truncate(start)
                except OSError:
                    pass
                hub.retract(start)
                err = OSError(
                    errno.ETIMEDOUT,
                    f"replication quorum not reached within "
                    f"{hub.ack_timeout_s}s "
                    f"(need {hub.quorum_followers} follower acks)",
                )
        if err is not None:
            self._gc_fail(group, err)
            return
        with self._lock:
            # publish in strict rv order: maps apply + history + fanout,
            # exactly the visibility step the per-mutation path ran
            # under its (much longer) lock hold
            for entry in group:
                entry.publish()
            # ONE read-plane swap for the whole group — this is the
            # publish point the COW snapshot is defined by:
            # the maps and the visible rv move together, so lock-free
            # readers see a group whole or not at all, and a publisher's
            # own mutations are readable before its ack below
            self._cow_publish({e.kind for e in group if e.kind})
            if self._degraded:
                self._exit_degraded()  # never strand the latch
        counters.inc("storage.group_commit.groups")
        counters.inc("storage.group_commit.records", nrecords)
        if self._fsync and len(group) > 1:
            counters.inc("storage.group_commit.fsyncs_saved", len(group) - 1)
        with self._gc_cond:
            for entry in group:
                entry.done = True
            self._gc_cond.notify_all()

    def _gc_fail(self, group: list, err: OSError) -> None:
        """A failed group never happened: latch degraded, revert every
        reservation-time effect (newest first), and fail EVERY waiter
        typed — including entries staged after the drain, which were
        validated against reservations this failure just reverted.
        Caller holds _io_lock."""
        with self._lock:
            self._enter_degraded(err)
            counters.inc("storage.append_error")
            with self._gc_cond:
                tail, self._gc_stage = self._gc_stage, []
            doomed = group + tail
            for entry in reversed(doomed):
                entry.undo()
            with self._gc_cond:
                for entry in doomed:
                    failure = StorageDegraded(f"WAL append failed: {err}")
                    failure.__cause__ = err
                    entry.err = failure
                    entry.done = True
                self._gc_cond.notify_all()

    def _gc_drain_commit_locked(self) -> None:
        """Commit whatever is staged, inline, as one final group — for
        callers that already hold _io_lock + the store lock (compaction,
        close) and must leave the stage empty before proceeding.  The
        store lock being held keeps new entries from staging underneath
        (lock order forbids staging without it)."""
        with self._gc_cond:
            group, self._gc_stage = self._gc_stage, []
        if group:
            self._gc_commit_group(group)

    def mutate_many(self, kind: str, items, return_objects: bool = True,
                    clone_for_write: bool = True, prepare=None) -> list:
        """Batch read-modify-write.  Group-commit mode stages the whole
        batch as ONE entry (per-item validation errors stay per-entry in
        the returned list; an IO failure fails the whole call typed) and
        parks on the barrier off-lock.  Kill-switch mode is the original
        deferred-fsync path: every record an immediate unbuffered write
        under the lock, one fsync per batch."""
        if not self._gc_enabled:
            with self._lock:
                self._check_open()
                self._check_wal_writable(kind)
                self._defer_flush = True
                try:
                    # the batched fsync is the base class's _flush_log
                    # call, which lands BEFORE the fanout and RAISES on
                    # failure — an un-fsynced batch must not be
                    # acknowledged or fanned out (with fsync=True that
                    # is the whole durability promise); the finally
                    # only clears the defer flag
                    return super().mutate_many(
                        kind, items, return_objects, clone_for_write,
                        prepare=prepare,
                    )
                finally:
                    self._defer_flush = False

        def build():
            if prepare is not None:
                prepare(self)
            out: list = []
            frames: list = []
            events: list = []
            staged: list = []  # (key, token, old, work)
            for namespace, name, fn in items:
                key = f"{namespace}/{name}"
                try:
                    self._maybe_fault("update", kind, key)
                    old = self._gc_current(kind, key)
                    if old is None:
                        raise KeyError(f"{kind} {key!r} not found")
                    if clone_for_write:
                        work = old.clone()
                        work = fn(work) or work
                    else:
                        work = fn(old)
                    work.metadata.uid = old.metadata.uid
                    work.metadata.creation_timestamp = (
                        old.metadata.creation_timestamp
                    )
                    rv = work.metadata.resource_version = self._bump()
                    frames.append(self._gc_frame_put(kind, work))
                    token = self._gc_reserve(kind, key, work)
                    self._node_agg_track(kind, old, work)
                    staged.append((key, token, old, work))
                    out.append(work.clone() if return_objects else None)
                    events.append(
                        WatchEvent(EventType.MODIFIED, work, old, rv=rv)
                    )
                except Exception as err:  # noqa: BLE001 — returned, not lost
                    out.append(err)

            def publish():
                objs = self._objects.setdefault(kind, {})
                for key, token, _old, work in staged:
                    objs[key] = work
                    self._gc_release(kind, key, token)
                if events:
                    self._gc_visible_rv = max(
                        self._gc_visible_rv, events[-1].rv
                    )
                self._fanout(kind, events)

            def undo():
                for key, token, old, work in reversed(staged):
                    self._gc_release(kind, key, token)
                    self._node_agg_track(kind, work, old)

            return _GroupEntry(
                frames, publish, undo, out,
                staged[0][0] if staged else "", kind,
            )

        return self._gc_run(kind, build)

    def _fsync_now(self) -> None:
        """``os.fsync`` with the optional emulated duration floor
        (MINISCHED_FSYNC_FLOOR_US — see __init__): when the real device
        answers faster than the floor, sleep the remainder.  Never
        swallows the OSError — the floor only stretches successes."""
        t0 = time.monotonic()
        os.fsync(self._log.fileno())
        if self._fsync_floor_s > 0.0:
            rem = self._fsync_floor_s - (time.monotonic() - t0)
            if rem > 0.0:
                time.sleep(rem)

    def _fsync_log(self) -> None:
        """The deferred-batch fsync barrier: raises StorageDegraded on
        failure — callers must not acknowledge (or fan out) a batch the
        disk refused to make durable."""
        if self._log is not None and self._fsync:
            try:
                t0 = time.monotonic()
                self._fsync_now()
                hist.observe("storage.wal_fsync_s", time.monotonic() - t0)
            except OSError as e:
                self._enter_degraded(e)
                counters.inc("storage.append_error")
                raise StorageDegraded(f"WAL fsync failed: {e}") from e

    def _append_rv_watermark(self, rv: int) -> None:
        """Persist a bare version-counter record for a mutation whose kind
        is volatile (no put/del record).  Without it the replayed counter
        is merely monotone, not EXACT: an Event create/delete bumps the
        global rv with nothing in the WAL carrying it, and a reopened
        store would re-issue resource_versions that watchers and
        optimistic-concurrency clients already observed — breaking both
        the ``expected_rv`` precondition and watch resume."""
        self._append({"op": "rv", "rv": rv})

    def _on_batch_commit(self, kind: str, obj: Any) -> None:
        # the inlined batch path commits without calling update() — log
        # each stored object here, inside the same lock hold and order
        # (and BEFORE the insert: store.py calls this hook pre-commit)
        if self._loggable(kind):
            self._append({"op": "put", "kind": kind, "obj": _encode(obj)})
        else:
            self._append_rv_watermark(obj.metadata.resource_version)

    def _commit_record(self, kind: str, op: str, obj: Any, rv: int) -> None:
        # the base store calls this BEFORE the in-memory commit and the
        # watch fanout — the record is on disk (one unbuffered write)
        # before the object exists anywhere an observer could see it.  A
        # failed append therefore means the mutation never happened: no
        # phantom state, no resource_version a crash could roll back,
        # which is what keeps ``?resource_version=N`` resumes honest.
        if op == "put":
            if self._loggable(kind):
                self._append({"op": "put", "kind": kind, "obj": _encode(obj)})
            else:
                self._append_rv_watermark(rv)
        elif op == "del":
            if self._loggable(kind):
                self._append(
                    {
                        "op": "del",
                        "kind": kind,
                        "key": obj.metadata.key,
                        "rv": rv,
                    }
                )
            else:
                self._append_rv_watermark(rv)

    def _flush_log(self) -> None:
        # mutate_many's pre-fanout barrier: with unbuffered appends the
        # bytes are already at the OS — only the batched fsync is owed
        self._fsync_log()

    def create(self, kind: str, obj: Any) -> Any:
        if not self._gc_enabled:
            with self._lock:
                self._check_open()
                self._check_wal_writable(kind)
                return super().create(kind, obj)

        def build():
            key = obj.metadata.key
            self._maybe_fault("create", kind, key)
            if self._gc_current(kind, key) is not None:
                raise KeyError(f"{kind} {key!r} already exists")
            stored = self._stamp_new(kind, obj)
            rv = stored.metadata.resource_version
            token = self._gc_reserve(kind, key, stored)
            self._node_agg_track(kind, None, stored)

            def publish():
                self._objects.setdefault(kind, {})[key] = stored
                self._gc_release(kind, key, token)
                self._gc_visible_rv = max(self._gc_visible_rv, rv)
                self._fanout(
                    kind, [WatchEvent(EventType.ADDED, stored, rv=rv)]
                )

            def undo():
                self._gc_release(kind, key, token)
                self._node_agg_track(kind, stored, None)

            return _GroupEntry(
                [self._gc_frame_put(kind, stored)],
                publish, undo, stored.clone(), key, kind,
            )

        return self._gc_run(kind, build)

    def create_many(
        self, kind: str, objs: list, return_objects: bool = True
    ) -> list:
        """Batch create: one staged entry through the group barrier (one
        buffered write + one fsync for the batch AND any concurrent
        mutations it groups with).  Kill-switch mode is the original
        deferred-fsync contract (records append in commit order via
        _on_batch_commit, the barrier lands before the batched fanout)."""
        if not self._gc_enabled:
            with self._lock:
                self._check_open()
                self._check_wal_writable(kind)
                self._defer_flush = True
                try:
                    # fsync rides the base class's pre-fanout _flush_log
                    # barrier and raises on failure (see mutate_many)
                    return super().create_many(kind, objs, return_objects)
                finally:
                    self._defer_flush = False

        def build():
            out: list = []
            frames: list = []
            events: list = []
            staged: list = []  # (key, token, stored)
            for obj in objs:
                key = obj.metadata.key
                try:
                    self._maybe_fault("create", kind, key)
                    if self._gc_current(kind, key) is not None:
                        raise KeyError(f"{kind} {key!r} already exists")
                    stored = self._stamp_new(kind, obj)
                    rv = stored.metadata.resource_version
                    frames.append(self._gc_frame_put(kind, stored))
                    token = self._gc_reserve(kind, key, stored)
                    self._node_agg_track(kind, None, stored)
                    staged.append((key, token, stored))
                    out.append(stored.clone() if return_objects else None)
                    events.append(
                        WatchEvent(EventType.ADDED, stored, rv=rv)
                    )
                except Exception as err:  # noqa: BLE001 — returned, not lost
                    out.append(err)

            def publish():
                objs_map = self._objects.setdefault(kind, {})
                for key, token, stored in staged:
                    objs_map[key] = stored
                    self._gc_release(kind, key, token)
                if events:
                    self._gc_visible_rv = max(
                        self._gc_visible_rv, events[-1].rv
                    )
                self._fanout(kind, events)

            def undo():
                for key, token, stored in reversed(staged):
                    self._gc_release(kind, key, token)
                    self._node_agg_track(kind, stored, None)

            return _GroupEntry(
                frames, publish, undo, out,
                staged[0][0] if staged else "", kind,
            )

        return self._gc_run(kind, build)

    def update(self, kind: str, obj: Any, expected_rv: Optional[int] = None) -> Any:
        if not self._gc_enabled:
            with self._lock:
                self._check_open()
                self._check_wal_writable(kind)
                return super().update(kind, obj, expected_rv=expected_rv)
        return self._gc_run(
            kind, lambda: self._gc_build_update(kind, obj, expected_rv)
        )

    def _gc_build_update(
        self, kind: str, obj: Any, expected_rv: Optional[int]
    ) -> _GroupEntry:
        """Stage one update (caller holds the store lock): the
        ``expected_rv`` CAS is decided HERE, against the reservation-
        visible state (staged overlay wins), never at the barrier."""
        key = obj.metadata.key
        self._maybe_fault("update", kind, key)
        old = self._gc_current(kind, key)
        if old is None:
            raise KeyError(f"{kind} {key!r} not found")
        if (
            expected_rv is not None
            and old.metadata.resource_version != expected_rv
        ):
            raise Conflict(
                f"stale resource_version for {kind} {key}: expected "
                f"{expected_rv}, have {old.metadata.resource_version}"
            )
        stored = obj.clone()
        stored.metadata.uid = old.metadata.uid
        stored.metadata.creation_timestamp = old.metadata.creation_timestamp
        rv = stored.metadata.resource_version = self._bump()
        token = self._gc_reserve(kind, key, stored)
        self._node_agg_track(kind, old, stored)

        def publish():
            self._objects.setdefault(kind, {})[key] = stored
            self._gc_release(kind, key, token)
            self._gc_visible_rv = max(self._gc_visible_rv, rv)
            self._fanout(
                kind, [WatchEvent(EventType.MODIFIED, stored, old, rv=rv)]
            )

        def undo():
            self._gc_release(kind, key, token)
            self._node_agg_track(kind, stored, old)

        return _GroupEntry(
            [self._gc_frame_put(kind, stored)],
            publish, undo, stored.clone(), key, kind,
        )

    def mutate(
        self, kind: str, namespace: str, name: str, fn
    ) -> Any:
        """Read-modify-write.  The base implementation holds the store
        lock across get+update — in group-commit mode that would park
        on the barrier still owning the lock, so the RMW is restaged
        here: read + fn + reserve under ONE short hold, wait off-lock."""
        if not self._gc_enabled:
            return super().mutate(kind, namespace, name, fn)

        def build():
            key = f"{namespace}/{name}"
            self._maybe_fault("get", kind, key)
            cur = self._gc_current(kind, key)
            if cur is None:
                raise KeyError(f"{kind} {namespace}/{name} not found")
            work = cur.clone()
            work = fn(work) or work
            return self._gc_build_update(kind, work, None)

        return self._gc_run(kind, build)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        if not self._gc_enabled:
            with self._lock:
                self._check_open()
                self._check_wal_writable(kind)
                super().delete(kind, namespace, name)
            return

        def build():
            key = f"{namespace}/{name}"
            self._maybe_fault("delete", kind, key)
            old = self._gc_current(kind, key)
            if old is None:
                raise KeyError(f"{kind} {key!r} not found")
            rv = self._bump()
            token = self._gc_reserve(kind, key, _GC_TOMB)
            self._node_agg_track(kind, old, None)

            def publish():
                self._objects.get(kind, {}).pop(key, None)
                self._gc_release(kind, key, token)
                self._gc_visible_rv = max(self._gc_visible_rv, rv)
                self._fanout(
                    kind, [WatchEvent(EventType.DELETED, old, rv=rv)]
                )

            def undo():
                self._gc_release(kind, key, token)
                self._node_agg_track(kind, None, old)

            return _GroupEntry(
                [self._gc_frame_del(kind, old, rv)],
                publish, undo, None, key, kind,
            )

        return self._gc_run(kind, build)

    def restore_object(self, kind: str, obj: Any) -> None:
        # rare recovery/restore path with no concurrent traffic by
        # contract: a direct append under the IO lock (order io → store)
        # rather than the stage — its rv is the object's own, not a
        # fresh reservation, so barrier ordering does not apply
        with self._io_lock if self._gc_enabled else _null_ctx():
            with self._lock:
                self._check_open()
                self._check_wal_writable(kind)
                if self._gc_enabled:
                    # raise the published watermark FIRST (same lock
                    # hold, nothing staged on this path by contract) so
                    # the base class's COW swap stamps the restored rv,
                    # not the pre-restore one
                    self._gc_visible_rv = max(
                        self._gc_visible_rv,
                        self._rv,
                        obj.metadata.resource_version,
                    )
                super().restore_object(kind, obj)
                if self._gc_enabled:
                    self._gc_visible_rv = max(self._gc_visible_rv, self._rv)

    def set_resource_version(self, rv: int) -> None:
        with self._io_lock if self._gc_enabled else _null_ctx():
            with self._lock:
                if self._gc_enabled:
                    # watermark first: the base class's COW swap must
                    # stamp the fast-forwarded rv (see restore_object)
                    self._gc_visible_rv = max(
                        self._gc_visible_rv, self._rv, rv
                    )
                super().set_resource_version(rv)
                # checkpoint restores fast-forward past the max object rv
                # (e.g. trailing deletes before the snapshot) — persist
                # the watermark or reopened stores would re-issue
                # observed versions
                self._append({"op": "rv", "rv": self.resource_version})
                if self._gc_enabled:
                    self._gc_visible_rv = max(self._gc_visible_rv, self._rv)

    # -- binding-ack persistence (WAL-backed retry idempotency) ------------
    def record_acks(self, entries: Dict[str, dict]) -> None:
        """Persist binding-batch ack outcomes as volatile WAL records
        (``{"op": "ack", "id", "entry"}``) so a RETRIED batch stays
        idempotent across a server restart — the ROADMAP crumb the
        in-memory registry left open.  Best-effort by design: acks are a
        dedup optimization layered over the bind subresource's own
        preconditions (AlreadyBound-to-the-requested-node ⇒ the retried
        entry landed), so a degraded disk drops them silently rather
        than failing the bind response that already committed."""
        if not entries:
            return
        # ack records are volatile (no rv, no publish ordering), so they
        # bypass the group stage — but the physical appends still
        # serialize with the group leader's IO (lock order io → store)
        with self._io_lock if self._gc_enabled else _null_ctx():
            with self._lock:
                if self._closed or self._degraded or self._log is None:
                    return
                self._defer_flush = True
                try:
                    for ack_id, entry in entries.items():
                        self._append_raw(
                            {"op": "ack", "id": str(ack_id), "entry": entry},
                            ship=False,
                        )
                        self._acks[str(ack_id)] = entry
                        while len(self._acks) > ACK_REPLAY_CAP:
                            self._acks.pop(next(iter(self._acks)))
                    self._fsync_log()
                except StorageDegraded:
                    pass  # latched; the in-memory registry still answers
                finally:
                    self._defer_flush = False
                    # the port's own: the batch's records reach the
                    # followers' streams as one range, not one chunk (and
                    # one follower apply and ack) a record as in JAX
                    hub = self._repl_hub
                    if hub is not None and self._log is not None:
                        try:
                            hub.advance(self._log.tell())
                        except OSError:
                            pass

    def recovered_acks(self) -> Dict[str, dict]:
        """Ack outcomes replayed from the WAL, in append order (the HTTP
        façade seeds its registry + FIFO from this at boot)."""
        with self._lock:
            return dict(self._acks)

    # -- shard freeze-lease persistence (DESIGN.md §31) --------------------
    def record_shard_lease(self, entry: dict) -> None:
        """Journal one shard freeze-lease transition as a volatile WAL
        record (``{"op": "lease", "action": "freeze"|"thaw", "ns", ...}``)
        so a RESTARTED replica still refuses writes inside a split's
        freeze window it acknowledged before dying — without this, a
        leader that crashes and recovers mid-split would happily commit
        writes the in-flight handoff doc never shipped.  Same volatile
        contract as ``record_acks``: no rv, no publish ordering, no
        replication (each replica journals its OWN view), best-effort on
        a degraded disk — the lease TTL bounds the damage of a dropped
        record.  Fenced followers skip the append entirely: their WAL is
        the leader's replicated byte stream and must stay that way; a
        follower's fence already refuses the writes a freeze would."""
        if self._fenced:
            return
        with self._io_lock if self._gc_enabled else _null_ctx():
            with self._lock:
                if self._closed or self._degraded or self._log is None:
                    return
                self._defer_flush = True
                try:
                    self._append_raw(dict(entry, op="lease"))
                    ns = str(entry.get("ns"))
                    if entry.get("action") == "thaw":
                        self._shard_leases.pop(ns, None)
                    else:
                        self._shard_leases[ns] = {
                            k: entry[k] for k in entry if k != "op"
                        }
                    self._fsync_log()
                except StorageDegraded:
                    pass  # latched; ShardInfo's in-memory lease still holds
                finally:
                    self._defer_flush = False

    def recovered_shard_leases(self) -> Dict[str, dict]:
        """Freeze leases replayed from the WAL/checkpoint — the façade
        re-arms its ShardInfo from this at boot; expired entries are
        dropped by the adopter, not here (clock reads belong in one
        place)."""
        with self._lock:
            return dict(self._shard_leases)

    # -- recovery ----------------------------------------------------------
    def _read_checkpoint_file(self, path: str) -> dict:
        """Read + digest-verify one checkpoint generation.  A sidecar
        mismatch or unparseable body raises ValueError; a MISSING sidecar
        is accepted unverified (pre-integrity checkpoints carry none)."""
        with open(path, "rb") as f:
            data = f.read()
        verdict = checkpoint_digest(path, data)
        if verdict["ok"] is False:
            counters.inc("storage.ckpt_digest_mismatch")
            raise ValueError(
                f"checkpoint digest mismatch for {path!r}: sidecar "
                f"{verdict['want'][:12]}…, file {verdict['got'][:12]}…"
            )
        if verdict["ok"] is None:
            counters.inc("storage.ckpt_unverified")
        doc = json.loads(data)
        if doc.get("version") != CHECKPOINT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {doc.get('version')!r} "
                f"in {path!r}"
            )
        return doc

    def _restore_snapshot_doc(self, doc: dict) -> int:
        """Apply one verified snapshot document directly into the object
        maps — no WAL re-log, no watch fanout (a fresh store has no
        watchers; the ring starts at the tail).  Returns the snapshot's
        resource_version: the skip watermark for tail replay and the
        history floor for watch resume."""
        for kind, items in (doc.get("objects") or {}).items():
            tp = KIND_TYPES.get(kind)
            if tp is None:
                continue  # newer schema: skip rather than fail open
            objs = self._objects.setdefault(kind, {})
            for data in items:
                obj = _decode(tp, data)
                objs[obj.metadata.key] = obj
                self._rv = max(self._rv, obj.metadata.resource_version)
                self._note_recovered_uid(obj.metadata.uid)
        # the persisted uid watermark covers even objects deleted BEFORE
        # the snapshot (their put records were compacted away; the scan
        # above can't see them) — absent in older checkpoints, fine
        self._recovered_uid_max = max(
            self._recovered_uid_max, int(doc.get("uid_floor", 0))
        )
        # binding acks compacted into the snapshot; WAL ``ack`` records
        # replayed afterwards overwrite/extend (they are newer)
        for ack_id, entry in (doc.get("acks") or {}).items():
            self._acks[str(ack_id)] = entry
        while len(self._acks) > ACK_REPLAY_CAP:
            self._acks.pop(next(iter(self._acks)))
        # shard freeze leases compacted into the snapshot; WAL ``lease``
        # records replayed afterwards overwrite/extend (they are newer)
        for ns, lease in (doc.get("shard_leases") or {}).items():
            self._shard_leases[str(ns)] = lease
        rv = int(doc.get("resource_version", 0))
        self._rv = max(self._rv, rv)
        return rv

    def _load_checkpoint(self) -> int:
        """The fallback chain: current generation (digest-verified) →
        previous generation → full WAL+archive replay.  Returns the rv
        watermark of whichever snapshot restored (0 = none: replay the
        whole log; with an archive that is the FULL history, so nothing
        is lost even when both generations rot).  Refuses loudly
        (CheckpointCorrupt) when every arm fails AND there is no archive
        — the bare WAL tail would be silently-partial state."""
        candidates = [
            (self._ckpt_path, "current"),
            (self._ckpt_path + ".prev", "prev"),
        ]
        errors = []
        any_present = False
        for path, which in candidates:
            if not os.path.exists(path):
                continue
            any_present = True
            try:
                doc = self._read_checkpoint_file(path)
            except (ValueError, OSError, json.JSONDecodeError) as e:
                errors.append(f"{which}: {e}")
                continue
            if which == "prev":
                counters.inc("storage.ckpt_fallback_prev")
            self._ckpt_source = which
            return self._restore_snapshot_doc(doc)
        if not any_present:
            self._ckpt_source = "none"
            return 0
        # both generations unusable: rebuild from the archived history
        if os.path.exists(self._path + ".history"):
            counters.inc("storage.ckpt_fallback_replay")
            self._ckpt_source = "replay"
            return 0  # full replay: _replay reads .history before the WAL
        raise CheckpointCorrupt(
            f"no usable checkpoint for {self._path!r} and no archive to "
            f"rebuild from ({'; '.join(errors)}); the WAL alone is only "
            f"the post-compaction tail — refusing silent partial recovery"
        )

    def _drain_pending_archive(self) -> None:
        """Finish an interrupted archive: compact() atomically RENAMES the
        retired WAL segment to ``<path>.pending-archive`` before copying
        it into ``<path>.history`` — if a SIGKILL lands between the two,
        the segment is still sitting there, claimed but uncopied.  Append
        it exactly once and delete it.  (A copy-then-truncate scheme has
        no such claim step: a kill between the copy and the truncate
        makes the next compaction re-archive the same records.)

        Exactly-once includes the kill window between the history fsync
        and the unlink: a segment can only have been copied as history's
        final bytes, so if the history tail already EQUALS the pending
        content the copy happened and only the unlink is owed."""
        pending = self._path + ".pending-archive"
        if not os.path.exists(pending):
            return
        hist = self._path + ".history"
        with open(pending, "rb") as src:
            seg = src.read()
        already = False
        if seg and os.path.exists(hist) and os.path.getsize(hist) >= len(seg):
            with open(hist, "rb") as f:
                f.seek(-len(seg), os.SEEK_END)
                already = f.read() == seg
        if seg and not already:
            with open(hist, "ab") as dst:
                dst.write(seg)
                dst.flush()
                os.fsync(dst.fileno())
        os.unlink(pending)

    def _note_recovered_uid(self, uid: str) -> None:
        """Track the highest generated-uid suffix seen during recovery;
        the floor is applied once replay finishes (see _replay)."""
        n = _uid_suffix(uid)
        if n > self._recovered_uid_max:
            self._recovered_uid_max = n

    def _replay(self) -> None:
        self._recovered_uid_max = 0
        if self._archive and not self._readonly:
            # a crash mid-archive leaves a claimed segment; fold it into
            # the history file before anything else (its records are all
            # at/below the checkpoint that retired it — replay skips them)
            self._drain_pending_archive()
        self._ckpt_rv = self._load_checkpoint()
        if self._ckpt_source in ("prev", "replay"):
            # fallback arms that need the archive: with "replay" both
            # checkpoint generations were unusable and the state rebuilds
            # from the FULL history (rv-skip moot, _ckpt_rv == 0); with
            # "prev" the records between the previous generation and the
            # rotten current one were TRUNCATED out of the live WAL at
            # the last compaction and survive only in the archive —
            # replaying it over the prev snapshot is what makes the
            # fallback lossless (rv-skip drops the ≤ prev-rv overlap).
            # A non-archived store falling back to prev has no such
            # middle to recover — best effort, counted by the fallback
            # counter so the gap is visible.  Segments replay in append
            # (= mutation) order, then the live WAL.
            for p in (
                self._path + ".history",
                self._path + ".pending-archive",
            ):
                if os.path.exists(p):
                    self._replay_wal(p, truncate=False)
        if self._ckpt_rv:
            # events at/below the snapshot's rv are not reconstructable —
            # a watch resuming from before it must get 410 and relist
            self.set_history_floor(self._ckpt_rv)
        if os.path.exists(self._path):
            self._replay_wal(self._path, truncate=not self._readonly)
        # uid continuity: a fresh store's sequence starts at zero, and
        # re-issuing a recovered object's uid would let two DIFFERENT
        # pods share an identity (false double-bind audit hits, queue
        # dedup collapsing them).  Floor the sequence past everything this
        # recovery saw — checkpoint watermark, live objects, and every
        # replayed put (deleted objects included, via _apply).
        self._uid_seq = max(self._uid_seq, self._recovered_uid_max)
        # checkpoint restore + WAL replay write _objects directly — the
        # per-node bind aggregates (client._node_budgets' index) rebuild
        # once here instead of tracking per replayed record
        self._rebuild_node_agg()

    def _replay_wal(self, path: str, truncate: bool) -> None:
        """Replay one WAL file through the mixed v1/v2 frame reader.

        A torn TAIL (crash mid-append) is dropped and — when
        ``truncate`` — physically truncated, so the next append never
        concatenates onto garbage.  Mid-file corruption raises the
        reader's WalCorrupt (offset, record index, rv window) unless
        ``salvage="covered"`` AND the checkpoint covers the loss:
        every record still decodable at/after the bad frame (magic-scan
        resync) has rv ≤ the restored snapshot's — i.e. replay would
        have SKIPPED it anyway — in which case the file truncates at the
        bad frame and recovery proceeds losslessly.  An undecodable BAD
        TAIL (nothing resyncs after the corruption) is treated like a
        torn tail under salvage — with ``fsync=False`` the tail's
        durability was never promised — and hard-fails by default (a CRC
        mismatch is a lie, not an incomplete write)."""
        with open(path, "rb") as f:
            data = f.read()
        reader = WalReader(data, path=path)
        corrupt: Optional[WalCorrupt] = None
        try:
            for rec, _end in reader:
                self._apply(rec)
        except WalCorrupt as err:
            counters.inc("storage.wal_corrupt_detected")
            corrupt = err
        good_end = reader.good_end
        if corrupt is not None:
            if self._salvage != "covered":
                raise corrupt
            resync = resync_scan(data, corrupt.offset + 1)
            if resync is not None:
                lost_rvs = [
                    rv for r in resync[1] if (rv := _rec_rv(r)) > 0
                ]
                # coverage needs an rv-carrying WITNESS: records are in
                # append (= rv) order, so one put/del/rv record at
                # rv ≤ ckpt bounds everything before it — but a suffix
                # of only rv-less records (acks) bounds NOTHING; the
                # corrupt frame itself could be a post-checkpoint bind,
                # and truncating would silently lose it
                if not lost_rvs or max(lost_rvs) > self._ckpt_rv:
                    reach = (
                        f"reach rv {max(lost_rvs)}"
                        if lost_rvs
                        else "carry no resource_version"
                    )
                    raise WalCorrupt(
                        path,
                        corrupt.offset,
                        corrupt.index,
                        f"{corrupt.reason}; salvage refused: records past "
                        f"the corruption {reach} (checkpoint rv "
                        f"{self._ckpt_rv}) — truncating could lose "
                        f"committed state",
                        last_good_rv=corrupt.last_good_rv,
                        resync_rv=corrupt.resync_rv,
                    )
            counters.inc("storage.wal_salvaged")
        if truncate and good_end < len(data):
            # physically truncate the torn tail (or, under salvage, the
            # covered corrupt region) — appending after it would
            # concatenate the next record onto garbage, losing it on the
            # following reopen (and poisoning every later replay)
            with open(path, "rb+") as f:
                f.truncate(good_end)

    def _apply(self, rec: dict, collect: Optional[list] = None) -> None:
        """Apply one WAL record; also rebuilds the watch-resume history
        ring (replay = the tail of the live event stream).  Records at or
        below the checkpoint's rv are SKIPPED: they are already folded
        into the snapshot, and re-applying a pre-snapshot put would
        resurrect an object a later (also pre-snapshot) delete removed —
        the crash-between-checkpoint-and-truncate window makes such
        overlap possible.

        ``collect`` switches the event sink: recovery replay (None)
        records straight into the history ring (no watcher exists yet);
        the replicated-apply path passes a list and gets ``(kind,
        WatchEvent)`` pairs back, so ``apply_replicated`` runs the full
        ``_fanout`` (history and live watchers) per kind: a follower's
        watch streams see replicated mutations as a leader's see local
        ones."""
        op = rec["op"]
        if op == "rv":
            self._rv = max(self._rv, rec["rv"])
            return
        if op == "ack":
            # binding-ack registry records (volatile: no object, no rv);
            # bounded exactly like the façade's in-memory registry
            self._acks[str(rec.get("id"))] = rec.get("entry") or {}
            while len(self._acks) > ACK_REPLAY_CAP:
                self._acks.pop(next(iter(self._acks)))
            return
        if op == "lease":
            # shard freeze-lease records (volatile like acks): the last
            # transition per namespace wins — a thaw erases the freeze
            ns = str(rec.get("ns"))
            if rec.get("action") == "thaw":
                self._shard_leases.pop(ns, None)
            else:
                self._shard_leases[ns] = {
                    k: rec[k] for k in rec if k != "op"
                }
            return
        kind = rec["kind"]
        if kind not in KIND_TYPES:
            return  # written by a newer schema; skip rather than fail open
        if op == "put":
            obj = _decode(KIND_TYPES[kind], rec["obj"])
            # noted even for records the rv-skip below drops: their uids
            # were ISSUED, and re-issuing one after recovery would alias
            # two different objects
            self._note_recovered_uid(obj.metadata.uid)
            rv = obj.metadata.resource_version
            if rv <= self._ckpt_rv:
                return
            objs = self._objects.setdefault(kind, {})
            key = obj.metadata.key
            old = objs.get(key)
            objs[key] = obj
            self._rv = max(self._rv, rv)
            event = WatchEvent(
                EventType.MODIFIED if old is not None else EventType.ADDED,
                obj, old, rv=rv,
            )
            if collect is not None:
                collect.append((kind, event))
            else:
                self._record_history(kind, event)
        elif op == "del":
            rv = rec.get("rv", 0)
            if rv and rv <= self._ckpt_rv:
                return
            old = self._objects.get(kind, {}).pop(rec["key"], None)
            self._rv = max(self._rv, rv)
            if old is not None:
                event = WatchEvent(EventType.DELETED, old, rv=rv)
                if collect is not None:
                    collect.append((kind, event))
                else:
                    self._record_history(kind, event)

    # -- compaction --------------------------------------------------------
    def compact(self) -> None:
        """Checkpoint compaction: snapshot the live state to
        ``checkpoint_path`` (temp file + fsync + atomic replace, with a
        sha256 sidecar and the previous generation kept as ``.prev``),
        then truncate the WAL — recovery is snapshot ⊕ WAL tail.
        Crash-safe at every step: until the rename lands, the old
        checkpoint + full WAL recover; between the rename and the
        truncate, replay's rv-skip ignores the now-redundant WAL prefix;
        a digest mismatch at restore (bit rot, a crash between the body
        and sidecar renames) falls back to the prev generation — and the
        WAL truncation only ever happens after BOTH renames, so the prev
        arm always has the full tail it needs.  ``archive_compacted``
        appends the truncated records to ``<path>.history`` first so the
        full mutation history stays auditable.

        Group-commit mode: the pending stage is committed — as one final
        group — under the SAME io+store hold that takes the snapshot.
        Without that, ``_ckpt_rv = _rv`` would cover reserved rvs whose
        frames were still unwritten, and replay's rv-skip would drop
        mutations whose waiters were (about to be) acked.  Holding the
        store lock throughout keeps anything new from staging, and
        holding the IO lock keeps the leader out of the log while it is
        closed/truncated/reopened.

        A LEADING replica compacts too (DESIGN.md §28): the checkpoint
        it just wrote becomes a shipped GENERATION — under the same
        io+store hold, the hub ``rebase()``s onto the fresh WAL (epoch
        bump, digest ring + acks cleared, durable_end re-anchored at
        the post-compaction size), and followers whose cursor predates
        the rebase reseed from ``GET /repl/checkpoint`` instead of an
        unbounded offset-0 re-tail.

        The port's own addition: a compaction called sooner after the
        last one ended than that one took first sleeps out the rest of
        that time, so compaction holds the locks at most half the time.
        Python's locks are not fair: without the pause a caller that
        compacts in a loop takes them again before a writer woken by
        their release runs, and the writer can wait for seconds (JAX's
        store does the same; ROADMAP §3)."""
        end, took = self._last_compact
        pause = took - (time.monotonic() - end)
        if pause > 0:
            time.sleep(pause)
        t0 = time.monotonic()
        with self._io_lock if self._gc_enabled else _null_ctx():
            with self._lock:
                if self._gc_enabled:
                    self._gc_drain_commit_locked()
                self._compact_locked()
                hub = self._repl_hub
                if hub is not None:
                    self._ckpt_gen += 1
                    hub.rebase(self._ckpt_gen, self._ckpt_rv, self.wal_end())
                    counters.inc("storage.repl.ckpt_published")
        end = time.monotonic()
        self._last_compact = (end, end - t0)

    def _land_checkpoint_pair(self, body: bytes) -> None:
        """Land one checkpoint body + sha256 sidecar on disk: temp
        write + fsync both, rotate the old generation to ``.prev``,
        then atomic-replace the new pair in (JAX shares it with the
        checkpoint-seeded ``replica_reset``)."""
        digest = _sha256_hex(body)
        sidecar = self._ckpt_path + CKPT_DIGEST_SUFFIX
        tmp = self._ckpt_path + ".tmp"
        tmp_side = sidecar + ".tmp"
        with open(tmp, "wb") as f:
            f.write(body)
            f.flush()
            os.fsync(f.fileno())
        with open(tmp_side, "w", encoding="utf-8") as f:
            f.write(f"sha256 {digest}\n")
            f.flush()
            os.fsync(f.fileno())
        # rotate the old generation aside (keep exactly one), then
        # land the new pair.  A crash between any two renames leaves
        # a chain arm that still recovers: prev + full WAL.
        if os.path.exists(self._ckpt_path):
            os.replace(self._ckpt_path, self._ckpt_path + ".prev")
            if os.path.exists(sidecar):
                os.replace(
                    sidecar, self._ckpt_path + ".prev" + CKPT_DIGEST_SUFFIX
                )
            else:
                # the old generation predates sidecars — drop any
                # stale prev sidecar so it can't mis-verify it
                try:
                    os.unlink(
                        self._ckpt_path + ".prev" + CKPT_DIGEST_SUFFIX
                    )
                except FileNotFoundError:
                    pass
        os.replace(tmp, self._ckpt_path)
        os.replace(tmp_side, sidecar)

    def _compact_locked(self) -> None:
        with self._lock:
            # the uid watermark is the store's own sequence (JAX: its
            # process-global counter)
            doc = build_snapshot_doc(self._objects, self._rv, self._uid_seq)
            if self._acks:
                # the binding-ack registry rides the checkpoint (bounded
                # — ACK_REPLAY_CAP tiny dicts): its WAL records are about
                # to be truncated away, and 'idempotent across restarts'
                # must survive compaction, not just the WAL tail.  Extra
                # keys are ignored by older/foreign checkpoint readers.
                doc["acks"] = dict(self._acks)
            if self._shard_leases:
                # active freeze leases ride the checkpoint for the same
                # reason: a compaction mid-split must not erase the
                # journaled freeze (key absent when empty, so unsharded
                # checkpoints stay byte-identical)
                doc["shard_leases"] = dict(self._shard_leases)
            body = json.dumps(doc).encode()
            self._land_checkpoint_pair(body)
            faults = self.faults
            if faults is not None and faults.should_fire(
                "ckpt.corrupt", self._ckpt_path
            ):
                # the lying disk rots the checkpoint AFTER a clean write:
                # flip one byte mid-file; the sidecar now convicts it and
                # the next restore must take the fallback chain
                with open(self._ckpt_path, "rb+") as f:
                    f.seek(len(body) // 2)
                    b = f.read(1)
                    f.seek(len(body) // 2)
                    f.write(bytes([b[0] ^ 0x01]))
                counters.inc("storage.ckpt_corrupt_injected")
            self._ckpt_rv = self._rv
            if self._log is not None:
                self._log.close()
                self._log = None
            try:
                if self._archive:
                    # retire the segment by ATOMIC RENAME (the claim),
                    # then fold it into .history; a kill in between is
                    # finished by _drain_pending_archive at the next
                    # compact or reopen
                    self._drain_pending_archive()  # leftover from a crash
                    if os.path.exists(self._path):
                        os.replace(
                            self._path, self._path + ".pending-archive"
                        )
                with open(self._path, "w", encoding="utf-8"):
                    pass  # fresh WAL: the checkpoint holds the rest
                if self._archive:
                    self._drain_pending_archive()
            finally:
                # the log is reopened NO MATTER what raised above (ENOSPC
                # mid-archive is exactly compaction's weather): with
                # _log=None and _closed=False every later mutation would
                # commit in memory, fan out, and silently skip the WAL —
                # the one divergence this store exists to prevent.  If
                # even the reopen fails, close the store so mutations are
                # refused loudly instead of acknowledged and lost.
                if not self._closed:
                    try:
                        self._log = open(self._path, "ab", buffering=0)
                    except OSError:
                        self._closed = True
                        raise

    # -- scrub -------------------------------------------------------------
    def scrub(self) -> dict:
        """One background integrity pass over the live artifacts — the
        in-process half of ``python -m minisched_tpu fsck`` (which runs
        the same checks offline over a closed store's files):

        * WAL frame scan (the stable prefix; a torn tail under a live
          writer is expected, not a finding)
        * checkpoint sha256 sidecar verification (both generations)
        * per-node aggregate index vs a fresh recompute from the live
          objects (the invariant client._node_budgets trusts)
        * rv-counter sanity (counter ≥ every live object's rv)
        * degraded-mode recovery probe (a scrub pass is the natural
          re-arm tick when no mutation has tried recently)

        Returns ``{findings: [...], ...stats}``; every finding also
        bumps ``storage.scrub_findings``."""
        counters.inc("storage.scrub_runs")
        findings = []
        with self._lock:
            if self._degraded:
                self._maybe_probe_recovery()
            if not self._gc_pending:
                # staged-but-unpublished reservations debit the index
                # EAGERLY (that is what keeps concurrent binders from
                # overcommitting a node), so while anything is staged
                # the index legitimately runs ahead of the published
                # maps — skip the comparison for this pass rather than
                # report design as divergence
                agg_live = {
                    k: list(v) for k, v in self._pod_node_agg.items()
                }
                recompute = compute_node_agg(
                    self._objects.get("Pod", {}).values()
                )
                if agg_live != recompute:
                    findings.append(
                        "node aggregate index diverged from live objects: "
                        f"{sorted(set(agg_live) ^ set(recompute))[:5]}"
                    )
            max_obj_rv = max(
                (
                    o.metadata.resource_version
                    for objs in self._objects.values()
                    for o in objs.values()
                ),
                default=0,
            )
            if max_obj_rv > self._rv:
                findings.append(
                    f"rv counter {self._rv} behind live object rv "
                    f"{max_obj_rv}"
                )
            degraded = self._degraded
        wal_report = scan_file(self._path)
        if wal_report.get("corrupt"):
            c = wal_report["corrupt"]
            findings.append(
                f"WAL corruption at byte {c['offset']} ({c['reason']})"
            )
        for path in (self._ckpt_path, self._ckpt_path + ".prev"):
            if not os.path.exists(path):
                continue
            try:
                self._read_checkpoint_file(path)
            except (ValueError, OSError, json.JSONDecodeError) as e:
                findings.append(f"checkpoint {path!r}: {e}")
        if findings:
            counters.inc("storage.scrub_findings", len(findings))
        return {
            "findings": findings,
            "degraded": degraded,
            "wal": wal_report,
        }

    def start_scrub(self, interval_s: float = 1.0) -> None:
        """Arm the background scrub loop (idempotent)."""
        if self._scrub_thread is not None:
            return
        self._scrub_stop = threading.Event()

        def loop() -> None:
            while not self._scrub_stop.wait(interval_s):
                try:
                    self.scrub()
                except Exception:
                    pass  # scrub is advisory; never kill the thread

        self._scrub_thread = threading.Thread(
            target=loop, name="wal-scrub", daemon=True
        )
        self._scrub_thread.start()

    def storage_stats(self) -> dict:
        """The degraded-mode ledger for benches and dashboards."""
        with self._lock:
            dwell = self._degraded_seconds_total
            if self._degraded:
                dwell += time.monotonic() - self._degraded_since
            return {
                "degraded": self._degraded,
                "degraded_reason": self._degraded_reason,
                "degraded_episodes": self._degraded_episodes,
                "degraded_dwell_s": round(dwell, 3),
                "ckpt_source": self._ckpt_source,
            }

    # -- replication (DESIGN.md §27) ---------------------------------------
    def wal_end(self) -> int:
        """Current WAL size in bytes — the replication cursor: a
        follower resumes tailing from exactly here, and a leader's hub
        starts its shippable horizon here."""
        try:
            if self._log is not None:
                return self._log.tell()
            return os.path.getsize(self._path)
        except OSError:
            return 0

    def wal_range_crc32c(self, start: int, end: int) -> Optional[int]:
        """CRC32C over a raw byte range of the local WAL — the follower
        half of digest gossip: re-derived from OUR disk (not a cached
        value) and compared against the leader's ring, so a disk that
        lies about already-applied groups is convicted by comparison.
        None when the range is not fully present."""
        try:
            with open(self._path, "rb") as f:
                f.seek(start)
                buf = f.read(end - start)
        except OSError:
            return None
        if len(buf) != end - start:
            return None
        return group_crc32c(buf)

    def promote_leader(self, hub: Any) -> None:
        """Attach a ReplicationHub: this store now leads — its barrier
        owes a follower quorum per group, its WAL is the authoritative
        byte sequence, and it accepts client writes again."""
        if not self._gc_enabled:
            raise RuntimeError(
                "replication requires group commit "
                "(MINISCHED_GROUP_COMMIT=0 is incompatible with a "
                "replicated plane: the quorum barrier lives there)"
            )
        with self._io_lock:
            with self._lock:
                hub.durable_end = self.wal_end()
                if self._ckpt_rv > 0 and os.path.exists(self._ckpt_path):
                    # promoting over a compacted WAL: the on-disk
                    # checkpoint IS a generation of this leadership —
                    # our WAL alone is only the tail, so any follower
                    # without this base must seed from the checkpoint,
                    # never re-tail from byte 0
                    if self._ckpt_gen == 0:
                        self._ckpt_gen = 1
                    hub.ckpt_gen = self._ckpt_gen
                    hub.ckpt_rv = self._ckpt_rv
                self._repl_hub = hub
                self._fenced = False
                self._leader_hint = ""

    def fence(self, leader_hint: str = "") -> None:
        """Stop accepting writes: this replica follows (or was deposed).
        The hub is closed BEFORE the locks are taken — a barrier parked
        in wait_quorum holds _io_lock, and closing the hub is what fails
        its group and frees the lock; taking the lock first would
        deadlock the fence behind the very wait it needs to cancel."""
        hub = self._repl_hub
        if hub is not None:
            hub.close()
        with self._io_lock:
            with self._lock:
                self._repl_hub = None
                self._fenced = True
                self._leader_hint = leader_hint

    def is_fenced(self) -> bool:
        return self._fenced

    @property
    def checkpoint_rv(self) -> int:
        """The rv watermark of the checkpoint generation this store's
        WAL tail sits on (0 = full history).  A follower's stream cursor
        is only meaningful against a leader advertising the same base —
        repl.WalFollower compares this against /repl/status."""
        return self._ckpt_rv

    def checkpoint_ship_blob(self) -> Optional[dict]:
        """The current checkpoint generation as a shippable blob:
        ``{"body": bytes, "sha256": hex, "rv": snapshot rv}``, or None
        when there is no generation or the sidecar CONVICTS the bytes —
        a leader never ships state it cannot prove.  The rv is parsed
        from the body itself (not ``_ckpt_rv``) so a racing rotation can
        never pair one generation's rv with another's bytes."""
        try:
            with open(self._ckpt_path, "rb") as f:
                body = f.read()
        except OSError:
            return None
        verdict = checkpoint_digest(self._ckpt_path, body)
        if verdict["ok"] is False:
            counters.inc("storage.ckpt_digest_mismatch")
            return None
        try:
            rv = int(json.loads(body).get("resource_version", 0))
        except (ValueError, json.JSONDecodeError):
            return None
        return {"body": body, "sha256": _sha256_hex(body), "rv": rv}

    def apply_replicated(self, data: bytes,
                         start_offset: Optional[int] = None) -> int:
        """Follower apply: append one shipped group's raw bytes to the
        local WAL (fsync when armed) and replay its records through the
        SAME ``_apply`` path recovery runs — a promoted follower serves
        state built exactly the way a reopened leader would build it.

        Ordering: the group decodes STRICTLY first (walio.decode_group
        — a torn or corrupt group never reaches the local disk), then
        ``start_offset`` must equal our current WAL end (byte-contiguous
        by contract; a mismatch means the stream and the file diverged
        and the caller must resync).  Returns the new WAL end — the
        offset the follower acks."""
        recs = decode_group(data, self._path)
        with self._io_lock if self._gc_enabled else _null_ctx():
            with self._lock:
                if self._closed or self._log is None:
                    raise RuntimeError(
                        f"store {self._path!r} closed; replicated apply "
                        f"refused"
                    )
                end = self._log.tell()
                if start_offset is not None and start_offset != end:
                    raise ValueError(
                        f"replicated group offset {start_offset} != local "
                        f"WAL end {end} (resync required)"
                    )
                try:
                    n = self._log.write(data)
                    if n is not None and n != len(data):
                        raise OSError(
                            errno.ENOSPC,
                            f"short WAL write ({n}/{len(data)} bytes)",
                        )
                    if self._fsync:
                        self._fsync_now()
                except OSError as e:
                    try:
                        self._log.truncate(end)
                    except OSError:
                        pass
                    self._enter_degraded(e)
                    counters.inc("storage.append_error")
                    raise StorageDegraded(
                        f"replicated WAL append failed: {e}"
                    ) from e
                kinds = set()
                collected: list = []
                for rec in recs:
                    self._apply(rec, collect=collected)
                    if rec.get("op") in ("put", "del"):
                        kinds.add(rec.get("kind"))
                self._gc_visible_rv = max(self._gc_visible_rv, self._rv)
                # fan the group's events into LIVE watcher queues (and
                # the history ring) exactly as the leader's publish path
                # does — follower-attached watch streams observe
                # replicated mutations, not just future resumes.  One
                # _fanout per kind preserves intra-kind order and
                # batches the per-watcher delivery.
                by_kind: Dict[str, list] = {}
                for k, ev in collected:
                    by_kind.setdefault(k, []).append(ev)
                for k, events in by_kind.items():
                    self._fanout(k, events)
                self._cow_publish({k for k in kinds if k})
                # uids in replicated puts were ISSUED by the leader: floor
                # our sequence so a promoted follower never re-issues one
                # (the rule replay applies)
                self._uid_seq = max(self._uid_seq, self._recovered_uid_max)
                new_end = self._log.tell()
        counters.inc("storage.repl.applied_groups")
        counters.inc("storage.repl.applied_records", len(recs))
        return new_end

    def replica_reset(self, seed: Optional[dict] = None) -> None:
        """Wipe this replica (WAL truncated to zero, in-memory state
        cleared) so a follower can re-tail the leader's stream from
        byte 0 — the resync path after an epoch bump, offset
        discontinuity, or digest divergence.  Drastic by design: the
        authoritative log is the leader's, and reasoning about partial
        divergence is how replicas rot.

        With ``seed`` (a digest-verified checkpoint blob fetched from
        the leader — DESIGN.md §28) the wiped replica re-bases on the
        leader's checkpoint GENERATION instead of empty: the pair lands
        on our own disk first through the same atomic sequence
        compaction uses (so our next restart recovers from it), the
        snapshot restores into the object maps, and the rv-skip
        watermark moves to the snapshot rv.  The caller then tails the
        leader's post-compaction WAL from byte 0 — bootstrap is
        O(state), not O(history).  The uid sequence is never lowered
        (JAX's process-wide counter is not either)."""
        doc = None
        if seed is not None:
            doc = json.loads(seed["body"])
            if doc.get("version") != CHECKPOINT_VERSION:
                raise ValueError(
                    f"unsupported shipped checkpoint version "
                    f"{doc.get('version')!r}"
                )
        with self._io_lock if self._gc_enabled else _null_ctx():
            with self._lock:
                if self._log is not None:
                    self._log.truncate(0)
                    self._log.seek(0)
                kinds = tuple(self._objects)
                self._objects.clear()
                self._rv = 0
                self._gc_visible_rv = 0
                self._ckpt_rv = 0
                self._acks.clear()
                self._history.clear()
                self._history_bytes_used.clear()
                self._history_floors.clear()
                self._history_floor_min = 0
                self._pod_node_agg.clear()
                self._recovered_uid_max = 0
                if doc is not None:
                    self._land_checkpoint_pair(seed["body"])
                    rv = self._restore_snapshot_doc(doc)
                    self._ckpt_rv = rv
                    self._ckpt_source = "shipped"
                    self._gc_visible_rv = self._rv
                    # events at/below the seeded snapshot are not
                    # reconstructable here: watches resuming from before
                    # it must 410 and relist (same rule as recovery)
                    self.set_history_floor(rv)
                    self._uid_seq = max(self._uid_seq,
                                        self._recovered_uid_max)
                    self._rebuild_node_agg()
                    kinds = tuple(set(kinds) | set(self._objects))
                self._cow_publish(kinds)

    def close(self) -> None:
        hub = self._repl_hub
        if hub is not None:
            # wake any barrier parked in wait_quorum so the drain below
            # can take _io_lock without waiting out the ack timeout
            hub.close()
        if getattr(self, "_gc_enabled", False):
            # commit whatever is staged first so no waiter hangs on a
            # barrier that will never run (waiters are acked or failed
            # typed before the log handle goes away)
            with self._io_lock:
                with self._lock:
                    if not self._closed:
                        self._gc_drain_commit_locked()
        if self._scrub_stop is not None:
            self._scrub_stop.set()
        if self._scrub_thread is not None:
            self._scrub_thread.join(timeout=5.0)
            self._scrub_thread = None
        with self._lock:
            self._closed = True
            if self._log is not None:
                self._log.close()
                self._log = None
        if getattr(self, "_gc_enabled", False):
            # anything that slipped into the stage between the drain and
            # the close latch: fail it loudly, never strand its waiter
            with self._gc_cond:
                leftover, self._gc_stage = self._gc_stage, []
                for entry in leftover:
                    entry.err = RuntimeError(
                        f"durable store {self._path!r} closed before the "
                        f"commit barrier ran"
                    )
                    entry.done = True
                if leftover:
                    self._gc_cond.notify_all()


def store_from_url(url: str) -> Optional[ObjectStore]:
    """Resolve ProcessConfig's external-store URL (the reference's
    KUBE_SCHEDULER_SIMULATOR_ETCD_URL analog, config/config.go:59-66):
    ``file://<path>`` → a WAL-backed DurableObjectStore; empty → None
    (caller uses the in-memory store)."""
    if not url:
        return None
    if url.startswith("file://"):
        return DurableObjectStore(url[len("file://"):])
    raise ValueError(f"unsupported store url {url!r} (file://<path> only)")
