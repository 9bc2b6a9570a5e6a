"""Replicated control plane: quorum-ack WAL shipping at the group-commit
barrier (DESIGN.md §27).

A copy of ``minisched_tpu/controlplane/repl.py`` (``:1-1226``) over the
port's durable store and façade; the wire (``/repl/*``), the stream's
framing and the WAL bytes are JAX's, so a follower of either package
tails a leader of the other.

N store replicas consume the leader's CRC-framed record stream, and the
leader's group-commit barrier holds every mutation between its ONE fsync
and its publish until a QUORUM of followers has the group durable too.
Nothing is ever acked to a caller that machine loss could take back.

* **The GROUP is the replication unit.**  Group commit writes each group
  as one contiguous byte range in rv-dense order (durable.py
  ``_gc_commit_group``); shipping exactly that range means the
  follower's apply inherits byte order == rv order, and the walio frames
  inside it are self-delimiting and checksummed.
* **The recovery path IS the apply path.**  Followers append the shipped
  bytes to their own WAL, fsync, and replay them through the same
  ``_apply`` recovery code a restart runs.
* **Failover rides the ``expected_rv``-CAS Lease arbitration**
  (``ha/lease.py``): each replica hosts a tiny in-memory ARBITER store
  (coordination only, never the replicated data plane); the
  store-leader lease is CAS-acquired on a MAJORITY of arbiters.  A
  follower that wins promotes and serves from its replayed WAL; demoted
  ex-leaders fence their writes (store.NotLeader, HTTP 503 ``not
  leader``).

Quorum rule: with ``cluster_size`` replicas the leader needs
``cluster_size // 2`` follower acks per group (itself being the +1 of
the majority).  A quorum that cannot be reached within the ack timeout
fails the WHOLE group typed (StorageDegraded) with nothing published,
truncates the unacked suffix off the local WAL, and bumps the stream
EPOCH so any follower that buffered it resyncs.

Digest gossip: the leader keeps a bounded ring of per-group CRC32C
digests over the shipped byte ranges; followers verify each group on
receipt AND periodically re-derive digests from their own local WAL
bytes against ``GET /repl/digests``, and resync on a mismatch.

Checkpoint generations (DESIGN.md §28): the leader compacts while the hub
is attached; each compaction publishes the fresh checkpoint as a
numbered generation and ``rebase()``s the hub (epoch bump, digest ring
and acks cleared, ``durable_end`` re-anchored).  A follower whose cursor
predates the rebase (or a brand-new replica) fetches the generation over
``GET /repl/checkpoint?gen=``, verifies its sha256, seeds through
``replica_reset(seed=...)`` and tails the new WAL from byte zero.

Kill-switch: ``MINISCHED_REPL=0`` keeps every hub and follower
unattached (``replproc`` then starts no runtime).

Wire surface (the REST façade's, with a runtime attached):

    GET  /repl/status                         → role/rv/epoch/offsets
    GET  /repl/stream?offset=&epoch=&replica= → group-framed byte tail
    GET  /repl/digests?since=                 → per-group digest ring
    GET  /repl/checkpoint?gen=                → checkpoint generation
                                                bytes (sha256 in headers)
    POST /repl/ack {replica, offset, epoch}   → follower durability ack

Inside the chunked stream each shipped group is one header line (JSON:
off/len/crc/seq) plus its raw bytes, with ``{"hb": epoch}`` heartbeats
while idle.  Fault points ``repl.ship`` and ``repl.ack`` (keyed by
replica id) read the store's ``faults`` fabric; every outbound call also
consults ``faults.net.GLOBAL_NET``.

Where the port differs (the bytes in every WAL stay JAX's): a follower's
acks ride one kept-alive connection; a follower more than one ship unit
behind gets up to ``CATCHUP_CHUNK_BYTES`` of whole frames in one chunk
(``ReplicationHub.coalesce_end``); and a shipped range that does not
apply on the follower (its tail forked below the leader's end) resyncs
instead of retrying forever (ROADMAP §3).  ``durable.record_acks``
advances the hub once a batch.
"""

from __future__ import annotations

import collections
import hashlib
import http.client
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from minisched_tpu_torch.controlplane.httppool import HTTPConnectionPool
from minisched_tpu_torch.controlplane.walio import WalCorrupt, group_crc32c
from minisched_tpu_torch.faults.net import GLOBAL_NET
from minisched_tpu_torch.observability import counters, hist

#: leader-side ring of per-group digests: deep enough that a follower a
#: few seconds behind still finds its catch-up boundaries group-aligned
#: (older ranges ship as raw catch-up chunks, digested on the fly)
DIGEST_RING = 4096

#: the store-leader lease name on every arbiter
LEASE_STORE_LEADER = "store-leader"

#: the port's own: a follower more than one ship unit behind gets up to
#: this many bytes, ending on a frame boundary, in one chunk (JAX ships
#: one group or raw range a chunk, and a follower catching up on a run of
#: one-record groups pays a header, an apply and an ack for each)
CATCHUP_CHUNK_BYTES = 4 << 20

GroupDigest = collections.namedtuple("GroupDigest", "seq start end crc")


def repl_enabled() -> bool:
    """The MINISCHED_REPL kill-switch: ``0`` keeps every hub and
    follower unattached, restoring single-store semantics exactly."""
    return os.environ.get("MINISCHED_REPL", "1") != "0"


@dataclass(frozen=True)
class PeerSpec:
    """One replica's addresses: the data plane façade (replicated store)
    and the arbiter façade (in-memory coordination store)."""

    replica_id: str
    data_url: str
    arbiter_url: str = ""

    def as_dict(self) -> dict:
        return {
            "replica_id": self.replica_id,
            "data_url": self.data_url,
            "arbiter_url": self.arbiter_url,
        }


# ---------------------------------------------------------------------------
# leader side: the quorum tracker the barrier parks on
# ---------------------------------------------------------------------------


class ReplicationHub:
    """Leader-side replication state: which byte offset is durable and
    shippable, which follower has acked what, and the per-group digest
    ring.  ``durable.py`` calls ``note_group``/``wait_quorum`` at the
    group-commit barrier; the façade's stream/ack handlers call
    ``wait_bytes``/``record_ack``; everything synchronizes on one
    condition variable."""

    def __init__(
        self,
        wal_path: str,
        cluster_size: int = 1,
        ack_timeout_s: float = 30.0,
        epoch: int = 1,
        digest_ring: int = DIGEST_RING,
    ):
        self.wal_path = wal_path
        self.cluster_size = max(int(cluster_size), 1)
        self.ack_timeout_s = float(ack_timeout_s)
        self.epoch = int(epoch)
        self.durable_end = 0  # set by promote_leader (current WAL size)
        #: the current checkpoint generation (0 = none shipped yet) and
        #: the rv its snapshot covers — set by promote_leader when a
        #: checkpoint already exists on disk, advanced by rebase()
        self.ckpt_gen = 0
        self.ckpt_rv = 0
        self.seq = 0
        self.digests: collections.deque = collections.deque(
            maxlen=digest_ring
        )
        self.closed = False
        self._acks: Dict[str, int] = {}
        self._cond = threading.Condition()

    @property
    def quorum_followers(self) -> int:
        """Follower acks needed per group: the leader's own fsync is the
        +1 that makes ``cluster_size // 2 + 1`` a majority."""
        return self.cluster_size // 2

    # -- barrier side (leader's group-commit thread) -----------------------
    def note_group(self, start: int, buf: bytes) -> GroupDigest:
        """Publish one committed group's byte range to the stream plane
        (called after the leader's fsync, before its publish)."""
        with self._cond:
            self.seq += 1
            digest = GroupDigest(
                self.seq, start, start + len(buf), group_crc32c(buf)
            )
            self.digests.append(digest)
            if digest.end > self.durable_end:
                self.durable_end = digest.end
            self._cond.notify_all()
        counters.inc("storage.repl.groups")
        counters.inc("storage.repl.bytes", len(buf))
        return digest

    def advance(self, end: int) -> None:
        """Durable-offset advance WITHOUT a group (rv watermarks, ack
        records, recovery probes): the bytes ship as raw catch-up chunks
        and need no quorum — they carry no client-visible promise."""
        with self._cond:
            if end > self.durable_end:
                self.durable_end = end
                self._cond.notify_all()

    def rebase(self, gen: int, ckpt_rv: int, wal_end: int) -> None:
        """A compaction passed under the hub: the WAL restarted past the
        checkpoint, so every old byte offset is meaningless.  Publish
        the new generation, bump the EPOCH (every stream must
        re-handshake and every behind follower reseeds from the
        checkpoint), clear the digest ring and acks (they describe the
        dead byte space), and re-anchor ``durable_end`` at the fresh
        WAL's size.  Called by ``durable.compact()`` under the store's
        io+store locks — this only takes the hub condition."""
        with self._cond:
            self.ckpt_gen = int(gen)
            self.ckpt_rv = int(ckpt_rv)
            self.durable_end = int(wal_end)
            self.epoch += 1
            self.digests.clear()
            self._acks.clear()
            self._cond.notify_all()

    def retract(self, end: int) -> None:
        """A quorum-failed group was truncated off the local WAL: pull
        the shippable horizon back and bump the EPOCH so followers that
        buffered the dead bytes resync to the authoritative log."""
        with self._cond:
            self.durable_end = end
            self.epoch += 1
            self.digests.clear()
            self._acks.clear()
            self._cond.notify_all()

    def wait_quorum(self, end: int, timeout: Optional[float] = None) -> bool:
        """Block until ``quorum_followers`` distinct followers have
        acked durability through ``end``.  False on timeout or close —
        the caller fails the group; it was never acked to anyone."""
        need = self.quorum_followers
        if need <= 0:
            return True
        deadline = (
            None if timeout is None else time.monotonic() + float(timeout)
        )
        with self._cond:
            while not self.closed:
                got = sum(1 for off in self._acks.values() if off >= end)
                if got >= need:
                    return True
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return False

    # -- stream side (façade handler threads) ------------------------------
    def record_ack(
        self, replica: str, offset: int, epoch: Optional[int] = None
    ) -> None:
        """Record one follower's durable offset.  Epoch-tagged acks from
        a RETIRED byte space (pre-retract or pre-rebase offsets can be
        numerically huge in the new, restarted space) are dropped — a
        stale ack must never satisfy a quorum it does not describe."""
        if epoch is not None and int(epoch) != self.epoch:
            counters.inc("storage.repl.stale_acks")
            return
        with self._cond:
            if offset > self._acks.get(replica, -1):
                self._acks[replica] = int(offset)
                self._cond.notify_all()
        counters.inc("storage.repl.acks")

    def wait_bytes(
        self, offset: int, epoch: int, timeout: float
    ) -> tuple:
        """Park a stream until bytes past ``offset`` exist (or the epoch
        moves, or the hub closes).  Returns (durable_end, epoch,
        closed)."""
        deadline = time.monotonic() + float(timeout)
        with self._cond:
            while (
                not self.closed
                and self.epoch == epoch
                and self.durable_end <= offset
            ):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            return self.durable_end, self.epoch, self.closed

    def next_chunk(self, offset: int) -> tuple:
        """The next ship unit starting at ``offset``: a digest-ring group
        when one starts exactly there (group-aligned fast path), else a
        raw catch-up range up to the next known group start (or the
        durable end).  Returns (end, crc_or_None, seq_or_None); crc is
        None when the range must be digested from the file bytes."""
        with self._cond:
            nxt = None
            for g in self.digests:
                if g.start == offset:
                    return g.end, g.crc, g.seq
                if g.start > offset and (nxt is None or g.start < nxt):
                    nxt = g.start
            end = self.durable_end if nxt is None else min(
                nxt, self.durable_end
            )
            return end, None, None

    def coalesce_end(self, offset: int, end: int, limit: int) -> int:
        """The furthest frame boundary at most ``limit`` bytes past
        ``offset`` and within the durable end (a group's start or end in
        the ring, or the durable end itself), and at least ``end``: how
        far one chunk from ``offset`` may reach (the port's own)."""
        with self._cond:
            cap = min(self.durable_end, offset + limit)
            if cap <= end:
                return end
            if cap == self.durable_end:
                return cap
            best = end
            for g in self.digests:
                for b in (g.start, g.end):
                    if best < b <= cap:
                        best = b
            return best

    def digests_since(self, since_seq: int = 0) -> List[GroupDigest]:
        with self._cond:
            return [g for g in self.digests if g.seq > since_seq]

    def acks_snapshot(self) -> Dict[str, int]:
        with self._cond:
            return dict(self._acks)

    def close(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()


# ---------------------------------------------------------------------------
# follower side: tail the leader's stream through the real recovery path
# ---------------------------------------------------------------------------


class WalFollower(threading.Thread):
    """Tail one leader's ``/repl/stream`` into a local DurableObjectStore.

    Each received group is CRC-verified, appended to the local WAL
    (fsync when the store is armed), applied through the store's real
    recovery path (``apply_replicated``), and acked back with the new
    durable offset.  Reconnects resume from the local WAL size — the
    offset IS the replication cursor, no separate bookkeeping to rot.

    Resync (epoch mismatch, offset discontinuity, digest divergence,
    checkpoint-generation drift) consults the leader's status FIRST:
    when the leader has a checkpoint generation, the follower fetches
    it, verifies the sha256, and seeds through the checkpoint-seeded
    ``replica_reset(seed=...)`` — never a blind wipe-and-re-tail, which
    against a compacted leader would replay only the tail and serve
    partial state.  Only a leader with NO checkpoint (``ckpt_rv`` 0)
    still gets the full offset-0 re-tail (``storage.repl.full_retails``).
    When the leader cannot even be asked, local state is left UNTOUCHED
    and the retry loop re-decides — not resetting is always safe."""

    def __init__(
        self,
        store: Any,
        leader_url: str,
        replica_id: str,
        read_timeout_s: float = 5.0,
        reconnect_delay_s: float = 0.1,
        gossip_every_s: float = 2.0,
        leader_id: str = "",
    ):
        super().__init__(name=f"wal-follower-{replica_id}", daemon=True)
        self._store = store
        self._leader = leader_url.rstrip("/")
        self._leader_id = leader_id
        self._replica = replica_id
        self._read_timeout_s = float(read_timeout_s)
        self._reconnect_delay_s = float(reconnect_delay_s)
        self._gossip_every_s = float(gossip_every_s)
        # not named _stop: Thread.join() calls a private _stop() method
        self._halt = threading.Event()
        self._epoch = 0
        self._last_gossip = 0.0
        #: the port's own: acks ride one kept-alive connection (JAX opens
        #: one a POST, and a leader answering thousands of acks a second
        #: spends its interpreter on connection setup)
        self._ack_pool = HTTPConnectionPool(
            self._leader, max_idle=1, timeout_s=self._read_timeout_s)
        #: evidence for tests/status
        self.last_error: str = ""
        self.resumed_from: Optional[int] = None
        self.leader_seen = threading.Event()

    # -- plumbing -----------------------------------------------------------
    def _local_end(self) -> int:
        return self._store.wal_end()

    def _net_gate(self, timeout: Optional[float] = None) -> None:
        GLOBAL_NET.check(
            self._leader_id or "?",
            channel="data",
            src=self._replica,
            timeout_s=timeout or self._read_timeout_s,
        )

    def _get_json(self, path: str, timeout: Optional[float] = None) -> Any:
        import urllib.request

        self._net_gate(timeout)
        with urllib.request.urlopen(
            self._leader + path, timeout=timeout or self._read_timeout_s
        ) as r:
            return json.loads(r.read())

    def _post_json(self, path: str, payload: dict) -> None:
        self._net_gate()
        try:
            status, raw, _replayed = self._ack_pool.request(
                "POST", path, body=json.dumps(payload).encode())
        except http.client.HTTPException as e:
            raise OSError(f"POST {path}: {e!r}") from e
        if status >= 400:
            raise OSError(f"POST {path}: HTTP {status} "
                          f"{raw.decode(errors='replace')}")

    def _ack(self, offset: int) -> None:
        # best-effort: a lost ack (repl.ack fault, transport blip) heals
        # at the next group or heartbeat re-ack — the offset is absolute
        # within the epoch it is tagged with, and the hub drops acks
        # from retired epochs
        try:
            self._post_json(
                "/repl/ack",
                {
                    "replica": self._replica,
                    "offset": offset,
                    "epoch": self._epoch,
                },
            )
        except OSError:
            pass

    def _base_rv(self) -> int:
        """The rv of the checkpoint generation this replica's WAL tail
        sits on (0 = full history).  Our cursor is only meaningful
        against a leader advertising the SAME base."""
        return int(getattr(self._store, "checkpoint_rv", 0) or 0)

    def _resync(self, reason: str) -> None:
        """Local state is suspect or obsolete: re-base on the leader.
        The leader's status decides HOW — checkpoint seed when it has a
        generation, full re-tail when it does not.  If the leader cannot
        be consulted, local state stays untouched (safe: the retry loop
        lands back here)."""
        try:
            status = self._get_json("/repl/status")
        except OSError as e:
            self.last_error = f"resync pending ({reason}): {e}"
            self._epoch = 0
            return
        if status.get("role") != "leader":
            self.last_error = f"resync pending ({reason}): peer not leading"
            self._epoch = 0
            return
        self._reseed(status, reason)

    def _reseed(self, status: dict, reason: str) -> None:
        counters.inc("storage.repl.resyncs")
        self.last_error = f"resync: {reason}"
        self._epoch = 0
        ckpt_rv = int(status.get("ckpt_rv", 0) or 0)
        if ckpt_rv <= 0:
            # leader has no checkpoint: its WAL IS the full history, so
            # the offset-0 re-tail reconstructs everything
            counters.inc("storage.repl.full_retails")
            self._store.replica_reset()
            return
        t0 = time.monotonic()
        blob = self._fetch_checkpoint(int(status.get("ckpt_gen", 0) or 0))
        self._store.replica_reset(seed=blob)
        counters.inc("storage.repl.ckpt_seeds")
        hist.observe("storage.repl.bootstrap_s", time.monotonic() - t0)

    def _fetch_checkpoint(self, gen: int) -> dict:
        """GET one checkpoint generation off the leader and verify the
        sha256 it proved against its own sidecar before anything is
        trusted.  Raises OSError on transport failure, wrong generation
        (the leader compacted again mid-fetch — retry re-decides), or a
        digest mismatch (bytes rotted in transit or on either disk)."""
        import urllib.request

        self._net_gate()
        url = self._leader + f"/repl/checkpoint?gen={int(gen)}"
        with urllib.request.urlopen(
            url, timeout=max(self._read_timeout_s, 30.0)
        ) as r:
            body = r.read()
            sha = r.headers.get("X-Ckpt-Sha256", "")
            rv = int(r.headers.get("X-Ckpt-Rv", "0"))
            got_gen = int(r.headers.get("X-Ckpt-Gen", "0"))
        if sha and hashlib.sha256(body).hexdigest() != sha:
            counters.inc("storage.repl.digest_mismatch")
            raise OSError(f"checkpoint gen {got_gen} failed sha256 check")
        return {"body": body, "rv": rv, "gen": got_gen, "sha256": sha}

    # -- lifecycle ----------------------------------------------------------
    def stop(self) -> None:
        self._halt.set()

    def run(self) -> None:
        try:
            while not self._halt.is_set():
                try:
                    self._sync_epoch()
                    self._tail_once()
                except Exception as e:  # noqa: BLE001 — any failure retails
                    self.last_error = str(e)
                if not self._halt.is_set():
                    self._halt.wait(self._reconnect_delay_s)
        finally:
            self._ack_pool.close()

    def _sync_epoch(self) -> None:
        status = self._get_json("/repl/status")
        if status.get("role") != "leader":
            raise OSError(f"peer {self._leader} is not leading")
        epoch = int(status.get("epoch", 0))
        if self._epoch and epoch != self._epoch:
            self._reseed(
                status, f"leader epoch moved {self._epoch} -> {epoch}"
            )
        elif int(status.get("ckpt_rv", 0) or 0) != self._base_rv():
            # the leader's checkpoint generation is not the base our WAL
            # tail sits on: every byte offset we hold belongs to a
            # different coordinate space (leader compacted while we were
            # away, or we are brand new against a compacted leader)
            self._reseed(status, "checkpoint generation moved")
        elif self._local_end() > int(status.get("durable_end", 0)):
            # we hold bytes the leader does not acknowledge (ex-leader
            # tail, or a quorum-failed group we buffered): authoritative
            # log wins
            self._reseed(status, "local WAL ahead of leader durable end")
        self._epoch = int(status.get("epoch", 0))
        self._leader_rv = int(status.get("rv", 0) or 0)
        self._note_apply_lag()
        self.leader_seen.set()

    def _note_apply_lag(self) -> None:
        """Gauge how far this replica's applied rv trails the leader's
        last OBSERVED rv (floored at 0 — the observation may be stale
        while groups stream in).  Updated at status sync and after every
        applied group, so observability can alarm on a replica that
        stops keeping up and clients can see the lag decay during
        catch-up."""
        local = int(
            getattr(self._store, "applied_rv", lambda: 0)() or 0
        )
        counters.set_gauge(
            "storage.repl.apply_lag_rv",
            max(0, getattr(self, "_leader_rv", 0) - local),
        )

    def _tail_once(self) -> None:
        import urllib.parse

        self._net_gate()
        parsed = urllib.parse.urlsplit(self._leader)
        conn = http.client.HTTPConnection(
            parsed.hostname, parsed.port, timeout=self._read_timeout_s
        )
        try:
            offset = self._local_end()
            conn.request(
                "GET",
                f"/repl/stream?offset={offset}&epoch={self._epoch}"
                f"&replica={self._replica}",
            )
            resp = conn.getresponse()
            if resp.status == 410:
                resp.read()
                self._resync("stream answered 410 (epoch/offset gone)")
                return
            if resp.status != 200:
                raise OSError(f"stream HTTP {resp.status}")
            self.resumed_from = offset
            while not self._halt.is_set():
                # a partition imposed MID-STREAM must sever the
                # established flow too, not just the next connect
                self._net_gate()
                line = resp.readline()
                if not line:
                    return  # leader hung up; reconnect resumes
                header = json.loads(line)
                if "resync" in header:
                    self._resync("leader requested resync")
                    return
                if "hb" in header:
                    if int(header["hb"]) != self._epoch:
                        self._resync("epoch moved mid-stream")
                        return
                    self._maybe_gossip()
                    self._ack(self._local_end())  # heal lost acks
                    continue
                off, length, crc = (
                    int(header["off"]), int(header["len"]), header.get("crc")
                )
                payload = self._read_exact(resp, length)
                if crc is not None and group_crc32c(payload) != int(crc):
                    counters.inc("storage.repl.digest_mismatch")
                    self._resync(f"group crc mismatch at {off}")
                    return
                if off != self._local_end():
                    self._resync(
                        f"offset discontinuity (local {self._local_end()}, "
                        f"stream {off})"
                    )
                    return
                t0 = time.monotonic()
                try:
                    new_end = self._store.apply_replicated(
                        payload, start_offset=off
                    )
                except (WalCorrupt, ValueError) as e:
                    # the port's own addition: the range does not decode
                    # as whole frames HERE — our tail forked below the
                    # cursor (an ex-leader's group no follower received,
                    # shorter than the new leader's log, so the "ahead"
                    # check above could not see it).  JAX retries the
                    # same range forever; the authoritative log wins
                    counters.inc("storage.repl.forked_tail")
                    self._resync(f"shipped range at {off} does not "
                                 f"apply here: {e}")
                    return
                self._ack(new_end)
                hist.observe(
                    "storage.repl_apply_s", time.monotonic() - t0
                )
                self._note_apply_lag()
                self._maybe_gossip()
        finally:
            conn.close()

    @staticmethod
    def _read_exact(resp: Any, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            piece = resp.read(n - len(out))
            if not piece:
                raise OSError("stream truncated mid-group")
            out += piece
        return bytes(out)

    # -- digest gossip ------------------------------------------------------
    def _maybe_gossip(self) -> None:
        now = time.monotonic()
        if now - self._last_gossip < self._gossip_every_s:
            return
        self._last_gossip = now
        self.gossip_once()

    def gossip_once(self) -> bool:
        """One scrub-gossip round: re-derive CRC32C digests from our OWN
        local WAL bytes for every leader ring entry we have applied, and
        compare.  A mismatch means a replica's disk (ours or a torn
        apply) diverged AFTER the transit CRC passed — convict by
        comparison, count it, and resync.  Returns False on mismatch."""
        try:
            ring = self._get_json("/repl/digests")["digests"]
        except OSError:
            return True
        local_end = self._local_end()
        for entry in ring:
            start, end = int(entry["start"]), int(entry["end"])
            if end > local_end:
                continue  # not applied yet
            local = self._store.wal_range_crc32c(start, end)
            if local is None:
                continue  # file shrank under us (reset mid-gossip)
            if local != int(entry["crc"]):
                counters.inc("storage.repl.digest_mismatch")
                self._resync(
                    f"digest gossip divergence in group "
                    f"[{start},{end}) (seq {entry.get('seq')})"
                )
                return False
        return True


# ---------------------------------------------------------------------------
# failover: majority lease arbitration over the replicas' arbiter stores
# ---------------------------------------------------------------------------


class PlaneCoordinator(threading.Thread):
    """Store-leader election among replicas, riding ha/lease.py's
    ``expected_rv``-CAS arbitration (DESIGN.md §27).

    Each replica hosts an in-memory ARBITER store; the store-leader
    lease is acquired per-arbiter by CAS, and leadership = holding it on
    a MAJORITY of the full cluster.  Why this is safe: two candidates
    racing on one arbiter resolve exactly one winner (the 409), and no
    two candidates can both assemble a majority.  Why it does not fork
    data: arbiter stores are volatile and never replicated — lease
    traffic cannot advance the data plane's rv.

    Failover window: a dead leader stops renewing; after one lease TTL
    every arbiter reads the lease expired and candidates run.  The
    most-caught-up candidate should win — candidates poll surviving
    peers' ``/repl/status`` and stagger their attempts by (rv, id) rank,
    so a follower missing acked groups yields to one that has them
    whenever the two can see each other.  (A partitioned stale candidate
    still cannot win a majority without beating the fresher one's CAS on
    shared arbiters.)"""

    def __init__(
        self,
        runtime: "ReplRuntime",
        ttl_s: float = 2.0,
        poll_s: Optional[float] = None,
        stagger_s: Optional[float] = None,
    ):
        super().__init__(
            name=f"plane-coordinator-{runtime.replica_id}", daemon=True
        )
        self._rt = runtime
        self._ttl = float(ttl_s)
        self._poll = float(poll_s) if poll_s is not None else self._ttl / 3.0
        self._stagger = (
            float(stagger_s) if stagger_s is not None else self._ttl / 4.0
        )
        # not named _stop: Thread.join() calls a private _stop() method
        self._halt = threading.Event()
        self._managers: Dict[str, Any] = {}
        self._no_leader_since: Optional[float] = None

    # -- plumbing -----------------------------------------------------------
    @property
    def _majority(self) -> int:
        return len(self._rt.peers) // 2 + 1

    def _net_gate(self, peer: PeerSpec) -> None:
        """Consult the partition layer before touching a peer's arbiter
        — a cut arbiter link must look exactly like a dead arbiter."""
        GLOBAL_NET.check(
            peer.replica_id,
            channel="arbiter",
            src=self._rt.replica_id,
            timeout_s=min(1.0, self._ttl / 2.0),
        )

    def _manager(self, peer: PeerSpec) -> Any:
        mgr = self._managers.get(peer.replica_id)
        if mgr is None:
            from minisched_tpu_torch.controlplane.remote import RemoteClient
            from minisched_tpu_torch.ha.lease import LeaseManager

            # no retries and a short timeout: a dead arbiter must cost a
            # tick fractions of the TTL, not multiples (election timing
            # is the failover window)
            client = RemoteClient(
                peer.arbiter_url,
                timeout_s=min(1.0, self._ttl / 2.0),
                retries=0,
            )
            mgr = LeaseManager(client)
            self._managers[peer.replica_id] = mgr
        return mgr

    def stop(self) -> None:
        self._halt.set()

    def run(self) -> None:
        while not self._halt.is_set():
            try:
                if self._rt.role == "leader":
                    self._lead_tick()
                else:
                    self._follow_tick()
            except Exception as e:  # noqa: BLE001 — ticks must not die
                self._rt.last_election_error = str(e)
            self._halt.wait(self._poll)

    # -- leader: keep the majority or fence --------------------------------
    def _lead_tick(self) -> None:
        held = 0
        for peer in self._rt.peers:
            try:
                self._net_gate(peer)
                if self._manager(peer).acquire(
                    LEASE_STORE_LEADER, self._rt.replica_id, self._ttl
                ):
                    held += 1
            except Exception:  # noqa: BLE001 — unreachable arbiter
                pass
        if held < self._majority:
            # we can no longer prove leadership to a majority: fence
            # BEFORE someone else wins it — two acking leaders is the
            # one unforgivable state
            self._rt.demote("lost arbiter majority")

    # -- follower: watch the lease, elect on expiry ------------------------
    def _follow_tick(self) -> None:
        holders: Dict[str, int] = {}
        now = time.time()
        reachable = 0
        for peer in self._rt.peers:
            try:
                self._net_gate(peer)
                lease = self._manager(peer).get(LEASE_STORE_LEADER)
                reachable += 1
            except Exception:  # noqa: BLE001
                continue
            if lease is not None and not lease.expired(now):
                holders[lease.spec.holder] = (
                    holders.get(lease.spec.holder, 0) + 1
                )
        live = [h for h, n in holders.items() if n >= self._majority]
        if live:
            self._no_leader_since = None
            holder = live[0]
            if holder == self._rt.replica_id:
                # the cluster still believes in us (fast restart inside
                # our own TTL): resume leading rather than fencing the
                # only majority holder
                self._rt.promote()
            else:
                self._rt.note_leader(holder)
            return
        if reachable < self._majority:
            return  # partitioned: cannot elect, cannot conclude death
        if self._no_leader_since is None:
            self._no_leader_since = time.monotonic()
        # stagger candidacy by data freshness: rank 0 = best (rv, id)
        if time.monotonic() - self._no_leader_since < (
            self._rank() * self._stagger
        ):
            return
        self._try_elect()

    def _rank(self) -> int:
        """How many reachable peers are strictly fresher than us —
        (higher rv), ties to the lexically-smaller replica id."""
        mine = (self._rt.store_rv(), self._rt.replica_id)
        rank = 0
        for peer in self._rt.peers:
            if peer.replica_id == self._rt.replica_id:
                continue
            try:
                status = self._rt.peer_status(peer)
            except OSError:
                continue
            theirs = (int(status.get("rv", 0)), str(status.get("replica")))
            if theirs[0] > mine[0] or (
                theirs[0] == mine[0] and theirs[1] < mine[1]
            ):
                rank += 1
        return rank

    def _try_elect(self) -> None:
        won: List[PeerSpec] = []
        for peer in self._rt.peers:
            try:
                self._net_gate(peer)
                if self._manager(peer).acquire(
                    LEASE_STORE_LEADER, self._rt.replica_id, self._ttl
                ):
                    won.append(peer)
            except Exception:  # noqa: BLE001
                pass
        if len(won) >= self._majority:
            self._no_leader_since = None
            self._rt.promote()
            return
        # minority: release what we grabbed so a fresher candidate is
        # not blocked by our partial spoils until the TTL
        for peer in won:
            try:
                self._manager(peer).release(
                    LEASE_STORE_LEADER, self._rt.replica_id
                )
            except Exception:  # noqa: BLE001
                pass


# ---------------------------------------------------------------------------
# the per-replica runtime: role state + the façade's /repl handlers
# ---------------------------------------------------------------------------


class ReplRuntime:
    """Everything one replica process needs: role state (leader hub /
    follower tailer), the election coordinator, and the ``/repl/*``
    handlers ``start_api_server(repl=...)`` dispatches to."""

    def __init__(
        self,
        store: Any,
        replica_id: str,
        peers: Optional[List[PeerSpec]] = None,
        cluster_size: Optional[int] = None,
        ack_timeout_s: float = 30.0,
        ttl_s: float = 2.0,
        heartbeat_s: float = 0.5,
    ):
        self.store = store
        self.replica_id = replica_id
        self.peers = list(peers or ())
        self.cluster_size = int(
            cluster_size if cluster_size is not None else max(
                1, len(self.peers)
            )
        )
        self.ack_timeout_s = float(ack_timeout_s)
        self.ttl_s = float(ttl_s)
        self.heartbeat_s = float(heartbeat_s)
        self.role = "follower"
        self.leader_id: str = ""
        self.hub: Optional[ReplicationHub] = None
        self.follower: Optional[WalFollower] = None
        self.coordinator: Optional[PlaneCoordinator] = None
        self.last_election_error = ""
        self._epoch_seen = 0
        self._mu = threading.RLock()

    # -- lifecycle ----------------------------------------------------------
    def start(self, bootstrap_leader: Optional[str] = None) -> None:
        """Boot this replica's role: the configured bootstrap leader
        promotes immediately (epoch 1); everyone else follows it.  With
        no bootstrap (post-crash rejoin), stay follower and let the
        coordinator discover or elect."""
        if bootstrap_leader == self.replica_id:
            self.promote()
        elif bootstrap_leader:
            self.note_leader(bootstrap_leader)
        if len(self.peers) > 1:
            self.coordinator = PlaneCoordinator(self, ttl_s=self.ttl_s)
            self.coordinator.start()

    def close(self) -> None:
        with self._mu:
            if self.coordinator is not None:
                self.coordinator.stop()
            if self.follower is not None:
                self.follower.stop()
            if self.hub is not None:
                self.hub.close()

    # -- role transitions ---------------------------------------------------
    def promote(self) -> None:
        """Become (or resume being) the leader: stop tailing, attach a
        fresh hub at a NEW epoch, unfence.  Idempotent."""
        with self._mu:
            if self.role == "leader" and self.hub is not None:
                return
            if self.follower is not None:
                self.follower.stop()
                self.follower = None
            self._epoch_seen += 1
            hub = ReplicationHub(
                getattr(self.store, "_path", "<wal>"),
                cluster_size=self.cluster_size,
                ack_timeout_s=self.ack_timeout_s,
                epoch=self._epoch_seen,
            )
            self.store.promote_leader(hub)
            self.hub = hub
            self.role = "leader"
            self.leader_id = self.replica_id
            counters.inc("storage.repl.promotions")

    def demote(self, reason: str = "", leader_hint: str = "") -> None:
        """Fence: this replica may no longer ack writes.  The hub is
        closed FIRST so a barrier parked in wait_quorum fails its group
        instead of blocking the fence."""
        with self._mu:
            if self.role != "leader":
                return
            self.store.fence(leader_hint)
            self.hub = None
            self.role = "follower"
            self.leader_id = leader_hint
            self.last_election_error = reason

    def note_leader(self, holder: str) -> None:
        """A (new) leader is known: make sure we are tailing IT."""
        with self._mu:
            if self.role == "leader" and holder != self.replica_id:
                # deposed while we still thought we led
                self.demote("observed a newer leader", leader_hint=holder)
            if holder == self.leader_id and self.follower is not None:
                return
            peer = next(
                (p for p in self.peers if p.replica_id == holder), None
            )
            if peer is None:
                return
            if self.follower is not None:
                self.follower.stop()
            self.leader_id = holder
            if not self.store.is_fenced():
                self.store.fence(holder)
            self.follower = WalFollower(
                self.store, peer.data_url, self.replica_id,
                read_timeout_s=max(self.ttl_s, 2.0),
                leader_id=holder,
            )
            self.follower.start()

    # -- introspection ------------------------------------------------------
    def store_rv(self) -> int:
        return int(getattr(self.store, "resource_version", 0))

    def peer_status(self, peer: PeerSpec) -> dict:
        import urllib.request

        GLOBAL_NET.check(
            peer.replica_id,
            channel="data",
            src=self.replica_id,
            timeout_s=self.ttl_s,
        )
        with urllib.request.urlopen(
            peer.data_url.rstrip("/") + "/repl/status", timeout=self.ttl_s
        ) as r:
            return json.loads(r.read())

    def status(self) -> dict:
        hub = self.hub
        applied = int(getattr(self.store, "applied_rv", self.store_rv)())
        return {
            "replica": self.replica_id,
            "role": self.role,
            "leader": self.leader_id,
            "rv": self.store_rv(),
            # the rv this replica's READ plane serves right now — the
            # freshness stamp clients use to pick a follower and the
            # bound NotYetObserved is judged against (DESIGN.md §29)
            "applied_rv": applied,
            # best routing hint for writes: the leader we tail (or are);
            # "" when between leaders — the client probes other replicas
            "leader_hint": (
                self.replica_id if self.role == "leader" else self.leader_id
            ),
            "epoch": hub.epoch if hub is not None else self._epoch_seen,
            "durable_end": (
                hub.durable_end if hub is not None else self.store.wal_end()
            ),
            "cluster_size": self.cluster_size,
            "quorum_followers": (
                hub.quorum_followers if hub is not None else None
            ),
            "acks": hub.acks_snapshot() if hub is not None else {},
            "fenced": bool(self.store.is_fenced()),
            # checkpoint generation: a leader advertises the hub's (what
            # a follower must base on); a follower reports its own
            # seeded base (what its WAL tail sits on)
            "ckpt_gen": hub.ckpt_gen if hub is not None else 0,
            "ckpt_rv": (
                hub.ckpt_rv
                if hub is not None
                else int(getattr(self.store, "checkpoint_rv", 0) or 0)
            ),
            # the whole replica set's data urls (self included) — what
            # the sharded router's endpoint discovery unions into its
            # per-group read fanout (DESIGN.md §31): one live answer
            # describes the group
            "peers": [
                {"replica": p.replica_id, "url": p.data_url}
                for p in self.peers
            ],
        }

    # -- façade handlers (called from httpserver._Handler) -----------------
    def handle_get(self, handler: Any, path: str, query: str) -> None:
        if path == "/repl/status":
            handler._send(200, self.status())
            return
        if path == "/repl/digests":
            since = handler._int_param(query, "since") or 0
            hub = self.hub
            digests = hub.digests_since(since) if hub is not None else []
            handler._send(
                200,
                {
                    "epoch": hub.epoch if hub is not None else 0,
                    "digests": [
                        {"seq": g.seq, "start": g.start,
                         "end": g.end, "crc": g.crc}
                        for g in digests
                    ],
                },
            )
            return
        if path == "/repl/checkpoint":
            self._serve_checkpoint(handler, query)
            return
        if path == "/repl/stream":
            self._serve_stream(handler, query)
            return
        handler._error(404, f"no repl route {path}")

    def _serve_checkpoint(self, handler: Any, query: str) -> None:
        """Ship the current checkpoint generation: raw body bytes, with
        the generation number, snapshot rv, and sha256 in headers so the
        follower can verify before trusting a byte.  410 when the asked
        generation already rotated away (the follower re-consults status
        and retries against the new one)."""
        hub = self.hub
        if hub is None:
            handler._error(409, "not leading")
            return
        want = handler._int_param(query, "gen")
        if want is not None and int(want) != hub.ckpt_gen:
            handler._error(
                410, f"generation {want} gone (current {hub.ckpt_gen})"
            )
            return
        blob = self.store.checkpoint_ship_blob()
        if blob is None:
            handler._error(404, "no shippable checkpoint generation")
            return
        body = blob["body"]
        counters.inc("storage.repl.ckpt_ships")
        counters.inc("storage.repl.ckpt_bytes", len(body))
        handler.send_response(200)
        handler.send_header("Content-Type", "application/octet-stream")
        handler.send_header("Content-Length", str(len(body)))
        handler.send_header("X-Ckpt-Gen", str(hub.ckpt_gen))
        handler.send_header("X-Ckpt-Rv", str(blob["rv"]))
        handler.send_header("X-Ckpt-Sha256", blob["sha256"])
        handler.end_headers()
        handler.wfile.write(body)

    def handle_post(self, handler: Any, path: str) -> None:
        if path == "/repl/ack":
            body = handler._body()
            replica = str(body.get("replica", ""))
            offset = int(body.get("offset", -1))
            hub = self.hub
            faults = getattr(handler, "faults", None) or getattr(
                self.store, "faults", None
            )
            if faults is not None and faults.should_fire("repl.ack", replica):
                # the ack is LOST on the leader side: the follower's
                # durability is real but unproven — it re-acks on its
                # next group or heartbeat
                counters.inc("storage.repl.ship_errors")
                handler._error(503, "injected: ack dropped")
                return
            if hub is None or offset < 0 or not replica:
                handler._error(409, "not leading (or malformed ack)")
                return
            epoch = body.get("epoch")
            hub.record_ack(
                replica, offset,
                epoch=int(epoch) if epoch is not None else None,
            )
            handler._send(200, {"acked": offset, "epoch": hub.epoch})
            return
        handler._error(404, f"no repl route {path}")

    # -- the stream server --------------------------------------------------
    def _serve_stream(self, handler: Any, query: str) -> None:
        """One follower's tail: chunked HTTP; inside it, header lines +
        raw group bytes (module docstring has the framing).  Runs on the
        façade handler thread — a replica plane is a handful of
        followers, not the thousand-watcher regime the selector loop
        exists for (and the loop's event queues would re-buffer what is
        already a file; the WAL itself is the buffer here)."""
        hub = self.hub
        params = dict(
            p.split("=", 1) for p in query.split("&") if "=" in p
        )
        replica = params.get("replica", "?")
        try:
            offset = int(params.get("offset", 0))
            epoch = int(params.get("epoch", 0))
        except ValueError:
            handler._error(400, "offset/epoch must be integers")
            return
        if hub is None:
            handler._error(409, "not leading")
            return
        if epoch != hub.epoch or offset > hub.durable_end:
            handler._error(410, "stale epoch or offset beyond durable end")
            return
        handler.send_response(200)
        handler.send_header("Content-Type", "application/x-ndjson")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()
        counters.inc("storage.repl.streams")
        faults = getattr(handler, "faults", None) or getattr(
            self.store, "faults", None
        )

        def chunk(data: bytes) -> None:
            handler.wfile.write(
                f"{len(data):X}\r\n".encode() + data + b"\r\n"
            )

        sent = offset
        try:
            with open(hub.wal_path, "rb") as wal:
                while not hub.closed:
                    end, cur_epoch, closed = hub.wait_bytes(
                        sent, epoch, timeout=self.heartbeat_s
                    )
                    if closed or cur_epoch != epoch:
                        chunk(b'{"resync": true}\n')
                        break
                    if end <= sent:
                        chunk(
                            json.dumps({"hb": epoch}).encode() + b"\n"
                        )
                        continue
                    if faults is not None and faults.should_fire(
                        "repl.ship", replica
                    ):
                        # the ship fails mid-flight: drop the stream
                        # with no goodbye — the follower reconnects and
                        # resumes from its own offset
                        counters.inc("storage.repl.ship_errors")
                        return
                    chunk_end, crc, seq = hub.next_chunk(sent)
                    far = hub.coalesce_end(sent, chunk_end,
                                           CATCHUP_CHUNK_BYTES)
                    if far > chunk_end:
                        # behind by more than one unit: whole frames up
                        # to ``far`` as one chunk, digested below
                        chunk_end, crc, seq = far, None, None
                    wal.seek(sent)
                    buf = wal.read(chunk_end - sent)
                    if len(buf) != chunk_end - sent:
                        # truncated under us (quorum-fail retract won
                        # the race): the epoch bumped — tell the
                        # follower to start over
                        chunk(b'{"resync": true}\n')
                        break
                    if crc is None:
                        crc = group_crc32c(buf)
                    t0 = time.monotonic()
                    header = {
                        "off": sent, "len": len(buf), "crc": crc,
                    }
                    if seq is not None:
                        header["seq"] = seq
                    chunk(json.dumps(header).encode() + b"\n" + buf)
                    hist.observe(
                        "storage.repl_ship_s", time.monotonic() - t0
                    )
                    counters.inc("storage.repl.bytes_shipped", len(buf))
                    sent = chunk_end
            try:
                chunk(b"")  # terminal chunk only on orderly endings
                handler.wfile.write(b"\r\n")
            except OSError:
                pass
        except OSError:
            counters.inc("storage.repl.ship_errors")
