"""The port's replicated control plane (``controlplane/repl.py``,
``durable.py``'s replication half, ``httpserver.py``'s ``/repl/*``,
``remote.py``'s endpoints) on the CPU.

First the port's copies of JAX's ``tests/test_repl.py`` (all 20 tests,
under JAX's names): the quorum gate, real-HTTP shipping, any prefix of
shipped groups a valid store, follower resume, the kill-switch's
byte-identical parity, fencing, digest gossip, the ``fsck`` halves, the
``repl.ack`` fault point healing, an arbiter-majority election,
checkpoint generations, follower watch fanout, the typed resume-ahead
answers, ``/repl/status``, ``min_rv`` reads and the multi-endpoint
client.  The only change: the façade takes no ``faults=`` (its
``http.*`` points wait for ROADMAP item 8), so the ``repl.ack`` test arms
the leader store's fabric, which ``ReplRuntime`` reads.

Then the port against the JAX package, exact (bytes, rvs, names):

* a JAX leader (JAX ``ReplRuntime`` and façade) tailed by the port's
  ``WalFollower`` and a port leader tailed by JAX's: the follower's WAL
  is byte-equal to the leader's (``wal_compare``), the leader WAL equals
  the one the other package's leader writes for the same pinned
  workload, and ``state_digest`` is equal under both packages' ``fsck``;
* a follower reseeded from the other package's checkpoint generation
  (the leader compacts mid-stream);
* ``RemoteStore(endpoints=)`` of each package against the other's
  in-process plane: one transcript of answers, rvs and the endpoint each
  read and write went to.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import threading
import time
import urllib.parse

import pytest

from minisched_tpu_torch.api.objects import make_node, make_pod
from minisched_tpu_torch.controlplane.durable import DurableObjectStore
from minisched_tpu_torch.controlplane.fsck import (
    replica_consistent,
    state_digest,
    wal_compare,
    wal_digests,
)
from minisched_tpu_torch.controlplane.httpserver import start_api_server
from minisched_tpu_torch.controlplane.remote import RemoteClient, RemoteStore
from minisched_tpu_torch.controlplane.repl import (
    PeerSpec,
    ReplicationHub,
    ReplRuntime,
    WalFollower,
)
from minisched_tpu_torch.controlplane.store import (
    EventType,
    HistoryCompacted,
    NotLeader,
    NotYetObserved,
    ObjectStore,
    StorageDegraded,
)
from minisched_tpu_torch.faults import FaultFabric
from minisched_tpu_torch.observability import counters


def _wait(pred, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


class _Plane:
    """One in-process leader (hub attached, façade serving /repl/*) plus
    N real-HTTP followers — the smallest true replication topology."""

    def __init__(self, tmp_path, n_followers=2, cluster_size=3,
                 ack_timeout_s=10.0, faults=None):
        self.leader_wal = str(tmp_path / "leader.wal")
        self.leader = DurableObjectStore(self.leader_wal, fsync=True)
        self.runtime = ReplRuntime(
            self.leader, "r0", peers=[], cluster_size=cluster_size,
            ack_timeout_s=ack_timeout_s,
        )
        self.runtime.promote()
        # the port's façade has no faults= (http.* points wait for the
        # rest of faults/); the repl.* points read the store's fabric
        self.leader.faults = faults
        self.server, self.url, self._shutdown = start_api_server(
            self.leader, port=0, repl=self.runtime
        )
        self.followers = []
        for i in range(n_followers):
            fid = f"r{i + 1}"
            fstore = DurableObjectStore(
                str(tmp_path / f"{fid}.wal"), fsync=True
            )
            fstore.fence("r0")
            tail = WalFollower(fstore, self.url, fid)
            tail.start()
            self.followers.append((fid, fstore, tail))

    def converge(self, timeout_s=10.0):
        want = self.leader.resource_version
        _wait(
            lambda: all(
                f[1].resource_version >= want for f in self.followers
            ),
            timeout_s,
            f"followers to reach rv {want}",
        )

    def close(self):
        self._shutdown()
        for _fid, fstore, tail in self.followers:
            tail.stop()
        for _fid, fstore, tail in self.followers:
            tail.join(timeout=5.0)
            fstore.close()
        self.runtime.close()
        self.leader.close()


def test_quorum_gates_publish(tmp_path):
    """A cluster_size=3 leader owes ONE follower ack per group.  With
    no follower, the mutation fails typed (StorageDegraded), its bytes
    are truncated off the WAL (a reopen has never heard of it), and the
    stream epoch bumps so any follower that buffered the dead bytes
    resyncs.  With an acking follower, the same mutation commits."""
    path = str(tmp_path / "q.wal")
    store = DurableObjectStore(path, fsync=True)
    hub = ReplicationHub(path, cluster_size=3, ack_timeout_s=0.3)
    store.promote_leader(hub)
    epoch0 = hub.epoch
    counters.reset()
    with pytest.raises(StorageDegraded):
        store.create("Pod", make_pod("never-acked"))
    assert counters.get("storage.repl.quorum_timeouts") == 1
    assert hub.epoch == epoch0 + 1, "quorum failure must bump the epoch"
    # the failed group's bytes are gone: the WAL replays to empty
    re = DurableObjectStore(path)
    assert re.list("Pod") == []
    re.close()

    # now give the hub a live follower: acks arrive, so the degraded
    # store's recovery probe (itself a quorum-gated group) re-arms
    # writes and the same mutation commits
    stop_acks = threading.Event()

    def acker():
        while not stop_acks.is_set():
            hub.record_ack("r1", hub.durable_end)
            time.sleep(0.02)

    t = threading.Thread(target=acker, daemon=True)
    t.start()
    try:
        _wait(
            lambda: _recovered(store), 10.0, "degraded store to recover"
        )
        store.create("Pod", make_pod("acked"))
    finally:
        stop_acks.set()
        t.join()
    assert [p.metadata.name for p in store.list("Pod")] == ["acked"]
    hub.close()
    store.close()


def _recovered(store) -> bool:
    try:
        store.create("Node", make_node("probe"))
        store.delete("Node", "default", "probe")
        return True
    except StorageDegraded:
        return False
    except KeyError:
        return True


def test_ship_apply_ack_over_real_http(tmp_path):
    """Replication end to end: groups ship over /repl/stream, followers
    apply through the real recovery path and ack, the barrier's quorum
    wait is satisfied by real acks, and both replicas converge to the
    leader's exact state — rv-dense, WALs byte-identical."""
    counters.reset()
    plane = _Plane(tmp_path)
    try:
        client = RemoteClient(plane.url)
        for i in range(20):
            client.pods().create(make_pod(f"p-{i:03d}"))
        plane.converge()
        for fid, fstore, _tail in plane.followers:
            assert fstore.resource_version == plane.leader.resource_version
            assert len(fstore.list("Pod")) == 20, fid
            rvs = sorted(
                p.metadata.resource_version for p in fstore.list("Pod")
            )
            assert rvs == list(range(1, 21)), f"{fid} rv not dense"
        assert counters.get("storage.repl.groups") >= 1
        assert counters.get("storage.repl.applied_records") >= 40  # 2 × 20
        assert counters.get("storage.repl.resyncs") == 0
        acks = plane.runtime.hub.acks_snapshot()
        assert set(acks) == {"r1", "r2"}
    finally:
        plane.close()
    for fid, fstore, _tail in plane.followers:
        cmp = wal_compare(plane.leader_wal, fstore._path)
        assert cmp["identical"], f"{fid} WAL diverged: {cmp['diverged']}"


def test_any_prefix_of_shipped_groups_is_a_valid_store(tmp_path):
    """The GROUP-as-replication-unit property: replication ships whole
    commit groups in byte order, so EVERY group boundary is a valid
    recovery point — truncating the leader's WAL at any shipped-group
    edge replays cleanly to a dense-rv store (what a follower that has
    applied exactly k groups IS)."""
    path = str(tmp_path / "prefix.wal")
    store = DurableObjectStore(path, fsync=True)
    hub = ReplicationHub(path, cluster_size=1)  # no quorum owed
    store.promote_leader(hub)

    def burst(w: int) -> None:
        for i in range(10):
            store.create("Pod", make_pod(f"b{w}-{i:02d}"))

    threads = [
        threading.Thread(target=burst, args=(w,)) for w in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    digests = hub.digests_since(0)
    assert digests, "no groups recorded"
    store.close()
    with open(path, "rb") as f:
        full = f.read()
    assert digests[-1].end == len(full)
    prev_rv = 0
    for g in digests:
        trunc = str(tmp_path / f"prefix-{g.seq}.wal")
        with open(trunc, "wb") as f:
            f.write(full[: g.end])
        replica = DurableObjectStore(trunc)
        rv = replica.resource_version
        pods = replica.list("Pod")
        rvs = sorted(p.metadata.resource_version for p in pods)
        replica.close()
        assert rv > prev_rv, f"group {g.seq}: rv did not advance"
        assert rvs == list(range(1, rv + 1)), (
            f"group {g.seq}: prefix replay not rv-dense"
        )
        prev_rv = rv
    assert prev_rv == 40


def test_follower_resumes_from_own_offset(tmp_path):
    """A follower killed mid-tail reconnects with its WAL size as the
    cursor: the stream resumes exactly there (resumed_from > 0), no
    resync, no reapplied records — the WAL offset IS the bookkeeping."""
    counters.reset()
    plane = _Plane(tmp_path, n_followers=1, cluster_size=2)
    try:
        client = RemoteClient(plane.url)
        for i in range(5):
            client.pods().create(make_pod(f"a-{i}"))
        plane.converge()
        fid, fstore, tail = plane.followers[0]
        tail.stop()
        tail.join(timeout=5.0)
        mid_end = fstore.wal_end()
        assert mid_end > 0
        # writes continue: cluster_size=2 owes 1 follower ack, so feed
        # acks by hand while the follower is down
        feeder_stop = threading.Event()

        def feed():
            while not feeder_stop.is_set():
                plane.runtime.hub.record_ack("ghost", plane.runtime.hub.durable_end)
                time.sleep(0.02)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        for i in range(5):
            client.pods().create(make_pod(f"b-{i}"))
        feeder_stop.set()
        feeder.join()
        resumed = WalFollower(fstore, plane.url, fid)
        resumed.start()
        plane.followers[0] = (fid, fstore, resumed)
        plane.converge()
        assert resumed.resumed_from == mid_end
        assert counters.get("storage.repl.resyncs") == 0
        assert len(fstore.list("Pod")) == 10
    finally:
        plane.close()


def test_kill_switch_byte_identical_parity(tmp_path):
    """MINISCHED_REPL=0 semantics: a store with NO hub attached and a
    leader store with a single-replica hub (quorum_followers=0) write
    byte-identical WALs for the same workload — replication adds zero
    bytes, zero reordering, zero framing changes to the durable log."""
    pods = []
    for i in range(12):
        p = make_pod(f"par-{i:02d}", requests={"cpu": "100m"})
        p.metadata.uid = f"pin-{i:08d}"
        p.metadata.creation_timestamp = 1000.0 + i
        pods.append(p)

    plain_path = str(tmp_path / "plain.wal")
    plain = DurableObjectStore(plain_path, fsync=True)
    for p in pods:
        plain.create("Pod", p)
    plain.close()

    hub_path = str(tmp_path / "hubbed.wal")
    hubbed = DurableObjectStore(hub_path, fsync=True)
    hub = ReplicationHub(hub_path, cluster_size=1)
    hubbed.promote_leader(hub)
    for p in pods:
        hubbed.create("Pod", p)
    hub.close()
    hubbed.close()

    with open(plain_path, "rb") as f:
        a = f.read()
    with open(hub_path, "rb") as f:
        b = f.read()
    assert a == b, "hub attachment changed the WAL bytes"


def test_fencing_refuses_writes_typed(tmp_path):
    """A fenced (demoted / following) replica refuses every mutation
    with typed NotLeader: directly, over HTTP (503 with the not-leader
    marker), and through RemoteStore (typed, never blind-retried)."""
    store = DurableObjectStore(str(tmp_path / "f.wal"), fsync=True)
    store.fence("r9")
    counters.reset()
    with pytest.raises(NotLeader, match="not leader"):
        store.create("Pod", make_pod("refused"))
    assert counters.get("storage.repl.fenced_writes") == 1
    server, url, shutdown = start_api_server(store, port=0)
    try:
        client = RemoteClient(url)
        with pytest.raises(NotLeader):
            client.pods().create(make_pod("refused-remote"))
        assert counters.get("storage.repl.not_leader_errors") == 1
        # reads still serve: a fenced replica is a warm standby
        assert client.pods().list() == []
    finally:
        shutdown()
        store.close()


def test_digest_gossip_convicts_divergence_and_resyncs(tmp_path):
    """Post-apply divergence (a lying follower disk: the transit CRC
    passed, then a byte rotted) is caught by digest gossip — the
    follower convicts itself by comparing its own WAL bytes against the
    leader's ring, resyncs from zero, and converges back to identical."""
    counters.reset()
    plane = _Plane(tmp_path, n_followers=1, cluster_size=1)
    try:
        client = RemoteClient(plane.url)
        for i in range(6):
            client.pods().create(make_pod(f"g-{i}"))
        plane.converge()
        fid, fstore, tail = plane.followers[0]
        tail.stop()
        tail.join(timeout=5.0)
        # rot one byte in the follower's applied WAL, mid-file
        with open(fstore._path, "r+b") as f:
            f.seek(fstore.wal_end() // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x40]))
        probe = WalFollower(fstore, plane.url, fid)
        assert probe.gossip_once() is False
        assert counters.get("storage.repl.digest_mismatch") == 1
        assert counters.get("storage.repl.resyncs") == 1
        assert fstore.resource_version == 0, "resync must wipe state"
        assert fstore.wal_end() == 0
        probe.start()
        plane.followers[0] = (fid, fstore, probe)
        plane.converge()
        assert probe.gossip_once() is True
        assert len(fstore.list("Pod")) == 6
    finally:
        plane.close()
    cmp = wal_compare(plane.leader_wal, plane.followers[0][1]._path)
    assert cmp["identical"]


def test_fsck_digests_and_compare(tmp_path):
    """The offline halves: --digests emits per-frame CRC32C digests
    (composable to any grouping), --compare calls identical/prefix
    clean and locates the exact forked frame on divergence."""
    path = str(tmp_path / "d.wal")
    store = DurableObjectStore(path, fsync=True)
    for i in range(8):
        store.create("Pod", make_pod(f"d-{i}"))
    store.close()
    report = wal_digests(path)
    assert len(report["frames"]) >= 8  # puts + any watermarks
    assert report["frames"][-1]["end"] == report["size"]
    assert not report["torn_tail"] and "corrupt" not in report

    twin = str(tmp_path / "twin.wal")
    with open(path, "rb") as f:
        full = f.read()
    with open(twin, "wb") as f:
        f.write(full)
    assert wal_compare(path, twin)["identical"]

    prefix = str(tmp_path / "prefix.wal")
    with open(prefix, "wb") as f:
        f.write(full[: report["frames"][2]["end"]])
    cmp = wal_compare(path, prefix)
    assert cmp["prefix"] and not cmp["identical"]
    assert cmp["common_frames"] == 3

    forked = str(tmp_path / "forked.wal")
    rotten = bytearray(full)
    target = report["frames"][4]
    rotten[(target["offset"] + target["end"]) // 2] ^= 0x01
    with open(forked, "wb") as f:
        f.write(bytes(rotten))
    cmp = wal_compare(path, forked)
    assert not cmp["identical"] and not cmp["prefix"]
    assert cmp["diverged"]["frame"] == 4

    # the CLI contract: exit 0 on prefix, 1 on fork, 1 on corruption
    from minisched_tpu_torch.controlplane.fsck import main as fsck_main

    assert fsck_main([path, "--compare", prefix]) == 0
    assert fsck_main([path, "--compare", forked]) == 1
    assert fsck_main([forked, "--digests"]) == 1
    assert fsck_main([path, "--digests"]) == 0


def test_repl_ack_fault_heals_by_reack(tmp_path):
    """The ``repl.ack`` injection point: the leader discards a
    follower's ack (503) — durability is real but unproven.  The
    follower's heartbeat re-ack heals it, so the write completes and
    nothing is lost; the only symptom is a longer quorum wait."""
    fab = FaultFabric(7).on("repl.ack", rate=1.0, max_fires=2)
    counters.reset()
    plane = _Plane(
        tmp_path, n_followers=1, cluster_size=2, ack_timeout_s=20.0,
        faults=fab,
    )
    try:
        client = RemoteClient(plane.url, timeout_s=30.0)
        t0 = time.monotonic()
        client.pods().create(make_pod("survives-dropped-acks"))
        elapsed = time.monotonic() - t0
        assert fab.fires("repl.ack") >= 1
        assert counters.get("storage.repl.ship_errors") >= 1
        assert counters.get("storage.repl.quorum_timeouts") == 0
        plane.converge()
        assert len(plane.followers[0][1].list("Pod")) == 1
        assert elapsed < 20.0, "healed by re-ack, not by timeout"
    finally:
        plane.close()


def test_arbiter_majority_election(tmp_path):
    """Leaderless plane, all three arbiters reachable: the freshest
    replica (rv rank, ties broken to the lexically smaller id) wins the
    store-leader lease on an arbiter MAJORITY and promotes; the other
    stays a follower pointed at the winner.  Exactly one leader."""
    arbiters = []
    for _ in range(3):
        _srv, url, shutdown = start_api_server(ObjectStore(), port=0)
        arbiters.append((url, shutdown))
    runtimes = []
    servers = []
    try:
        # r0 is DEAD (its data plane never answers; its arbiter — a
        # separate in-memory store — is still up, so a majority of
        # arbiters is reachable); r1 and r2 boot post-crash with no
        # bootstrap leader and live data façades (freshness ranking
        # reads /repl/status off them)
        for rid in ("r1", "r2"):
            store = DurableObjectStore(
                str(tmp_path / f"{rid}.wal"), fsync=True
            )
            rt = ReplRuntime(
                store, rid, peers=[], cluster_size=3, ttl_s=0.5
            )
            _srv, url, shutdown = start_api_server(store, port=0, repl=rt)
            servers.append(shutdown)
            runtimes.append((rid, store, rt, url))
        peers = [PeerSpec("r0", "http://127.0.0.1:9", arbiters[0][0])]
        peers += [
            PeerSpec(rid, url, arbiters[i + 1][0])
            for i, (rid, _s, _rt, url) in enumerate(runtimes)
        ]
        for _rid, _store, rt, _url in runtimes:
            rt.peers = list(peers)
            rt.start(bootstrap_leader=None)
        _wait(
            lambda: sorted(
                rt.role for _rid, _s, rt, _u in runtimes
            ) == ["follower", "leader"],
            timeout_s=10.0,
            what="exactly one leader elected",
        )
        leaders = [
            rid for rid, _s, rt, _u in runtimes if rt.role == "leader"
        ]
        assert leaders == ["r1"], "freshness tie must break to r1"
        follower_rt = runtimes[1][2]
        _wait(
            lambda: follower_rt.leader_id == "r1",
            timeout_s=5.0,
            what="r2 to observe r1 leading",
        )
        assert runtimes[1][1].is_fenced()
    finally:
        for _rid, store, rt, _u in runtimes:
            rt.close()
        for shutdown in servers:
            shutdown()
        for _rid, store, rt, _u in runtimes:
            store.close()
        for _url, shutdown in arbiters:
            shutdown()


def test_compaction_ships_checkpoint_generation(tmp_path):
    """DESIGN.md §28: the LEADER compacts while followers tail.
    Compaction publishes a checkpoint generation (epoch restart, WAL
    truncated to zero), both followers reseed from the shipped blob —
    never by re-tailing offset 0 — and the plane converges with every
    replica's WAL holding only the post-compaction tail."""
    counters.reset()
    plane = _Plane(tmp_path)
    try:
        client = RemoteClient(plane.url)
        for i in range(8):
            client.pods().create(make_pod(f"pre-{i}"))
        plane.converge()
        pre_end = plane.leader.wal_end()
        assert pre_end > 0
        plane.leader.compact()
        hub = plane.runtime.hub
        assert plane.leader.wal_end() == 0, "compaction must bound the WAL"
        assert hub.ckpt_gen == 1
        assert hub.ckpt_rv == plane.leader.resource_version
        assert counters.get("storage.repl.ckpt_published") == 1
        assert counters.get("storage.repl.compact_deferred") == 0, (
            "the deferral is retired: a leading replica compacts"
        )
        # writes continue through the new generation: the first one
        # blocks on quorum until a follower has reseeded and re-acked
        for i in range(8):
            client.pods().create(make_pod(f"post-{i}"))
        plane.converge()
        for fid, fstore, _tail in plane.followers:
            assert fstore.resource_version == plane.leader.resource_version
            assert len(fstore.list("Pod")) == 16, fid
            assert fstore.checkpoint_rv == hub.ckpt_rv, (
                f"{fid} must be seeded at the shipped generation"
            )
            assert fstore.wal_end() == plane.leader.wal_end(), (
                f"{fid} WAL must hold only the post-compaction tail"
            )
        assert counters.get("storage.repl.ckpt_seeds") == 2
        assert counters.get("storage.repl.full_retails") == 0, (
            "zero offset-0 re-tails"
        )
        assert counters.get("storage.repl.ckpt_ships") == 2
        assert counters.get("storage.repl.ckpt_bytes") > 0
    finally:
        plane.close()
    # seeded follower vs leader: same tail bytes, raw-comparable
    for fid, fstore, _tail in plane.followers:
        cmp = wal_compare(plane.leader_wal, fstore._path)
        assert cmp["identical"], f"{fid} tail diverged: {cmp['diverged']}"


def test_promote_advertises_existing_checkpoint(tmp_path):
    """A replica that compacted in a PREVIOUS life and is promoted now
    must advertise its on-disk checkpoint as generation >= 1 — a fresh
    follower seeds from it instead of tailing a WAL whose first byte is
    not history's first byte (the latent partial-state trap)."""
    path = str(tmp_path / "seed.wal")
    store = DurableObjectStore(path, fsync=True)
    for i in range(6):
        store.create("Pod", make_pod(f"s-{i}"))
    store.compact()  # hubless compaction, then a clean restart
    store.close()

    counters.reset()
    leader = DurableObjectStore(path, fsync=True)
    runtime = ReplRuntime(leader, "r0", peers=[], cluster_size=2)
    runtime.promote()
    hub = runtime.hub
    assert hub.ckpt_gen >= 1, "pre-existing checkpoint must be advertised"
    assert hub.ckpt_rv == 6
    server, url, shutdown = start_api_server(leader, port=0, repl=runtime)
    fstore = DurableObjectStore(str(tmp_path / "f.wal"), fsync=True)
    fstore.fence("r0")
    tail = WalFollower(fstore, url, "r1", leader_id="r0")
    tail.start()
    try:
        _wait(
            lambda: fstore.resource_version >= 6, 10.0,
            "fresh follower to bootstrap from the shipped checkpoint",
        )
        assert len(fstore.list("Pod")) == 6
        assert fstore.checkpoint_rv == 6
        assert counters.get("storage.repl.ckpt_seeds") == 1
        assert counters.get("storage.repl.full_retails") == 0
        # and the stream is live: the next write replicates normally
        leader.create("Pod", make_pod("after-promote"))
        _wait(
            lambda: fstore.resource_version
            == leader.resource_version,
            10.0, "follower to tail past the seed",
        )
        assert len(fstore.list("Pod")) == 7
    finally:
        shutdown()
        tail.stop()
        tail.join(timeout=5.0)
        runtime.close()
        leader.close()
        fstore.close()


def test_checkpoint_plus_any_prefix_replays_identically(tmp_path):
    """The generation-replay property: checkpoint-gen-N ⊕ any prefix of
    post-compaction commit groups replays BIT-IDENTICALLY (canonical
    state digest) to a full-history replay of the same mutations — so a
    follower seeded from the shipped blob at any group boundary holds
    exactly the store a from-genesis replica would.  Also the fsck
    ``--compare`` state arm: checkpoint⊕tail vs full-history WALs share
    no bytes, yet replica_consistent calls them consistent."""
    path = str(tmp_path / "gen.wal")
    store = DurableObjectStore(path, fsync=True, archive_compacted=True)
    hub = ReplicationHub(path, cluster_size=1)  # no quorum owed
    store.promote_leader(hub)
    for i in range(10):
        store.create("Pod", make_pod(f"pre-{i:02d}"))
    store.compact()  # generation 1: WAL restarts, history archived
    assert hub.ckpt_gen == 1 and hub.ckpt_rv == 10

    def burst(w: int) -> None:
        for i in range(5):
            store.create("Pod", make_pod(f"g{w}-{i:02d}"))

    threads = [
        threading.Thread(target=burst, args=(w,)) for w in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    groups = hub.digests_since(0)
    assert groups, "no post-compaction groups recorded"
    store.close()
    with open(path, "rb") as f:
        tail = f.read()
    with open(path + ".history", "rb") as f:
        history = f.read()
    assert groups[-1].end == len(tail)

    for k, end in enumerate([0] + [g.end for g in groups]):
        rdir = tmp_path / f"boundary-{k}"
        rdir.mkdir()
        # the seeded replica: shipped checkpoint pair ⊕ k groups of tail
        rwal = str(rdir / "replica.wal")
        shutil.copy(path + ".ckpt", rwal + ".ckpt")
        shutil.copy(path + ".ckpt.sha256", rwal + ".ckpt.sha256")
        with open(rwal, "wb") as f:
            f.write(tail[:end])
        # the reference: full mutation history ⊕ the same prefix, no
        # checkpoint anywhere — replay from genesis
        fwal = str(rdir / "full.wal")
        with open(fwal, "wb") as f:
            f.write(history + tail[:end])
        a = state_digest(rwal)
        b = state_digest(fwal)
        assert "error" not in a, f"boundary {k}: {a}"
        assert "error" not in b, f"boundary {k}: {b}"
        assert a["resource_version"] == b["resource_version"]
        assert a["sha256"] == b["sha256"], (
            f"boundary {k}: seeded replay diverged from full-history "
            f"replay at rv {a['resource_version']}"
        )
        report = replica_consistent(rwal, fwal)
        if end > 0:
            # the seeded WAL's first byte is mid-history: no shared
            # bytes, so consistency must come from the state replay arm
            assert report["mode"] == "state"
        assert report["consistent"], f"boundary {k}: {report}"
    assert a["resource_version"] == 30


# ---------------------------------------------------------------------------
# DESIGN.md §29: the follower-serving read plane — rv-bounded
# reads, typed NotYetObserved, live watch fanout on replicas, and the
# multi-endpoint client's leader routing + watch failover.
# ---------------------------------------------------------------------------


class _ServedPlane(_Plane):
    """_Plane plus an HTTP façade (follower ReplRuntime attached, so
    ``/repl/status`` answers with role/leader_hint) in front of every
    follower — the read topology endpoint-aware clients route across."""

    def __init__(self, tmp_path, n_followers=2, cluster_size=3, **kw):
        super().__init__(
            tmp_path, n_followers=n_followers, cluster_size=cluster_size,
            **kw,
        )
        self.fservers = []
        for fid, fstore, _tail in self.followers:
            frt = ReplRuntime(fstore, fid, peers=[], cluster_size=cluster_size)
            frt.leader_id = "r0"
            _srv, furl, fshutdown = start_api_server(
                fstore, port=0, repl=frt
            )
            self.fservers.append((fid, furl, fshutdown, frt))

    def follower_urls(self):
        return [furl for _fid, furl, _sd, _rt in self.fservers]

    def close(self):
        for _fid, _furl, fshutdown, frt in self.fservers:
            fshutdown()
            frt.close()
        super().close()


def _http_get(base_url, path):
    """(status, headers dict, body bytes) — raw wire access so tests can
    see the X-Minisched-RV stamp RemoteStore's decode layer hides."""
    u = urllib.parse.urlparse(base_url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, dict(resp.getheaders()), body
    finally:
        conn.close()


def test_follower_live_watch_fanout(tmp_path):
    """The store half of the read plane: a watch attached to a FOLLOWER store
    observes replicated mutations live (apply_replicated fans groups
    into watcher queues, not just the resume history ring), in rv order,
    and the follower's COW read plane republishes per group."""
    plane = _Plane(tmp_path, n_followers=1)
    try:
        _fid, fstore, _tail = plane.followers[0]
        w, _snap = fstore.watch("Pod", send_initial=False)
        for i in range(3):
            plane.leader.create("Pod", make_pod(f"live-{i}"))
        plane.converge()
        events = [w.next(timeout=5.0) for _ in range(3)]
        assert all(ev is not None for ev in events), "follower watch is deaf"
        assert [ev.obj.metadata.name for ev in events] == [
            "live-0", "live-1", "live-2"
        ]
        assert all(ev.type == EventType.ADDED for ev in events)
        rvs = [ev.rv for ev in events]
        assert rvs == sorted(rvs) and rvs[0] > 0
        plane.leader.delete("Pod", "default", "live-1")
        plane.converge()
        ev = w.next(timeout=5.0)
        assert ev is not None and ev.type == EventType.DELETED
        assert ev.obj.metadata.name == "live-1"
        # the COW snapshot republished too: lock-free reads see the group
        assert {p.metadata.name for p in fstore.list("Pod")} == {
            "live-0", "live-2"
        }
        w.stop()
    finally:
        plane.close()


def test_watch_resume_ahead_is_typed_by_role(tmp_path):
    """Resuming ABOVE the server's applied rv forks on role: a fenced
    replica is merely behind (NotYetObserved — retryable, the client
    waits or fails over), an unfenced leader can only mean the client's
    rv came from a crashed-and-rolled-back future (HistoryCompacted —
    relist).  Never a silent stall, never a bogus relist on mere lag."""
    store = DurableObjectStore(str(tmp_path / "role.wal"), fsync=False)
    store.create("Pod", make_pod("seed"))
    rv = store.resource_version
    with pytest.raises(HistoryCompacted):
        store.watch("Pod", resume_rv=rv + 10)
    store.fence("r0")
    with pytest.raises(NotYetObserved):
        store.watch("Pod", resume_rv=rv + 10)
    # at-or-below applied rv a fenced replica resumes normally
    w, _snap = store.watch("Pod", resume_rv=rv)
    assert w.next(timeout=0.2) is None
    w.stop()
    store.close()


def test_checkpoint_seed_floors_follower_history(tmp_path):
    """Regression: a checkpoint-seeded replica must floor
    its watch-resume history at the seed rv — events at/below the
    snapshot are not reconstructable, so resuming below it is a typed
    410 relist, never an empty-but-wrong replay."""
    leader = DurableObjectStore(str(tmp_path / "cl.wal"), fsync=True)
    for i in range(6):
        leader.create("Pod", make_pod(f"c-{i}"))
    leader.compact()
    ckpt_rv = leader.resource_version
    blob = leader.checkpoint_ship_blob()
    assert blob is not None and blob["rv"] == ckpt_rv
    fstore = DurableObjectStore(str(tmp_path / "cf.wal"), fsync=True)
    fstore.fence("r0")
    fstore.replica_reset(seed=blob)
    assert fstore.resource_version == ckpt_rv
    assert len(fstore.list("Pod")) == 6
    with pytest.raises(HistoryCompacted):
        fstore.watch("Pod", resume_rv=ckpt_rv - 1)
    # exactly AT the seed rv: clean resume, empty replay
    w, _snap = fstore.watch("Pod", resume_rv=ckpt_rv)
    assert w.next(timeout=0.2) is None
    w.stop()
    # and ABOVE the applied rv the fenced replica is typed-retryable
    with pytest.raises(NotYetObserved):
        fstore.watch("Pod", resume_rv=ckpt_rv + 3)
    fstore.close()
    leader.close()


def test_repl_status_applied_rv_and_leader_hint(tmp_path):
    """/repl/status carries the read-routing fields — the
    replica's applied rv (what its read plane serves NOW) and the best
    leader hint for write routing — on both roles, and the follower
    exports its apply lag as a gauge."""
    counters.reset()
    plane = _ServedPlane(tmp_path, n_followers=1)
    try:
        client = RemoteClient(plane.url)
        for i in range(3):
            client.pods().create(make_pod(f"st-{i}"))
        plane.converge()
        st, _hdrs, body = _http_get(plane.url, "/repl/status")
        assert st == 200
        doc = json.loads(body)
        assert doc["role"] == "leader"
        assert doc["leader_hint"] == "r0"
        assert doc["applied_rv"] == plane.leader.resource_version
        fst, _fh, fbody = _http_get(
            plane.follower_urls()[0], "/repl/status"
        )
        assert fst == 200
        fdoc = json.loads(fbody)
        assert fdoc["role"] == "follower"
        assert fdoc["fenced"] is True
        assert fdoc["leader_hint"] == "r0"
        assert fdoc["applied_rv"] == doc["applied_rv"], "converged plane"
        # the tail noted its lag after the last applied group: caught up
        assert counters.get("storage.repl.apply_lag_rv") == 0
    finally:
        plane.close()


def test_http_min_rv_bound_and_rv_header(tmp_path):
    """The wire half of rv-bounded reads: every read answer carries the
    X-Minisched-RV watermark; a ``min_rv`` above the replica's applied
    rv is a typed 504 (``not yet observed``), counted, and surfaced to
    RemoteStore callers as NotYetObserved — never a silently stale 200."""
    counters.reset()
    store = DurableObjectStore(str(tmp_path / "wire.wal"), fsync=False)
    _srv, url, shutdown = start_api_server(store, port=0)
    try:
        client = RemoteClient(url)
        for i in range(4):
            client.pods().create(make_pod(f"b-{i}"))
        rv = store.resource_version
        # satisfiable bound: 200, stamped at least as fresh as the bound
        st, hdrs, body = _http_get(url, f"/api/v1/pods?min_rv={rv}")
        assert st == 200
        assert int(hdrs["X-Minisched-RV"]) >= rv
        assert len(json.loads(body)["items"]) == 4
        assert counters.get("wire.read.bounded_requests") == 1
        # unstamped reads still carry the watermark (list + named get)
        _st, hdrs2, _b = _http_get(url, "/api/v1/pods")
        assert int(hdrs2["X-Minisched-RV"]) >= rv
        _st, hdrs3, _b = _http_get(
            url, "/api/v1/namespaces/default/pods/b-0"
        )
        assert int(hdrs3["X-Minisched-RV"]) >= rv
        # unsatisfiable bound: typed 504, watermark says how far behind
        st, hdrs4, body4 = _http_get(url, f"/api/v1/pods?min_rv={rv + 100}")
        assert st == 504
        assert b"not yet observed" in body4
        assert int(hdrs4["X-Minisched-RV"]) == rv
        assert counters.get("wire.read.not_yet_observed") == 1
        # and the typed client exception
        rs = RemoteStore(url, retries=0)
        with pytest.raises(NotYetObserved):
            rs._req("GET", f"/api/v1/pods?min_rv={rv + 100}")
        rs.close()
    finally:
        shutdown()
        store.close()


def test_multi_endpoint_client_routes_and_reads(tmp_path):
    """The client half of the read plane: a RemoteStore pointed at a
    FOLLOWER with the full endpoint list discovers the leader via
    /repl/status and routes writes there; reads ride the follower with
    the session-rv bound, so read-your-writes holds once the follower
    converges.  A single-endpoint store stays byte-identical (inert)."""
    counters.reset()
    plane = _ServedPlane(tmp_path, n_followers=2)
    try:
        furls = plane.follower_urls()
        rs = RemoteStore(
            furls[0], endpoints=[furls[1], plane.url],
            timeout_s=10.0,
        )
        assert rs._multi and rs._read_base == furls[0]
        created = rs.create("Pod", make_pod("routed-1"))
        assert created.metadata.resource_version > 0
        assert rs._leader_base == plane.url, "writes must find the leader"
        assert counters.get("remote.leader_discoveries") >= 1
        assert rs.session_rv >= created.metadata.resource_version, (
            "acked write must advance the session floor"
        )
        # the bounded read blocks on convergence semantics: retried
        # against the follower until its applied rv passes the floor
        pods, rv = rs.list_with_rv("Pod")
        assert [p.metadata.name for p in pods] == ["routed-1"]
        assert rv >= created.metadata.resource_version
        assert rs._read_base in furls, "reads must stay on followers"
        rs.close()
    finally:
        plane.close()


def test_watch_failover_resumes_exactly_once(tmp_path):
    """Kill the replica serving a watch stream mid-flight and resume at
    the last delivered rv through the endpoint-aware store: the rotated
    replica replays exactly the rv>resume suffix — the prefix/tail union
    has no duplicate and no gap (exactly-once across the failover)."""
    counters.reset()
    plane = _ServedPlane(tmp_path, n_followers=2)
    try:
        furls = plane.follower_urls()
        client = RemoteClient(plane.url)
        for i in range(3):
            client.pods().create(make_pod(f"pre-{i}"))
        plane.converge()
        rs = RemoteStore(
            furls[0], endpoints=[furls[1]], timeout_s=10.0,
        )
        w, snap = rs.watch("Pod")
        prefix = [w.next(timeout=5.0) for _ in range(len(snap))]
        assert all(ev is not None for ev in prefix)
        last_rv = max(ev.rv for ev in prefix)
        # the serving follower dies; more writes land on the survivors
        fid0, furl0, fshutdown0, frt0 = plane.fservers[0]
        fshutdown0()
        for i in range(3):
            client.pods().create(make_pod(f"post-{i}"))
        plane.converge()
        w.stop()
        w2, _ = rs.watch("Pod", resume_rv=last_rv)
        tail = [w2.next(timeout=5.0) for _ in range(3)]
        assert all(ev is not None for ev in tail)
        assert counters.get("remote.watch_failover") >= 1
        assert rs._read_base == furls[1]
        tail_rvs = [ev.rv for ev in tail]
        assert all(rv > last_rv for rv in tail_rvs), "duplicate replay"
        assert tail_rvs == sorted(tail_rvs)
        names = {ev.obj.metadata.name for ev in prefix} | {
            ev.obj.metadata.name for ev in tail
        }
        assert names == {f"pre-{i}" for i in range(3)} | {
            f"post-{i}" for i in range(3)
        }, "gap across the failover"
        assert w2.next(timeout=0.2) is None, "over-replay past the tail"
        w2.stop()
        rs.close()
    finally:
        plane.close()


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

from minisched_tpu.api import objects as jobj  # noqa: E402
from minisched_tpu.controlplane import durable as jdurable  # noqa: E402
from minisched_tpu.controlplane import fsck as jfsck  # noqa: E402
from minisched_tpu.controlplane import httpserver as jhttp  # noqa: E402
from minisched_tpu.controlplane import remote as jremote  # noqa: E402
from minisched_tpu.controlplane import repl as jrepl  # noqa: E402
from minisched_tpu.observability import counters as jcounters  # noqa: E402

from minisched_tpu_torch.api import objects as tobj  # noqa: E402
from minisched_tpu_torch.controlplane import durable as tdurable  # noqa: E402
from minisched_tpu_torch.controlplane import fsck as tfsck  # noqa: E402
from minisched_tpu_torch.controlplane import httpserver as thttp  # noqa: E402
from minisched_tpu_torch.controlplane import remote as tremote  # noqa: E402
from minisched_tpu_torch.controlplane import repl as trepl  # noqa: E402

#: per package: objects, durable, façade, repl, remote, fsck, counters
SIDES = {
    "jax": (jobj, jdurable, jhttp, jrepl, jremote, jfsck, jcounters),
    "port": (tobj, tdurable, thttp, trepl, tremote, tfsck, counters),
}
CROSS = [("jax", "port"), ("port", "jax")]


def _pinned_pods(objs, prefix, n, start=0):
    """Pods whose uid and creation time are pinned, so two packages'
    stores write the same WAL bytes for them."""
    pods = []
    for i in range(start, start + n):
        p = objs.make_pod(f"{prefix}-{i:03d}", requests={"cpu": "100m"})
        p.metadata.uid = f"pin-{i:08d}"
        p.metadata.creation_timestamp = 1000.0 + i
        pods.append(p)
    return pods


class _SidePlane:
    """A leader of ``leader_side`` (hub, ``ReplRuntime`` and façade) with
    one ``WalFollower`` per entry of ``follower_sides``, each of its own
    package, tailing it over real HTTP."""

    def __init__(self, tmp_path, leader_side, follower_sides,
                 cluster_size=2):
        _o, durable, http, repl = SIDES[leader_side][:4]
        tmp_path.mkdir(parents=True, exist_ok=True)
        self.leader_wal = str(tmp_path / f"{leader_side}-leader.wal")
        self.leader = durable.DurableObjectStore(self.leader_wal)
        self.runtime = repl.ReplRuntime(self.leader, "r0", peers=[],
                                        cluster_size=cluster_size,
                                        ack_timeout_s=10.0)
        self.runtime.promote()
        _srv, self.url, self._shutdown = http.start_api_server(
            self.leader, port=0, repl=self.runtime)
        self.followers = []
        for i, side in enumerate(follower_sides):
            fid = f"r{i + 1}"
            fstore = SIDES[side][1].DurableObjectStore(
                str(tmp_path / f"{side}-{fid}.wal"))
            fstore.fence("r0")
            tail = SIDES[side][3].WalFollower(fstore, self.url, fid,
                                              leader_id="r0")
            tail.start()
            self.followers.append((fid, fstore, tail))

    def converge(self, timeout_s=10.0):
        want = self.leader.resource_version
        _wait(lambda: all(f[1].resource_version >= want
                          for f in self.followers),
              timeout_s, f"followers to reach rv {want}")

    def close(self):
        self._shutdown()
        for _fid, _fstore, tail in self.followers:
            tail.stop()
        for _fid, fstore, tail in self.followers:
            tail.join(timeout=5.0)
            fstore.close()
        self.runtime.close()
        self.leader.close()


def _listing(side, store):
    codec = (jdurable if side == "jax" else tdurable)
    return {kind: sorted((o.metadata.key, json.dumps(codec._encode(o)))
                         for o in store.list(kind))
            for kind in ("Node", "Pod")}


def _cross_run(tmp_path, leader_side, follower_side):
    """Pinned creates, a delete and a bind-shaped update through the
    leader's store; the followers' WALs and states once converged."""
    objs = SIDES[leader_side][0]
    plane = _SidePlane(tmp_path, leader_side, [follower_side])
    try:
        node = objs.make_node("n1")
        node.metadata.uid, node.metadata.creation_timestamp = "pin-n1", 999.0
        plane.leader.create("Node", node)
        for p in _pinned_pods(objs, "x", 12):
            plane.leader.create("Pod", p)
        plane.leader.delete("Pod", "default", "x-003")
        bound = plane.leader.get("Pod", "default", "x-004")
        bound.spec.node_name = "n1"
        plane.leader.update("Pod", bound)
        plane.converge()
        fid, fstore, tail = plane.followers[0]
        # the follower's store serves the leader's objects
        views = (_listing(leader_side, plane.leader),
                 _listing(follower_side, fstore))
        rvs = (plane.leader.resource_version, fstore.resource_version)
        fwal = fstore._path
    finally:
        plane.close()
    return plane.leader_wal, fwal, views, rvs


@pytest.mark.parametrize("leader_side, follower_side", CROSS)
def test_cross_package_follower_tails_byte_equal(tmp_path, leader_side,
                                                 follower_side):
    """One package's leader, the other's follower: the follower's WAL is
    the leader's byte for byte, its store lists the same objects at the
    same rv, ``state_digest`` is equal under both packages' ``fsck``, and
    the leader's WAL equals the one the other package's leader writes
    for the same workload (replayed through the same-package pair)."""
    lwal, fwal, views, rvs = _cross_run(tmp_path / "x", leader_side,
                                        follower_side)
    assert views[0] == views[1] and rvs[0] == rvs[1] == 15
    for fsck_mod in (jfsck, tfsck):
        cmp = fsck_mod.wal_compare(lwal, fwal)
        assert cmp["identical"], cmp
    digests = {fsck_mod.state_digest(p)["sha256"]
               for fsck_mod in (jfsck, tfsck) for p in (lwal, fwal)}
    assert len(digests) == 1
    # the other package leading its own follower writes the same bytes
    other = follower_side
    olwal, ofwal, _views, orvs = _cross_run(tmp_path / "o", other, other)
    assert orvs == rvs
    with open(lwal, "rb") as a, open(olwal, "rb") as b:
        assert a.read() == b.read()
    assert tfsck.wal_compare(fwal, ofwal)["identical"]


@pytest.mark.parametrize("leader_side, follower_side", CROSS)
def test_cross_package_follower_reseeds_from_checkpoint_generation(
        tmp_path, leader_side, follower_side):
    """A leader of one package compacts mid-stream: the follower of the
    other package reseeds from the shipped checkpoint generation (never
    an offset-0 re-tail), tails the new WAL, and ends with the leader's
    objects, rv, checkpoint rv and WAL tail bytes; ``state_digest`` is
    equal under both packages' ``fsck``."""
    objs = SIDES[leader_side][0]
    fcounters = SIDES[follower_side][6]
    fcounters.reset()
    plane = _SidePlane(tmp_path, leader_side, [follower_side])
    try:
        for p in _pinned_pods(objs, "pre", 8):
            plane.leader.create("Pod", p)
        plane.converge()
        plane.leader.compact()
        assert plane.runtime.hub.ckpt_gen == 1
        for p in _pinned_pods(objs, "post", 8, start=8):
            plane.leader.create("Pod", p)
        plane.converge()
        _fid, fstore, _tail = plane.followers[0]
        assert fstore.checkpoint_rv == plane.runtime.hub.ckpt_rv == 8
        assert _listing(leader_side, plane.leader) == \
            _listing(follower_side, fstore)
        assert fstore.resource_version == plane.leader.resource_version
        assert fcounters.get("storage.repl.ckpt_seeds") == 1
        assert fcounters.get("storage.repl.full_retails") == 0
        fwal = fstore._path
    finally:
        plane.close()
    assert tfsck.wal_compare(plane.leader_wal, fwal)["identical"]
    assert jfsck.wal_compare(plane.leader_wal, fwal)["identical"]
    digests = {fsck_mod.state_digest(p)["sha256"]
               for fsck_mod in (jfsck, tfsck)
               for p in (plane.leader_wal, fwal)}
    assert len(digests) == 1


def _served_plane(tmp_path, side):
    """An in-process plane of one package: a leader and two followers,
    each behind its own façade (the followers with a follower
    ``ReplRuntime``, so ``/repl/status`` answers with the leader hint)."""
    _o, durable, http, repl = SIDES[side][:4]
    plane = _SidePlane(tmp_path, side, [side, side], cluster_size=3)
    plane.fservers = []
    for fid, fstore, _tail in plane.followers:
        frt = repl.ReplRuntime(fstore, fid, peers=[], cluster_size=3)
        frt.leader_id = "r0"
        _srv, furl, fshutdown = http.start_api_server(fstore, port=0,
                                                      repl=frt)
        plane.fservers.append((fid, furl, fshutdown, frt))
    return plane


def _close_served(plane):
    for _fid, _furl, fshutdown, frt in plane.fservers:
        fshutdown()
        frt.close()
    plane.close()


def endpoints_script(tmp_path, client_side, server_side):
    """``client_side``'s ``RemoteStore`` pointed at a follower of
    ``server_side``'s plane with every endpoint listed: the transcript of
    answers, rvs and which endpoint (0, 1: followers; 2: the leader)
    served the writes and the reads, through the loss of the follower
    the reads started on."""
    objs, _d, _h, _r, rmod = SIDES[client_side][:5]
    plane = _served_plane(tmp_path, server_side)
    out = []
    try:
        urls = [f[1] for f in plane.fservers] + [plane.url]
        rs = rmod.RemoteStore(urls[0], endpoints=urls[1:], timeout_s=10.0)
        where = lambda base: urls.index(base) if base in urls else None
        created = [rs.create("Pod", p) for p in _pinned_pods(objs, "e", 4)]
        out.append(("created", [(p.metadata.name, p.metadata.resource_version)
                                for p in created],
                    where(rs._leader_base), rs.session_rv))
        # both followers applied the creates: a follower still behind the
        # session rv answers 504 and the read rotates, which is right but
        # makes the transcript depend on the replication lag
        plane.converge()
        pods, rv = rs.list_with_rv("Pod")
        out.append(("list", sorted(p.metadata.name for p in pods), rv,
                    where(rs._read_base)))
        got = rs.get("Pod", "default", "e-001")
        out.append(("get", got.metadata.name, got.metadata.resource_version))
        w, snap = rs.watch("Pod")
        seen = []
        deadline = time.monotonic() + 10.0
        while len(seen) < len(snap) and time.monotonic() < deadline:
            seen.extend(w.next_batch(timeout=0.2))
        last_rv = max(ev.rv for ev in seen)
        out.append(("watch", len(snap), sorted(ev.rv for ev in seen)))
        # the follower serving reads and the watch dies
        plane.fservers[0][2]()
        w.stop()
        for p in _pinned_pods(objs, "f", 2, start=4):
            rs.create("Pod", p)
        rs.delete("Pod", "default", "e-000")
        plane.converge()
        pods, rv = rs.list_with_rv("Pod")
        out.append(("after", sorted(p.metadata.name for p in pods), rv,
                    where(rs._read_base), where(rs._leader_base)))
        w2, snap2 = rs.watch("Pod", resume_rv=last_rv)
        tail = []
        deadline = time.monotonic() + 10.0
        while len(tail) < 3 and time.monotonic() < deadline:
            tail.extend(w2.next_batch(timeout=0.2))
        w2.stop()
        out.append(("resume", snap2, [(ev.type.value, ev.obj.metadata.name,
                                       ev.rv) for ev in tail],
                    where(rs._read_base)))
        try:
            rs._req("GET", f"/api/v1/pods?min_rv={rv + 100}")
            out.append(("ahead", None))
        except Exception as e:  # noqa: BLE001 - the type is the answer
            out.append(("ahead", type(e).__name__))
        rs.close()
    finally:
        _close_served(plane)
    return out


@pytest.mark.parametrize("client_side, server_side",
                         CROSS + [("port", "port")])
def test_endpoints_client_against_either_plane_answers_as_jax(
        tmp_path, client_side, server_side):
    """The endpoints script's transcript equals JAX's client against
    JAX's plane, whichever package plays client and plane: writes found
    the leader, reads stayed on followers and rotated off the dead one,
    the resumed watch rotated off the dead follower and replayed exactly
    the events after its rv."""
    want = endpoints_script(tmp_path / "want", "jax", "jax")
    got = endpoints_script(tmp_path / "got", client_side, server_side)
    assert got == want
    assert want[0][2] == 2 and want[1][3] == 0
    # the dead façade's kept-alive socket still answers the list; the
    # watch needs a new connection, refused there, and rotates
    assert want[4][4] == 2 and want[5][3] == 1
    assert [name for _t, name, _rv in want[5][2]] == ["f-004", "f-005",
                                                      "e-000"]
    assert want[6] == ("ahead", "NotYetObserved")


@pytest.mark.parametrize("follower_side", ["port", "jax"])
def test_forked_tail_below_the_leader_end_resyncs(tmp_path, follower_side):
    """An ex-leader's last group that no follower received, on a WAL
    shorter than the new leader's: the follower's cursor sits inside a
    frame of the leader's log, so the shipped range does not decode.  The
    port's follower resyncs (``storage.repl.forked_tail``) and converges
    byte-equal; JAX's follower (the reference) retries the same range and
    stays stuck behind, its ``last_error`` naming the bad frame (ROADMAP
    §3)."""
    objs = tobj
    fcounters = SIDES[follower_side][6]
    fcounters.reset()
    plane = _SidePlane(tmp_path, "port", [follower_side], cluster_size=1)
    try:
        for p in _pinned_pods(objs, "a", 4):
            plane.leader.create("Pod", p)
        plane.converge()
        _fid, fstore, tail = plane.followers[0]
        tail.stop()
        tail.join(timeout=5.0)
        # the ex-leader's unshipped group: one framed put at the end
        rogue = SIDES[follower_side][0].make_pod("rogue")
        rogue.metadata.uid, rogue.metadata.resource_version = "pin-rogue", 5
        frame = tdurable.encode_frame(json.dumps({
            "op": "put", "kind": "Pod",
            "obj": tdurable._encode(rogue)}).encode())
        fstore.apply_replicated(frame, start_offset=fstore.wal_end())
        for p in _pinned_pods(objs, "b", 8, start=4):
            plane.leader.create("Pod", p)
        assert plane.leader.wal_end() > fstore.wal_end()
        resumed = SIDES[follower_side][3].WalFollower(
            fstore, plane.url, "r1", leader_id="r0")
        resumed.start()
        plane.followers[0] = ("r1", fstore, resumed)
        if follower_side == "port":
            plane.converge()
            assert fcounters.get("storage.repl.forked_tail") == 1
            assert "rogue" not in {p.metadata.name
                                   for p in fstore.list("Pod")}
        else:
            _wait(lambda: "WAL corruption" in resumed.last_error, 10.0,
                  "the JAX follower to fail on the forked range")
            time.sleep(1.0)
            assert fstore.resource_version < plane.leader.resource_version
        fwal = fstore._path
    finally:
        plane.close()
    if follower_side == "port":
        assert tfsck.wal_compare(plane.leader_wal, fwal)["identical"]
