"""The port's copy of ``tests/test_split_chaos.py``, under JAX's names and
gates (the soak stays ``slow``), over ``minisched_tpu_torch``.  JAX's
docstring follows.

Split-protocol chaos (DESIGN.md §31, `make chaos-split`): crash-safe
autonomous splits on a live 2-group × 3-replica sharded plane.

Two kill schedules, each against real child processes with real WALs:

* the split COORDINATOR is SIGKILLed mid-freeze — with nobody left to
  unfreeze, every replica's WAL-journaled freeze lease must auto-thaw at
  its TTL: zero stranded frozen namespaces, ownership unchanged, zero
  acked-write loss;
* the SOURCE shard's leader is SIGKILLed mid-handoff (inside the freeze
  window) — the split must complete against the freshly-elected leader
  (the lease renewal before the flip proves no replica thawed under it)
  with every object delivered exactly once and vector-cursor watches
  intact.

Standing audits both times: every acked write survives, and the
full-history double-bind audit (`faults.wal_double_binds`) is clean over
EVERY replica's WAL — all six of them.
"""

from __future__ import annotations

import functools
import signal
import time

import pytest

from minisched_tpu_torch.api.objects import make_pod
from minisched_tpu_torch.controlplane.remote import RemoteStore
from minisched_tpu_torch.controlplane.replproc import SplitCoordinator
from minisched_tpu_torch.controlplane.shards import ShardedPlane, _raw_req
from minisched_tpu_torch.controlplane.store import ShardFrozen
from minisched_tpu_torch.faults import wal_double_binds

TTL_S = 1.0  # replication lease (election speed), not the freeze lease
FREEZE_TTL_S = 2.5  # the coordinator's freeze-lease TTL under test



def time_limit(seconds):
    """This test's own time limit: past ``seconds`` it fails with
    TimeoutError (SIGALRM on the test's thread), and its ``finally``
    blocks still stop the children it started."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            def expire(signum, frame):
                raise TimeoutError(f"{fn.__name__} ran past its {seconds}s "
                                   "limit")

            old = signal.signal(signal.SIGALRM, expire)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
        return run
    return wrap

def _all_replicas(plane):
    for gid, group in plane.groups.items():
        for r in group.replicas:
            yield gid, r


def _audit_wals(plane):
    for gid, r in _all_replicas(plane):
        assert wal_double_binds(r.wal_path) == [], (gid, r.replica_id)


def _shard_statuses(plane):
    """Live replicas' ShardInfo.describe() docs (dead ones skipped —
    a SIGKILLed leader has nothing stranded to hold)."""
    out = {}
    for gid, r in _all_replicas(plane):
        try:
            status, doc = _raw_req(
                r.base_url, "GET", "/shards/status", timeout_s=2.0
            )
        except Exception:  # noqa: BLE001 — dead replica
            continue
        if status == 200:
            out[r.replica_id] = doc
    return out


@time_limit(180)
def test_coordinator_sigkill_mid_freeze_auto_thaws(tmp_path):
    """Kill the split coordinator INSIDE the freeze window (after the
    freeze fanout, before the handoff).  Nobody will ever send the
    unfreeze — the TTL'd lease on each replica is the only thaw.  Every
    replica must thaw within the lease TTL, no namespace stays frozen,
    ownership and epoch are unchanged, and every previously-acked write
    survives."""
    plane = ShardedPlane(
        str(tmp_path), k=2, replicas_per_group=3, fsync=True, ttl_s=TTL_S
    )
    try:
        plane.start()
        ss = plane.client(timeout_s=10.0, retries=4)
        ns = next(
            n for n in (f"tenant-{i:02d}" for i in range(40))
            if plane.topology.owner(n) == "g0"
        )
        acked = [f"pre-{i:03d}" for i in range(8)]
        for name in acked:
            ss.create("Pod", make_pod(name, namespace=ns))
        epoch0 = plane.topology.epoch

        coord = SplitCoordinator(
            plane.topology.as_dict(), ns, "g1",
            ttl_s=FREEZE_TTL_S, hold_s=3600.0,
        ).start()
        try:
            lease_id = coord.wait_frozen(timeout_s=30.0)
            assert lease_id
            # the freeze is live: a direct write to the source leader is
            # refused with the typed transient error (bounded retry —
            # satellite b's deadline turns the spin into a typed timeout)
            leader_url = plane.wait_for_leader("g0")["url"]
            direct = RemoteStore(
                leader_url, retries=0,
                frozen_deadline_s=0.4, backoff_initial_s=0.05,
            )
            try:
                with pytest.raises(ShardFrozen):
                    direct.create(
                        "Pod", make_pod("frozen-probe", namespace=ns)
                    )
            finally:
                direct.close()

            t_kill = time.monotonic()
            coord.kill()
            assert not coord.alive()

            # auto-thaw: the SAME namespace accepts writes again without
            # any unfreeze ever being sent — bounded by the lease TTL
            # (plus scheduling slack), NOT by operator intervention
            thawed_at = None
            deadline = t_kill + FREEZE_TTL_S + 10.0
            while time.monotonic() < deadline:
                try:
                    ss.create("Pod", make_pod("post-thaw", namespace=ns))
                    thawed_at = time.monotonic()
                    break
                except Exception:  # noqa: BLE001 — still frozen
                    time.sleep(0.1)
            assert thawed_at is not None, "namespace never thawed"
        finally:
            coord.kill()

        # zero stranded frozen namespaces, anywhere
        statuses = _shard_statuses(plane)
        assert statuses, "no replica answered /shards/status"
        for rid, doc in statuses.items():
            assert doc["leases"] == {}, (rid, doc["leases"])
            assert doc["topology"]["frozen"] == [], rid
            # the aborted split never flipped ownership
            assert doc["epoch"] == epoch0, rid
            assert ns not in doc["topology"].get("overrides", {}), rid

        # zero acked-write loss
        names = {p.metadata.name for p in ss.list("Pod")}
        assert set(acked) <= names and "post-thaw" in names
        ss.close()
    finally:
        plane.stop()
    _audit_wals(plane)


@time_limit(180)
def test_split_completes_across_source_leader_failover(tmp_path):
    """SIGKILL the SOURCE group's leader inside the freeze window
    (satellite c): the coordinator's probe finds the freshly-elected
    leader, the handoff ships from it, the pre-flip lease renewal proves
    no replica thawed mid-election, and the split COMPLETES — every
    object on the target exactly once, the source purged, vector-cursor
    watches intact, no stranded freeze."""
    plane = ShardedPlane(
        str(tmp_path), k=2, replicas_per_group=3, fsync=True, ttl_s=TTL_S
    )
    try:
        plane.start()
        ss = plane.client(timeout_s=10.0, retries=4)
        ns = next(
            n for n in (f"tenant-{i:02d}" for i in range(40))
            if plane.topology.owner(n) == "g0"
        )
        pods = [f"mv-{i:03d}" for i in range(10)]
        for name in pods:
            ss.create("Pod", make_pod(name, namespace=ns))

        # a vector-cursor watch opened BEFORE the split must survive it
        # with every component cursor intact: each delivered event
        # strictly advances exactly the component that produced it
        # (exactly-once PER SHARD), and a post-split resume from the
        # final cursor replays nothing already seen
        watch, snap = ss.watch("Pod", send_initial=True)
        seen: list = []
        deadline = time.monotonic() + 30.0
        while len(seen) < len(pods) and time.monotonic() < deadline:
            seen.extend(watch.next_batch(timeout=0.25))
        assert len(seen) == len(pods)

        from minisched_tpu_torch.controlplane.shards import split_namespace

        def kill_source_leader(lease_id: str) -> None:
            old = plane.leader("g0")
            assert old is not None
            old_id = old.replica_id
            old.kill()
            plane.wait_for_leader(
                "g0", timeout_s=20 * TTL_S, exclude=old_id
            )

        # the freeze TTL must outlive the election, or the renewal
        # rightly refuses and the split aborts — that path is pinned
        # in-process in test_shards.py; here the split must COMPLETE
        result = split_namespace(
            plane.topology, ns, "g1", ttl_s=30.0,
            _after_freeze=kill_source_leader,
        )
        assert result["from"] == "g0" and result["to"] == "g1"
        assert result["objects"] == len(pods)
        assert plane.topology.owner(ns) == "g1"
        ss.refresh_topology()

        # exactly-once on the plane: the merged list holds each moved
        # pod ONCE (a duplicate surviving on the source would double it)
        listed = [
            p for p in ss.list("Pod") if p.metadata.namespace == ns
        ]
        assert sorted(p.metadata.name for p in listed) == pods

        # writes flow to the new owner (the stale router 421-chases);
        # the pre-split watch must deliver that event exactly once
        ss.create("Pod", make_pod("post-split", namespace=ns))
        post: list = []
        deadline = time.monotonic() + 15.0
        while (
            not any(e.obj.metadata.name == "post-split" for e in post)
            and time.monotonic() < deadline
        ):
            post.extend(watch.next_batch(timeout=0.25))
        post.extend(watch.next_batch(timeout=0.5))
        assert [
            e.obj.metadata.name for e in post
            if e.obj.metadata.name == "post-split"
        ] == ["post-split"]

        # vector cursors intact across the split: every delivered event
        # advanced its components monotonically, and every LIVE event
        # (the split's transition events, the post-split create) carries
        # a distinct cursor — an equal pair would mean a replay
        cursors = [dict(e.rv) for e in seen + post]
        for a, b in zip(cursors, cursors[1:]):
            assert all(b.get(g, 0) >= rv for g, rv in a.items()), (a, b)
        live = [dict(e.rv) for e in post]
        for a, b in zip(live, live[1:]):
            assert a != b, a

        # ... and a resume from the final cursor replays NOTHING
        final = post[-1].rv
        watch.stop()
        w2, _ = ss.watch("Pod", send_initial=False, resume_rv=dict(final))
        try:
            assert not w2.next_batch(timeout=0.75), "resume replayed"
            ss.create("Pod", make_pod("post-resume", namespace=ns))
            fresh: list = []
            deadline = time.monotonic() + 15.0
            while not fresh and time.monotonic() < deadline:
                fresh.extend(w2.next_batch(timeout=0.25))
            assert [e.obj.metadata.name for e in fresh] == ["post-resume"]
        finally:
            w2.stop()

        # no stranded freeze anywhere, epoch advanced everywhere alive
        for rid, doc in _shard_statuses(plane).items():
            assert doc["leases"] == {}, (rid, doc["leases"])
            assert doc["topology"]["frozen"] == [], rid
            assert doc["epoch"] == plane.topology.epoch, rid

        # the follower-serving read plane advertises its peers — the
        # router's endpoint discovery (satellite a) rides this list
        status, doc = _raw_req(
            plane.wait_for_leader("g1")["url"], "GET", "/repl/status"
        )
        assert status == 200
        assert len(doc.get("peers", [])) == 3
        ss.close()
    finally:
        plane.stop()
    _audit_wals(plane)


@pytest.mark.slow
@time_limit(600)
def test_coordinator_kill_then_retry_completes(tmp_path):
    """Soak the full recovery arc: coordinator killed mid-freeze, lease
    auto-thaws, a SECOND coordinator retries the same split and
    completes it — the half-pushed state of the first attempt (a
    partially-seeded target at worst) must not wedge the retry."""
    plane = ShardedPlane(
        str(tmp_path), k=2, replicas_per_group=3, fsync=True, ttl_s=TTL_S
    )
    try:
        plane.start()
        ss = plane.client(timeout_s=10.0, retries=4)
        ns = next(
            n for n in (f"tenant-{i:02d}" for i in range(40))
            if plane.topology.owner(n) == "g0"
        )
        pods = [f"rt-{i:03d}" for i in range(6)]
        for name in pods:
            ss.create("Pod", make_pod(name, namespace=ns))

        first = SplitCoordinator(
            plane.topology.as_dict(), ns, "g1",
            ttl_s=FREEZE_TTL_S, hold_s=3600.0,
        ).start()
        first.wait_frozen(timeout_s=30.0)
        first.kill()
        # wait out the auto-thaw before the retry (a live foreign lease
        # rightly refuses a second coordinator's freeze): a probe write
        # landing proves every replica reaped the orphan
        deadline = time.monotonic() + FREEZE_TTL_S + 10.0
        while time.monotonic() < deadline:
            try:
                ss.create("Pod", make_pod("thaw-probe", namespace=ns))
                break
            except Exception:  # noqa: BLE001 — still frozen
                time.sleep(0.1)
        pods.append("thaw-probe")
        pods.sort()
        deadline = time.monotonic() + 30.0
        retry = None
        while time.monotonic() < deadline:
            c = SplitCoordinator(
                plane.topology.as_dict(), ns, "g1",
                ttl_s=5.0, hold_s=0.0,
            ).start()
            try:
                c.wait_frozen(timeout_s=10.0)
            except RuntimeError:
                c.kill()
                time.sleep(0.25)
                continue
            retry = c
            break
        assert retry is not None, "retry coordinator never got the lease"
        result = retry.wait_done(timeout_s=60.0)
        assert result["to"] == "g1" and result["objects"] == len(pods)
        plane.topology.epoch = result["epoch"]
        plane.topology.overrides[ns] = "g1"
        ss.refresh_topology()

        listed = [
            p for p in ss.list("Pod") if p.metadata.namespace == ns
        ]
        assert sorted(p.metadata.name for p in listed) == pods
        for rid, doc in _shard_statuses(plane).items():
            assert doc["leases"] == {}, (rid, doc["leases"])
        ss.close()
    finally:
        plane.stop()
    _audit_wals(plane)
