"""The port's copy of ``tests/test_shard_chaos.py``, under JAX's names and
gates (the soak stays ``slow``), over ``minisched_tpu_torch``, and the
CPU copy of ``chip_smoke.py`` phase 32 at the end.  JAX's docstring
follows.

Sharded-plane chaos (`make chaos-shard`): SIGKILL one shard leader
under cross-shard bind load.

The blast-radius claim of DESIGN.md §30: a leader group dying is ONE
shard's failover, not the plane's.  A 2-group × 3-replica plane takes
cross-shard bind batches (every batch spans both groups — the two-shard
commit path) while a dedicated writer hammers the OTHER group; g0's
leader is SIGKILLed mid-run with no goodbye.  Standing audits:

* zero acked-write loss — every create and bind acked to a client is
  present on the final plane;
* no half-committed cross-shard batch — every logical batch the test
  retried to success is fully bound on BOTH sides, and the full-history
  double-bind audit over all six replica WALs is clean (a retried batch
  re-executing on the durable side would show the same pod bound
  twice);
* the unaffected shard never stalls — the g1 writer keeps acking
  THROUGH g0's failover window (measured, not assumed).

The tier-1 smoke runs one kill at small scale; the soak (slow) doubles
the load and adds a second kill on the other group.
"""

from __future__ import annotations

import functools
import signal
import threading
import time

import pytest

from minisched_tpu_torch.api.objects import Binding, make_node, make_pod
from minisched_tpu_torch.controlplane.shards import ShardedPlane
from minisched_tpu_torch.faults import wal_double_binds

TTL_S = 1.0
NAMESPACES = [f"tenant-{i:02d}" for i in range(40)] + ["default"]



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

def _ns_for(topology, gid):
    return next(ns for ns in NAMESPACES if topology.owner(ns) == gid)


def _run_cross_shard_kill(plane, batches, kill_after, second_kill=False):
    ss = plane.client(timeout_s=10.0, retries=2)
    topo = plane.topology
    ns_g0, ns_g1 = _ns_for(topo, "g0"), _ns_for(topo, "g1")
    try:
        ss.create("Node", make_node("n1", capacity={
            "cpu": "64", "memory": "256Gi", "pods": 4 * batches + 8,
        }))
        for i in range(batches):
            ss.create("Pod", make_pod(f"a{i:03d}", namespace=ns_g0))
            ss.create("Pod", make_pod(f"b{i:03d}", namespace=ns_g1))

        # liveness probe: a writer pinned to g1's namespace, recording
        # every ack timestamp — the "unaffected shards never stall"
        # evidence
        ack_times: list = []
        stop = threading.Event()

        def g1_writer():
            wss = plane.client(timeout_s=10.0, retries=2)
            i = 0
            try:
                while not stop.is_set():
                    try:
                        wss.create(
                            "Pod",
                            make_pod(f"live-{i:04d}", namespace=ns_g1),
                        )
                        ack_times.append(time.monotonic())
                        i += 1
                    except Exception:
                        time.sleep(0.1)
                    else:
                        time.sleep(0.02)
            finally:
                wss.close()

        writer = threading.Thread(target=g1_writer, daemon=True)
        writer.start()

        kill_window: list = []
        acked_batches = 0
        for i in range(batches):
            if i == kill_after:
                old = plane.leader("g0")
                assert old is not None
                t_kill = time.monotonic()
                old.kill()
                kill_window.append(t_kill)
            if second_kill and i == kill_after * 2:
                old1 = plane.leader("g1")
                if old1 is not None:
                    old1.kill()
            binds = [
                Binding(pod_name=f"a{i:03d}", pod_namespace=ns_g0,
                        node_name="n1"),
                Binding(pod_name=f"b{i:03d}", pod_namespace=ns_g1,
                        node_name="n1"),
            ]
            # retry the SAME logical batch until both sides ack — the
            # registry replay makes this safe no matter how many
            # attempts straddle the failover
            deadline = time.monotonic() + 60.0
            while True:
                res = ss.bind_many_remote(
                    binds, return_objects=False,
                    batch_id=f"xbatch-{i:03d}",
                )
                if all(not isinstance(r, BaseException) for r in res):
                    acked_batches += 1
                    break
                assert time.monotonic() < deadline, (
                    f"batch {i} never fully acked: {res}"
                )
                time.sleep(0.2)
        if kill_window:
            won = plane.wait_for_leader("g0", timeout_s=10 * TTL_S)
            kill_window.append(
                kill_window[0] + max(won["elapsed_s"], 0.0) + 0.5
            )
        stop.set()
        writer.join(timeout=30.0)
        assert acked_batches == batches

        # audit: unaffected shard never stalled — g1 acks continued
        # INSIDE g0's failover window
        if kill_window:
            t0, t1 = kill_window
            in_window = [t for t in ack_times if t0 <= t <= t1]
            assert in_window, (
                f"g1 writer acked nothing during g0's failover "
                f"({t1 - t0:.2f}s window, {len(ack_times)} acks total)"
            )

        # audit: zero acked-write loss + no half-committed batch — every
        # batch's BOTH pods bound on the final plane
        final = plane.client(timeout_s=10.0, retries=2)
        try:
            pods = {
                (p.metadata.namespace, p.metadata.name): p
                for p in final.list("Pod")
            }
            for i in range(batches):
                for ns, name in ((ns_g0, f"a{i:03d}"),
                                 (ns_g1, f"b{i:03d}")):
                    p = pods.get((ns, name))
                    assert p is not None, f"acked pod {ns}/{name} lost"
                    assert p.spec.node_name == "n1", (
                        f"half-committed batch {i}: {ns}/{name} unbound"
                    )
            live_acked = len(ack_times)
            live_present = sum(
                1 for (ns, name) in pods if name.startswith("live-")
            )
            assert live_present >= live_acked, (
                f"{live_acked - live_present} acked liveness writes lost"
            )
        finally:
            final.close()
    finally:
        ss.close()


@time_limit(180)
def test_shard_leader_kill_under_cross_shard_binds(tmp_path):
    """One SIGKILL on g0's leader while every bind batch spans both
    groups: all batches drive to fully-committed, g1 never stalls, and
    the offline double-bind audit over all six WALs is clean."""
    plane = ShardedPlane(
        str(tmp_path), k=2, replicas_per_group=3, fsync=True, ttl_s=TTL_S
    )
    try:
        plane.start()
        _run_cross_shard_kill(plane, batches=12, kill_after=4)
    finally:
        plane.stop()
    # offline: the full-history audit — a registry miss that re-executed
    # a bind after the failover would surface here as a double bind
    for gid, group in plane.groups.items():
        for r in group.replicas:
            assert wal_double_binds(r.wal_path) == [], (gid, r.replica_id)


@pytest.mark.slow
@time_limit(600)
def test_shard_leader_kills_soak(tmp_path):
    """The heavier variant: more batches and a SECOND kill on g1 once
    its failover matters too — both groups survive their own election
    while the cross-shard commit protocol keeps every batch whole."""
    plane = ShardedPlane(
        str(tmp_path), k=2, replicas_per_group=3, fsync=True, ttl_s=TTL_S
    )
    try:
        plane.start()
        _run_cross_shard_kill(
            plane, batches=30, kill_after=6, second_kill=True
        )
    finally:
        plane.stop()
    for gid, group in plane.groups.items():
        for r in group.replicas:
            assert wal_double_binds(r.wal_path) == [], (gid, r.replica_id)


# ---------------------------------------------------------------------------
# the port's: chip_smoke.py phase 32 on the CPU, and the bench role
# ---------------------------------------------------------------------------


@time_limit(300)
def test_config5_sharded_through_a_split(tmp_path):
    """``live.run_config5_sharded`` (``chip_smoke.py`` phase 32) at 100
    nodes and 1,000 pods over 8 tenants, serial waves of 64 on the CPU
    twins, the split after 60 binds: it raises unless every check of the
    phase holds (every plain pod bound, no ``special*`` pod, no loop
    error, empty ledgers, ``hot_ns`` wholly on the target and gone from
    the source, the freeze under its TTL, watched binds kept, each bind
    seen once by the merged watch and no plain pod deleted, no node over
    its allocatable across both groups, clean double-bind audits and
    fsck on both WALs, no child or thread left).

    The merged initial list changes the order: the informers' first list
    is one group's pods then the other's (``ShardedStore.list_with_rv``),
    and each group's store holds its pods namespace by namespace
    (``RemoteStore.create_many`` posts one collection a namespace), not
    in creation order (tenants round-robin).  The engine's waves equal an
    unsharded in-process run's over the same pods (same uids) created in
    that order, and every bind watched before the split is on the node
    that run chose."""
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.controlplane.shards import ShardTopology
    from minisched_tpu_torch.fullchain import mk_c5_cluster
    from minisched_tpu_torch.live import (
        QUIESCE_TTL_S,
        run_config5_sharded,
        shard_tenants,
    )
    from minisched_tpu_torch.service.config import default_full_roster_config
    from minisched_tpu_torch.service.service import SchedulerService

    run = run_config5_sharded(str(tmp_path), 100, 1000, split_binds=60,
                              device="cpu", max_wave=64, pipeline=False,
                              timeout_s=120.0)
    tenants = shard_tenants(8)
    assert sorted(run.tenants) == sorted(tenants)
    assert run.source != run.target and run.tenants[run.hot_ns] == run.source
    assert run.split["objects"] == 125  # 1,000 pods over 8 tenants
    assert run.split["freeze_s"] < 30.0
    assert run.n_plain == 980 and run.audit["bound"] == 980
    assert 60 <= run.seen_at_split < 980
    assert run.counters["shard.splits"] >= 1
    assert run.counters["shard.budget.mirror_checks"] > 0
    assert run.counters["storage.shard.purged_objects"] == 125
    assert run.watch["binds"] == 980

    nodes, pods = mk_c5_cluster(100, 1000, namespaces=tenants)
    for i, p in enumerate(pods):
        p.metadata.uid = f"pod-{100 + i + 1:08d}"
    probe = ShardTopology({"g0": ["http://a"], "g1": ["http://b"]})
    first = {}
    for i, p in enumerate(pods):
        first.setdefault(p.metadata.namespace, i)

    def merged_key(i):
        ns = pods[i].metadata.namespace
        return probe.owner(ns), first[ns], i

    merged = sorted(range(len(pods)), key=merged_key)
    assert merged != list(range(len(pods)))  # the merged order differs
    client = Client()
    client.nodes().create_many(nodes, return_objects=False)
    client.pods().create_many([pods[i] for i in merged],
                              return_objects=False)
    svc = SchedulerService(client)
    try:
        sched = svc.start_scheduler(default_full_roster_config(),
                                    device_mode=True, max_wave=64,
                                    device="cpu", pipeline=False)
        sched.assume_ttl_s = QUIESCE_TTL_S
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            placed = {p.metadata.name: p.spec.node_name
                      for p in client.pods().list()}
            if sum(1 for n in placed.values() if n) >= 980:
                break
            time.sleep(0.1)
    finally:
        svc.close()
    moved = {n: (node, placed.get(n)) for n, node in run.seen.items()
             if placed.get(n) != node}
    assert not moved, moved


@time_limit(420)
def test_shard_role_at_a_small_size(monkeypatch):
    """``bench.role_shard`` (``--only shard``) on the host with its gates
    armed as JAX's (8 cores here): 12 writer processes for 1.5 s a storm,
    5 bind batches a kind, the fsync floor at 0 (a floor longer than a
    group's CPU work a round makes both planes barrier-bound alike: 2 ms
    gave 1.29x, 20 ms 1.03x on this host), the autosplit phase at its
    defaults.  A run that fails only a gate on wall time (the write
    scaling, the group wait's recovery) is run again, at most three
    times; any other gate fails at once."""
    from minisched_tpu_torch import bench

    monkeypatch.setenv("BENCH_SHARD", "1")
    monkeypatch.setenv("BENCH_SHARD_WRITERS", "12")
    monkeypatch.setenv("BENCH_SHARD_WINDOW_S", "1.5")
    monkeypatch.setenv("BENCH_SHARD_BIND_BATCHES", "5")
    monkeypatch.setenv("BENCH_SHARD_FSYNC_FLOOR_US", "0")
    for attempt in range(3):
        try:
            rec = bench.role_shard()
            break
        except AssertionError as err:
            timed = ("WRITE SCALING UNDER GATE", "GROUP WAIT DID NOT RECOVER")
            if attempt == 2 or not any(t in str(err) for t in timed):
                raise
    assert rec["scaling_gated"] and rec["write_scaling_x"] >= 1.5
    assert rec["cross_bind_batches"] == 5
    assert rec["autosplit_trigger_count"] >= 1
    assert rec["autosplit_post_p99_s"] < rec["autosplit_pre_p99_s"] \
        or rec["autosplit_post_p99_s"] == 0.0
