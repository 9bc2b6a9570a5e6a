"""The live engine's cross-pod backlog and scan lanes against the JAX
engine, on the CPU.

Pods with pod (anti-)affinity or a topology-spread constraint are split
off each wave into ``_scan_backlog`` and placed by the exact scan (a
flush of at most ``SCAN_BLOCK_SIZE`` = 32 pods, bind-exact with the
sequential oracle) or the blocked lane (per interaction group exact, the
capacity and skew audits across groups).  Where two engines run, both
take the serial path (``MINISCHED_PIPELINE=0``, ``tests/test_torch_engine
.py`` ``live``) over the same cluster with the same pod uids, and every
binding must be equal; placements are integers, so the tolerance is
exact.  The JAX engine's backlog behaviours (``tests/test_device_
scheduler.py:449-860``) are ported as port-only tests of the same
assertions.  Every wait has a deadline; every service shuts down in a
``finally``.
"""

from __future__ import annotations

from collections import Counter

import pytest

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.controlplane.client import Client as TClient
from minisched_tpu_torch.framework.types import PodInfo, QueuedPodInfo
from minisched_tpu_torch.observability.profiling import CycleMetrics
from minisched_tpu_torch.service import config as tconfig
from minisched_tpu_torch.service.service import SchedulerService as TService
from tests.test_torch_engine import (
    HOST,
    SIDES,
    live,
    placements,
    settled,
    wait_for,
    with_uids,
)


def spread_pod(objs, name, app, skew=1, cpu="250m", priority=0, key="zone"):
    pod = objs.make_pod(name, labels={"app": app},
                        requests={"cpu": cpu, "memory": "128Mi"},
                        priority=priority)
    pod.spec.topology_spread_constraints = [objs.TopologySpreadConstraint(
        max_skew=skew, topology_key=key, when_unsatisfiable="DoNotSchedule",
        label_selector=objs.LabelSelector(match_labels={"app": app}))]
    return pod


def zone_nodes(objs, n=32, zones=4, cpu="8", pods=110):
    return [objs.make_node(f"node{i:03d}", labels={"zone": f"z{i % zones}"},
                           capacity={"cpu": cpu, "memory": "32Gi",
                                     "pods": pods})
            for i in range(n)]


def skews(client, prefix, zones):
    """Per app of the ``prefix*`` pods: max - min pods over ``zones``."""
    zone_of = {n.metadata.name: n.metadata.labels["zone"]
               for n in client.nodes().list()}
    per_app = {}
    for p in client.pods().list():
        if p.metadata.name.startswith(prefix):
            per_app.setdefault(p.metadata.labels["app"], Counter())[
                zone_of[p.spec.node_name]] += 1
    return {app: max(c.get(z, 0) for z in zones) - min(c.get(z, 0)
                                                        for z in zones)
            for app, c in per_app.items()}


# -- against the JAX engine and the sequential oracle ----------------------


def _partition_pods(objs):
    """24 spread pods of 2 apps, every fifth pinned to zone z1 by a node
    selector: one flush of 24 <= 32 pods, the exact lane."""
    pods = []
    for i in range(24):
        p = spread_pod(objs, f"pod{i:03d}", f"app{i % 2}", cpu="500m")
        if i % 5 == 0:
            p.spec.node_selector = {"zone": "z1"}
        pods.append(p)
    return with_uids(pods)


def _partition_run(side, monkeypatch):
    objs = SIDES[side][0]
    pods = _partition_pods(objs)
    with live(side, "default_full_roster_config", monkeypatch,
              zone_nodes(objs, cpu="8"), pods, max_wave=32) as (
                  client, sched, _):
        assert wait_for(lambda: all(p.spec.node_name
                                    for p in client.pods().list()))
        if side == "port":
            assert sched.loop_errors == 0
            assert sched.scan_stats["exact"].placed == 24
            assert sched.scan_stats["blocked"].calls == 0
        return [client.pods().get(p.metadata.name).spec.node_name
                for p in pods]


def test_cross_pod_wave_partition_is_bind_exact(monkeypatch):
    """The JAX test of the same name (``tests/test_device_scheduler.py:
    290``): cross-pod pods ride the exact scan, and their placements equal
    the JAX scalar oracle ``schedule_pods_sequentially`` in pop order and
    the JAX engine's, pod for pod — DoNotSchedule skew enforced between
    pods the repair wave alone would evaluate blind to each other."""
    from minisched_tpu.api import objects as jobj
    from minisched_tpu.controlplane.client import Client as JClient
    from minisched_tpu.engine.scheduler import schedule_pods_sequentially
    from minisched_tpu.framework.nodeinfo import build_node_infos
    from minisched_tpu.plugins.registry import build_plugins
    from minisched_tpu.service.config import default_full_roster_config
    from minisched_tpu.service.service import _inject

    got = _partition_run("port", monkeypatch)
    want_engine = _partition_run("jax", monkeypatch)
    cfg = default_full_roster_config()
    chains = build_plugins(cfg)
    for pl in chains.needs_client:
        _inject(pl, "store_client", JClient())
    want = schedule_pods_sequentially(
        chains.filter, chains.pre_score, chains.score, cfg.score_weights(),
        _partition_pods(jobj), build_node_infos(zone_nodes(jobj), []))
    assert got == want == want_engine
    assert all(got)


def _burst_run(side, monkeypatch):
    """192 spread pods of 12 apps (skew 1) on 32 nodes in 4 zones: one
    flush of 192 > 32 pods, the blocked lane (``tests/test_blocked_scan
    .py:189``)."""
    objs = SIDES[side][0]
    pods = with_uids([spread_pod(objs, f"sp{i:04d}", f"app{i % 12}",
                                 cpu="100m") for i in range(192)])
    with live(side, "default_full_roster_config", monkeypatch,
              zone_nodes(objs, cpu="16", pods=64), pods, max_wave=256) as (
                  client, sched, _):
        assert wait_for(lambda: all(p.spec.node_name
                                    for p in client.pods().list()))
        if side == "port":
            assert sched.loop_errors == 0
            assert sched.scan_stats["blocked"].placed == 192
        return placements(client), skews(client, "sp",
                                         ["z0", "z1", "z2", "z3"])


def test_live_engine_blocked_lane_places_spread_burst(monkeypatch):
    """Every pod of the burst binds, the skew of each app holds, and the
    port binds every pod where the JAX engine does."""
    got, got_skew = _burst_run("port", monkeypatch)
    want, _ = _burst_run("jax", monkeypatch)
    assert got == want
    assert len(got_skew) == 12 and max(got_skew.values()) <= 1


def slice_cluster(objs):
    """24 nodes in 4 zones (4 CPU each, 2 cordoned); 48 plain pods; a
    burst of 40 spread pods of 5 apps; 4 ``big*`` pods of 6 CPU, which no
    node fits until a node of 32 CPU joins."""
    nodes = [objs.make_node(f"n{i:03d}", unschedulable=i in (5, 17),
                            labels={"zone": f"z{i % 4}", HOST: f"n{i:03d}"},
                            capacity={"cpu": "4", "memory": "16Gi",
                                      "pods": 110})
             for i in range(24)]
    pods = [objs.make_pod(f"plain{i:03d}", labels={"app": "web"},
                          requests={"cpu": "500m", "memory": "256Mi"})
            for i in range(48)]
    pods += [spread_pod(objs, f"spread{i:03d}", f"s{i % 5}", cpu="250m")
             for i in range(40)]
    pods += [objs.make_pod(f"big{i}", requests={"cpu": "6"})
             for i in range(4)]
    return nodes, with_uids(pods)


def lone_pod(objs):
    """A pod with a required hostname anti-affinity to ``app=s0``."""
    lone = objs.make_pod("lone", requests={"cpu": "250m"})
    lone.metadata.uid = "pod-lone"
    lone.spec.affinity = objs.Affinity(pod_anti_affinity=objs.PodAntiAffinity(
        required=[objs.PodAffinityTerm(
            label_selector=objs.LabelSelector(match_labels={"app": "s0"}),
            topology_key=HOST)]))
    return lone


def _slice_run(side, monkeypatch):
    objs = SIDES[side][0]
    nodes, pods = slice_cluster(objs)
    with live(side, "default_full_roster_config", monkeypatch, nodes, pods,
              max_wave=64, assume_ttl_s=0.5, time_scale=0.01) as (
                  client, sched, _):
        assert wait_for(lambda: settled(client, sched, len(pods))
                        and sched.queue.stats()["unschedulable"] == 4)
        # alone in its wave and its flush: the exact lane
        client.pods().create(lone_pod(objs))
        assert wait_for(lambda: client.pods().get("lone").spec.node_name)
        client.nodes().create(objs.make_node(
            "n024", labels={"zone": "z0", HOST: "n024"},
            capacity={"cpu": "32", "memory": "64Gi", "pods": 110}))
        assert wait_for(lambda: all(p.spec.node_name
                                    for p in client.pods().list()))
        errors, lanes = 0, None
        if side == "port":
            assert wait_for(lambda: sched.assumed_count() == 0)
            errors, lanes = sched.loop_errors, sched.scan_stats
        return placements(client), errors, lanes


def test_whole_slice_serial_engine_binds_as_jax(monkeypatch):
    """The slice end to end on the serial engine of both packages: plain
    waves, a spread burst through the blocked lane, a lone anti-affinity
    pod through the exact scan, and parked pods requeued when a node
    joins.  Every binding equal, pod for pod; no loop error."""
    got, errors, lanes = _slice_run("port", monkeypatch)
    want, _, _ = _slice_run("jax", monkeypatch)
    assert got == want and errors == 0
    assert lanes["blocked"].placed == 40 and lanes["exact"].placed == 1
    assert {got[f"big{i}"] for i in range(4)} == {"n024"}
    assert got["lone"] not in {v for k, v in got.items()
                               if k.startswith("spread")
                               and int(k[6:]) % 5 == 0}


# -- the backlog's behaviours (the JAX engine's own tests, on the port) ----


@pytest.fixture
def engine(monkeypatch):
    """A running port engine (serial) over an empty store: yields (client,
    scheduler); its nodes come from the test."""
    monkeypatch.setenv("MINISCHED_PIPELINE", "0")
    client = TClient()
    svc = TService(client)
    try:
        yield client, svc
    finally:
        svc.close()


def _start(svc, max_wave=8):
    return svc.start_scheduler(tconfig.default_full_roster_config(),
                               device_mode=True, max_wave=max_wave,
                               device="cpu")


def _plain_left(client, n):
    return sum(1 for i in range(n)
               if not client.pods().get(f"plain{i:03d}").spec.node_name)


def test_scan_backlog_flushes_within_wave_bound(engine):
    """``tests/test_device_scheduler.py:449``: a stream of full plain waves
    does not starve a deferred spread pod; the backlog flushes after
    ``SCAN_DEFER_MAX_WAVES`` while plain pods are still pending."""
    client, svc = engine
    for node in zone_nodes(tobj, n=16, cpu="64", pods=500):
        client.nodes().create(node)
    client.pods().create(spread_pod(tobj, "spread-first", "s", skew=2,
                                    cpu="100m"))
    client.pods().create_many([
        tobj.make_pod(f"plain{i:03d}", requests={"cpu": "100m"})
        for i in range(240)])
    sched = _start(svc)
    assert sched.SCAN_DEFER_MAX_WAVES * sched.max_wave < 240
    assert wait_for(lambda: client.pods().get("spread-first").spec.node_name)
    assert _plain_left(client, 240) > 0
    assert sched.loop_errors == 0


def test_flush_drops_deleted_and_refreshes_updated_backlog_pods(engine):
    """``:515``: a pod deleted while deferred is dropped, not parked; a pod
    updated while deferred is placed from its current spec."""
    client, svc = engine
    for i in range(8):
        client.nodes().create(tobj.make_node(
            f"node{i:03d}", labels={"zone": f"z{i % 2}",
                                    "tier": "a" if i == 7 else "b"},
            capacity={"cpu": "8", "memory": "16Gi", "pods": 110}))
    sched = _start(svc)
    sched.stop()  # the loop must not race the hand-driven flush
    client.pods().create(spread_pod(tobj, "ghost", "s", skew=4, cpu="100m"))
    ghost_snap = client.pods().get("ghost")
    client.pods().create(spread_pod(tobj, "upd", "s", skew=4, cpu="100m"))
    snap = client.pods().get("upd")
    client.pods().delete("ghost")
    cur = client.pods().get("upd")
    cur.spec.node_selector = {"tier": "a"}
    client.pods().update(cur)
    pods_inf = sched.informer_factory.informer_for("Pod")
    want_rv = client.pods().get("upd").metadata.resource_version
    assert wait_for(lambda: pods_inf.get("default/ghost") is None
                    and (pods_inf.get("default/upd") or snap
                         ).metadata.resource_version == want_rv)
    sched._scan_backlog = [QueuedPodInfo(PodInfo(ghost_snap)),
                           QueuedPodInfo(PodInfo(snap))]
    sched._flush_scan_backlog()
    assert wait_for(lambda: client.pods().get("upd").spec.node_name)
    assert client.pods().get("upd").spec.node_name == "node007"
    assert sched.queue.stats()["unschedulable"] == 0


def test_scan_backlog_priority_bypass_flushes_before_plain_wave(engine):
    """``:598``: with the wave-count bound out of the way, a deferred pod
    that outranks the plain pods still binds while they are pending: the
    backlog flushes before each lower-priority wave."""
    client, svc = engine
    for node in zone_nodes(tobj, n=16, cpu="64", pods=500):
        client.nodes().create(node)
    client.pods().create(spread_pod(tobj, "spread-hi", "s", skew=2,
                                    cpu="100m", priority=100))
    client.pods().create_many([
        tobj.make_pod(f"plain{i:03d}", requests={"cpu": "100m"}, priority=0)
        for i in range(240)])
    sched = new_engine_with(svc, SCAN_DEFER_MAX_WAVES=10**6)
    assert wait_for(lambda: client.pods().get("spread-hi").spec.node_name)
    assert _plain_left(client, 240) > 0
    assert sched.loop_errors == 0


def new_engine_with(svc, **attrs):
    """Start the engine with class attributes overridden on the instance
    before its loop runs."""
    from minisched_tpu_torch.service import service as tservice

    orig = tservice.new_device_scheduler

    def patched(*args, **kw):
        sched = orig(*args, **kw)
        for name, value in attrs.items():
            setattr(sched, name, value)
        return sched

    tservice.new_device_scheduler = patched
    try:
        return _start(svc)
    finally:
        tservice.new_device_scheduler = orig


def test_failed_scan_flush_parks_backlog_and_counts(engine):
    """``:666``: a raise inside the scan lane parks the swapped-out
    backlog through ``error_func`` instead of dropping it; the port also
    counts it in ``loop_errors``."""
    client, svc = engine
    for node in zone_nodes(tobj, n=4):
        client.nodes().create(node)
    sched = _start(svc)

    def boom(*args, **kw):
        raise RuntimeError("scan lane exploded")

    sched._schedule_scan = boom
    client.pods().create(spread_pod(tobj, "victim", "s", skew=2,
                                    cpu="100m"))
    def parked():
        st = sched.queue.stats()
        return st["unschedulable"] + st["backoff"] + st["active"] >= 1

    assert wait_for(lambda: sched.loop_errors >= 1 and parked())
    assert "exploded" in str(sched.last_loop_error)
    assert not client.pods().get("victim").spec.node_name


def test_park_scan_failures_redefers_assumed_pod_when_store_unreachable(
        engine, monkeypatch):
    """``:723``: an assumed pod whose commit cannot be checked (the store
    read raises) is deferred again with its assumption kept, never
    dropped; an unassumed pod updated while deferred is parked with its
    current spec."""
    client, svc = engine
    client.nodes().create(tobj.make_node(
        "node000", capacity={"cpu": "8", "memory": "16Gi", "pods": 110}))
    sched = _start(svc)
    sched.stop()
    client.pods().create(tobj.make_pod("assumed1", requests={"cpu": "100m"}))
    client.pods().create(tobj.make_pod("stale1", requests={"cpu": "100m"}))
    snap_assumed = client.pods().get("assumed1")
    snap_stale = client.pods().get("stale1")
    cur = client.pods().get("stale1")
    cur.metadata.labels = {"v": "2"}
    client.pods().update(cur)
    pods_inf = sched.informer_factory.informer_for("Pod")
    assert wait_for(
        lambda: pods_inf.get("default/assumed1") is not None
        and (pods_inf.get("default/stale1") or snap_stale
             ).metadata.resource_version
        != snap_stale.metadata.resource_version)
    sched._assume(snap_assumed, "node000")
    pods_api = type(client.pods())

    def unreachable(self, name, namespace="default"):
        raise ConnectionError("store unreachable")

    monkeypatch.setattr(pods_api, "get", unreachable)
    q_assumed = QueuedPodInfo(PodInfo(snap_assumed))
    q_stale = QueuedPodInfo(PodInfo(snap_stale))
    sched._park_scan_failures([q_assumed, q_stale],
                              RuntimeError("scan failed"))
    monkeypatch.undo()
    assert sched._scan_backlog == [q_assumed]
    assert sched.assumed_count() == 1
    assert q_stale.pod.metadata.labels == {"v": "2"}
    st = sched.queue.stats()
    assert st["unschedulable"] + st["backoff"] + st["active"] >= 1


def test_wave_metric_observed_on_every_exit_path(engine):
    """``:794``: ``wave`` is observed on the empty-roster exit and on a
    wave whose pods are all deferred, so the loop's phases still add up
    to its wall."""
    client, svc = engine
    sched = _start(svc)  # no nodes: the empty-roster exit
    sched.stop()
    sched.metrics = CycleMetrics()
    client.pods().create(tobj.make_pod("p1", requests={"cpu": "100m"}))
    sched.schedule_wave([QueuedPodInfo(PodInfo(client.pods().get("p1")))])
    assert sched.metrics.snapshot()["wave"]["count"] == 1
    client.pods().create(spread_pod(tobj, "p2", "s", cpu="100m"))
    q2 = QueuedPodInfo(PodInfo(client.pods().get("p2")))
    sched.schedule_wave([q2])
    assert sched.metrics.snapshot()["wave"]["count"] == 2
    assert sched._scan_backlog == [q2]


def test_chain_without_cross_pod_plugins_never_defers(monkeypatch):
    """A roster without the cross-pod plugins never evaluates the
    constraints: a spread pod rides the repair wave like any other (the
    JAX ``_has_cross_pod``)."""
    monkeypatch.setenv("MINISCHED_PIPELINE", "0")
    client = TClient()
    for node in zone_nodes(tobj, n=4):
        client.nodes().create(node)
    client.pods().create(spread_pod(tobj, "spread", "s", cpu="100m"))
    svc = TService(client)
    try:
        sched = svc.start_scheduler(tconfig.node_local_roster_config(),
                                    device_mode=True, device="cpu")
        assert not sched._has_cross_pod
        assert wait_for(lambda: client.pods().get("spread").spec.node_name)
        assert sched.scan_stats["exact"].calls == 0
        assert sched.scan_stats["blocked"].calls == 0
    finally:
        svc.close()


def test_stop_parks_the_deferred_pods(engine):
    """A stop with pods still deferred parks them through ``error_func``
    on the loop thread: none is dropped."""
    client, svc = engine
    for node in zone_nodes(tobj, n=4):
        client.nodes().create(node)
    sched = new_engine_with(svc, SCAN_DEFER_MAX_WAVES=10**6)
    flushed = []
    sched._flush_scan_backlog = lambda: flushed.append(1)
    client.pods().create(spread_pod(tobj, "deferred", "s", cpu="100m"))
    assert wait_for(lambda: len(sched._scan_backlog) == 1 and flushed)
    sched.stop()
    assert sched._scan_backlog == []
    assert sched.queue.stats()["unschedulable"] == 1
