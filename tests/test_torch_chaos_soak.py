"""Chaos soak of the port: a seeded fault schedule against the whole
stack, on the CPU.

The port's copies of JAX's ``tests/test_chaos_soak.py`` (``:96`` in
process, ``:195`` over the wire), under JAX's names: a multi-wave
workload on the port's device engine (``device="cpu"``: the kernels'
plain twins) while the fault fabric fails store calls and bind batches,
refuses WAL appends, drops watch streams and (over the wire) answers 503
or resets connections.  Asserted is convergence, not survival: every pod
bound at quiesce, the assume ledger drained, no pod ever bound to two
nodes (the WAL history audit), no node over allocatable, and the armed
points fired.  ``MINISCHED_CHAOS_SEED`` (1234) pins the schedule.  The
helpers are shared with the port's disk and process chaos tests.
"""

from __future__ import annotations

import os
import time

from minisched_tpu_torch.api.objects import make_node, make_pod
from minisched_tpu_torch.controlplane.client import Client
from minisched_tpu_torch.controlplane.durable import DurableObjectStore
from minisched_tpu_torch.controlplane.httpserver import start_api_server
from minisched_tpu_torch.controlplane.remote import RemoteClient
from minisched_tpu_torch.controlplane.store import ObjectStore
from minisched_tpu_torch.faults import FaultFabric, InjectedFault
from minisched_tpu_torch.observability import counters
from minisched_tpu_torch.service.config import default_full_roster_config
from minisched_tpu_torch.service.service import SchedulerService

SEED = int(os.environ.get("MINISCHED_CHAOS_SEED", "1234"))


def _drive_to_convergence(client, sched, want: int, deadline_s: float):
    """The degraded-mode poll: wait for full placement, replaying
    parked pods, and tolerate the control plane failing our own reads."""
    deadline = time.monotonic() + deadline_s
    bound = []
    while time.monotonic() < deadline:
        try:
            bound = [p for p in client.pods().list() if p.spec.node_name]
        except Exception:
            time.sleep(0.1)  # injected list fault: poll again
            continue
        if len(bound) >= want:
            return bound
        try:
            if sched.queue.stats()["unschedulable"]:
                sched.queue.flush_unschedulable_leftover()
                sched.queue.flush_backoff_completed()
        except Exception:
            pass
        time.sleep(0.25)
    return bound


def _audit_capacity(client, bound, cpu_milli_per_pod: int, alloc_milli: int):
    """No cordoned placements, no node over allocatable at quiesce."""
    per_node: dict = {}
    for p in bound:
        per_node[p.spec.node_name] = per_node.get(p.spec.node_name, 0) + 1
    for name, cnt in per_node.items():
        node = client.nodes().get(name)
        assert not node.spec.unschedulable, f"pod on cordoned {name}"
        assert cnt * cpu_milli_per_pod <= alloc_milli, (name, cnt)


def _audit_no_double_bind(wal_path: str):
    """A pod uid bound to two different nodes anywhere in the WAL's
    history was bound twice."""
    from minisched_tpu_torch.faults import wal_double_binds

    assert wal_double_binds(wal_path) == []


def _wait_assume_drain(sched, timeout_s: float) -> None:
    """At quiesce the assume ledger must return to zero; anything left
    after several TTLs is leaked capacity."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with sched._assumed_lock:
            if not sched._assumed and not sched._assumed_agg:
                assert not sched._assumed_expiry
                return
        time.sleep(0.2)
    with sched._assumed_lock:
        raise AssertionError(
            f"assumed-capacity leak at quiesce: {list(sched._assumed)}")


def test_chaos_soak_inprocess_device_engine(tmp_path):
    """A WAL-durable store and the device wave engine under a seeded
    schedule of store get/create/update errors, WAL refusals, watch drops
    and whole-batch bind failures, across two pod bursts."""
    wal = str(tmp_path / "soak.wal")
    store = DurableObjectStore(wal)
    client = Client(store=store)
    n_nodes, n_pods = 24, 240
    for i in range(n_nodes):
        client.nodes().create(make_node(
            f"node{i:03d}", unschedulable=i % 8 == 0,
            capacity={"cpu": "8", "memory": "16Gi", "pods": 110}))
    pods = [make_pod(f"pod{i:04d}", requests={"cpu": "500m", "memory": "64Mi"})
            for i in range(n_pods)]
    for p in pods[:150]:
        client.pods().create(p)
    fabric = (
        FaultFabric(SEED)
        .on("store.update", rate=0.12)  # every bind is an update item
        .on("store.get", rate=0.08)
        .on("store.create", rate=0.10, max_fires=8)
        .on("watch.drop", rate=0.04, max_fires=12, keys={"Pod", "Node"})
        .on("wal.append", rate=0.04, max_fires=10)
        .on("engine.bind", rate=0.08, max_fires=10)
    )
    counters.reset()
    svc = SchedulerService(client)
    sched = svc.start_scheduler(default_full_roster_config(),
                                device_mode=True, max_wave=32, device="cpu")
    sched.faults = fabric
    sched.assume_ttl_s = 2.5
    # armed after boot: the scenario's own setup is not under test
    store.fault_injector = fabric.as_store_injector()
    store.faults = fabric
    try:
        def create_with_retry(p):
            for _ in range(20):
                try:
                    client.pods().create(p)
                    return
                except InjectedFault:
                    time.sleep(0.01)
            raise AssertionError("create retry budget exhausted")

        bound = _drive_to_convergence(client, sched, 40, 120.0)
        assert len(bound) >= 40, "first waves never landed"
        for p in pods[150:]:
            create_with_retry(p)
        bound = _drive_to_convergence(client, sched, n_pods, 240.0)
        assert len(bound) == n_pods, (
            f"only {len(bound)}/{n_pods} bound; queue={sched.queue.stats()} "
            f"faults={fabric.stats()} counters={counters.snapshot()}")
        _wait_assume_drain(sched, timeout_s=8 * sched.assume_ttl_s)
        # quiesce: disarm before auditing (the audit reads are ours)
        store.fault_injector = None
        store.faults = None
        _audit_capacity(client, bound, 500, 8000)
        # the points whose draw volume the workload guarantees fired;
        # store.get and engine.bind stay armed but unasserted (their draws
        # depend on timing), as in JAX
        fires = fabric.stats()["fires"]
        for point in ("store.update", "store.create", "watch.drop",
                      "wal.append"):
            assert fires.get(point, 0) > 0, (point, fires)
        assert counters.get("informer.reconnect") >= 1, counters.snapshot()
        assert sched.loop_errors == 0, sched.last_loop_error
    finally:
        store.fault_injector = None
        store.faults = None
        svc.shutdown_scheduler()
        store.close()
    _audit_no_double_bind(wal)
    # crash-recovery cross-check: the reopened WAL agrees on placements
    store2 = DurableObjectStore(wal)
    recovered = [p for p in store2.list("Pod") if p.spec.node_name]
    assert len(recovered) == n_pods
    store2.close()


def test_chaos_soak_over_the_wire():
    """The whole scheduling path over REST (informers, waves, batch
    binds) against a façade injecting 5xx and connection resets, with the
    remote client's timeouts and jittered retries carrying every hop,
    plus store-level watch drops killing live streams."""
    store = ObjectStore()
    setup = Client(store)
    n_nodes, n_pods = 10, 60
    for i in range(n_nodes):
        setup.nodes().create(make_node(
            f"node{i:03d}",
            capacity={"cpu": "8", "memory": "16Gi", "pods": 110}))
    for i in range(n_pods):
        setup.pods().create(make_pod(
            f"wp{i:03d}", requests={"cpu": "500m", "memory": "64Mi"}))
    fabric = (
        FaultFabric(SEED + 1)
        .on("http.500", rate=0.10, max_fires=40)
        .on("http.reset", rate=0.06, max_fires=25)
        .on("watch.drop", rate=0.03, max_fires=6, keys={"Pod", "Node"})
    )
    counters.reset()
    _server, base, shutdown = start_api_server(store, faults=fabric)
    client = RemoteClient(base, retries=8, backoff_initial_s=0.02,
                          retry_seed=SEED)
    svc = SchedulerService(client)
    try:
        sched = svc.start_scheduler(default_full_roster_config(),
                                    device_mode=True, max_wave=16,
                                    device="cpu")
        sched.assume_ttl_s = 2.5
        store.faults = fabric  # stream drops only once informers are up
        bound = _drive_to_convergence(client, sched, n_pods, 240.0)
        assert len(bound) == n_pods, (
            f"only {len(bound)}/{n_pods} bound over the wire; "
            f"queue={sched.queue.stats()} faults={fabric.stats()} "
            f"counters={counters.snapshot()}")
        _wait_assume_drain(sched, timeout_s=8 * sched.assume_ttl_s)
        # audit straight off the authoritative store, not the lossy wire
        _audit_capacity(setup, bound, 500, 8000)
        fires = fabric.stats()["fires"]
        assert fires.get("http.500", 0) > 0, fires
        assert fires.get("http.reset", 0) > 0, fires
        assert counters.get("remote.retry") > 0, counters.snapshot()
    finally:
        store.faults = None
        svc.shutdown_scheduler()
        shutdown()
