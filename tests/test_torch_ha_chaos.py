"""HA engines of the port: concurrent engines, real SIGKILLs, exactly-once
binds, on the CPU.

The port's copy of JAX's ``tests/test_ha_chaos.py::test_ha_engine_kill_smoke``
(``:111``; the soak ``:177`` stays JAX's and ``slow``): three engines run
as separate processes (``ha.proc.EngineSupervisor``, each the port's
device engine with ``device="cpu"``) against one WAL-backed façade, each
admitting only its rendezvous shard; one is SIGKILLed mid-run and the
survivors must drop it within the lease TTL, adopt its shard and finish,
the WAL's whole history showing every pod bound once.

Beside it: a child asked for a CUDA device the machine lacks exits
non-zero and ``start()`` raises with its stderr; phase 34's flow
(``live.run_config5_ha``) at 100 nodes and 1,000 pods; a single-member
``start_ha_engine`` places a small config 5 exactly as plain
``start_scheduler`` does; with two members each engine binds exactly the
pods JAX's ``Membership.owns_pod`` gives it; the port's membership keeps
its view while the engine holds its dispatch gate (a lease that reads
expired in the held cache is read again from the store), where JAX's
drops a live peer.  Every child is stopped in a ``finally``.
"""

from __future__ import annotations

import time

import pytest
import torch

from minisched_tpu_torch.api.objects import make_node, make_pod
from minisched_tpu_torch.controlplane.client import Client
from minisched_tpu_torch.controlplane.durable import DurableObjectStore
from minisched_tpu_torch.controlplane.httpserver import start_api_server
from minisched_tpu_torch.controlplane.remote import RemoteClient
from minisched_tpu_torch.controlplane.store import ObjectStore
from minisched_tpu_torch.faults import wal_double_binds
from minisched_tpu_torch.ha.lease import HA_NAMESPACE
from minisched_tpu_torch.ha.proc import NO_DEVICE_EXIT, EngineSupervisor
from tests.test_torch_chaos_soak import SEED, _audit_capacity


def _boot_cluster(client, n_nodes: int, pods) -> None:
    client.nodes().create_many([
        make_node(f"node{i:03d}",
                  capacity={"cpu": "8", "memory": "16Gi", "pods": 110})
        for i in range(n_nodes)])
    client.pods().create_many(pods)


def _make_pods(prefix: str, n: int):
    return [make_pod(f"{prefix}{i:04d}",
                     requests={"cpu": "500m", "memory": "64Mi"})
            for i in range(n)]


def _bound_count(client) -> int:
    try:
        return sum(1 for p in client.pods().list() if p.spec.node_name)
    except Exception:
        return -1  # plane down mid-poll: the caller retries


def _wait_bound(client, want: int, deadline_s: float) -> int:
    deadline = time.monotonic() + deadline_s
    bound = 0
    while time.monotonic() < deadline:
        n = _bound_count(client)
        bound = max(bound, n)
        if n >= want:
            return n
        time.sleep(0.2)
    return bound


def _member_leases(client) -> dict:
    """holder → lease in the HA namespace (may raise while the plane is
    down: callers poll)."""
    return {l.spec.holder: l for l in client.store.list("Lease")
            if l.metadata.namespace == HA_NAMESPACE}


def _wait_adoption(client, survivors, pre_epochs, deadline_s: float):
    """Seconds until every survivor's published epoch moved past its
    pre-kill value and the live member set equals ``survivors``; None on
    timeout."""
    t0 = time.monotonic()
    deadline = t0 + deadline_s
    while time.monotonic() < deadline:
        try:
            leases = _member_leases(client)
        except Exception:
            time.sleep(0.05)
            continue
        now = time.time()
        live = {h for h, l in leases.items() if not l.expired(now)}
        if live == set(survivors) and all(
                leases[h].spec.epoch > pre_epochs.get(h, 0)
                for h in survivors):
            return time.monotonic() - t0
        time.sleep(0.05)
    return None


def test_ha_engine_kill_smoke(tmp_path):
    """Three engines over one WAL-backed control plane, one SIGKILL
    mid-run: exactly-once binds, TTL-bounded adoption, capacity audit."""
    wal = str(tmp_path / "ha.wal")
    store = DurableObjectStore(wal, archive_compacted=True)
    _server, base, shutdown = start_api_server(store)
    client = RemoteClient(base, retries=8, backoff_initial_s=0.05)
    ttl = 2.0
    n_nodes, first, second = 8, 60, 30
    _boot_cluster(client, n_nodes, _make_pods("hp", first))
    engines = [EngineSupervisor(base, f"engine-{i}", ttl_s=ttl, device="cpu")
               for i in range(3)]
    try:
        for e in engines:
            e.start()
        assert _wait_bound(client, first, 90.0) == first, (
            "3-engine plane never bound the first burst")
        # seed-pinned victim; the survivors' published epochs before it
        victim = SEED % len(engines)
        survivors = [e.engine_id for i, e in enumerate(engines)
                     if i != victim]
        pre = {h: l.spec.epoch for h, l in _member_leases(client).items()}
        engines[victim].kill()
        assert engines[victim].kills == 1
        # the orphaned shard's pods keep arriving after the death
        client.pods().create_many(_make_pods("hq", second))
        adopt_s = _wait_adoption(client, survivors, pre,
                                 deadline_s=ttl + ttl / 3.0 + 2.0)
        assert adopt_s is not None, "survivors never adopted the shard"
        # expiry within the TTL, detection within a tick of it
        assert adopt_s <= ttl + ttl / 3.0 + 1.5, adopt_s
        want = first + second
        assert _wait_bound(client, want, 120.0) == want, (
            "orphaned shard's pods never landed after adoption")
        bound = [p for p in client.pods().list() if p.spec.node_name]
        _audit_capacity(client, bound, 500, 8000)
    finally:
        for e in engines:
            e.stop()
        shutdown()
        store.close()
    # no lost or duplicated bind across the whole archived history
    assert wal_double_binds(wal) == []
    re = DurableObjectStore(wal)
    try:
        assert sum(1 for p in re.list("Pod") if p.spec.node_name) == (
            first + second)
    finally:
        re.close()


def test_engine_child_without_its_device_exits_and_start_raises():
    """No silent CPU engine: a child asked for a CUDA device this machine
    lacks exits with ``NO_DEVICE_EXIT`` before it joins, and ``start()``
    raises with the child's stderr."""
    store = ObjectStore()
    _server, base, shutdown = start_api_server(store)
    missing = f"cuda:{torch.cuda.device_count()}"
    eng = EngineSupervisor(base, "engine-x", device=missing)
    try:
        with pytest.raises(RuntimeError,
                           match=rf"exitcode {NO_DEVICE_EXIT}\).*no CUDA "
                                 rf"device '{missing}'"):
            eng.start()
        assert not eng.alive()
        assert store.list("Lease") == []  # it never joined
    finally:
        eng.stop()
        shutdown()


def test_run_config5_ha_on_the_cpu(tmp_path):
    """Phase 34's flow at 100 nodes and 1,000 pods on the CPU: three
    engine children, the middle one SIGKILLed after 200 watched binds;
    adoption within ``ttl + ttl/3 + 1.5`` s, every plain pod bound once,
    the audits and fsck (``run_config5_ha`` raises otherwise)."""
    from minisched_tpu_torch.live import run_config5_ha

    run = run_config5_ha(str(tmp_path), 100, 1_000, kill_binds=200,
                         device="cpu", timeout_s=120.0, boot_timeout_s=120.0)
    assert run.victim == "engine-1"
    assert sorted(run.binds) == ["engine-0", "engine-1", "engine-2"]
    assert run.audit["bound"] == run.n_plain
    assert run.double_binds == 0 and run.fsck_rc == 0
    assert all(n >= 1 for n in run.plain_calls.values())
    assert not run.children_left


def _c5_small():
    from minisched_tpu_torch.fullchain import mk_c5_cluster

    nodes, pods = mk_c5_cluster(64, 600)
    for p in pods:
        p.metadata.uid = f"uid-{p.metadata.name}"
    return nodes, pods


def _placements(client):
    return {p.metadata.name: p.spec.node_name for p in client.pods().list()}


def _wait_placed(client, pods, timeout_s=120.0) -> None:
    plain = {p.metadata.name for p in pods
             if not p.metadata.name.startswith("special")}
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = _placements(client)
        if all(got.get(n) for n in plain):
            return
        time.sleep(0.05)
    raise AssertionError("plain pods not all bound")


def test_single_member_ha_engine_places_as_start_scheduler(monkeypatch):
    """A plane of one admits every pod: ``start_ha_engine`` places a
    small config 5 copy (64 nodes, 600 pods, created once the engine
    runs) exactly as plain ``start_scheduler`` does."""
    from minisched_tpu_torch.ha.plane import start_ha_engine
    from minisched_tpu_torch.service.config import default_full_roster_config
    from minisched_tpu_torch.service.service import SchedulerService

    monkeypatch.setenv("MINISCHED_PIPELINE", "0")
    runs = {}
    for how in ("plain", "ha"):
        nodes, pods = _c5_small()
        client = Client(ObjectStore())
        client.nodes().create_many(nodes)
        if how == "plain":
            svc = SchedulerService(client)
            svc.start_scheduler(default_full_roster_config(), max_wave=128,
                                device="cpu")
            stop = svc.close
        else:
            ha = start_ha_engine(client, "engine-0",
                                 cfg=default_full_roster_config(),
                                 max_wave=128, device="cpu")
            stop = ha.stop
        try:
            client.pods().create_many(pods)
            _wait_placed(client, pods)
            runs[how] = _placements(client)
        finally:
            stop()
    assert runs["ha"] == runs["plain"]
    assert sum(1 for v in runs["ha"].values() if v) >= 500


def test_two_members_each_bind_exactly_jax_owns_pod_set(monkeypatch):
    """Two HA engines in one process over one store: once both see both
    members, each binds exactly the pods JAX's ``Membership.owns_pod``
    gives it over that member set."""
    from minisched_tpu.api.objects import make_pod as j_make_pod
    from minisched_tpu.controlplane.client import Client as JClient
    from minisched_tpu.controlplane.store import ObjectStore as JStore
    from minisched_tpu.ha.membership import Membership as JMembership
    from minisched_tpu_torch.ha.plane import start_ha_engine
    from minisched_tpu_torch.service.config import default_full_roster_config

    monkeypatch.setenv("MINISCHED_PIPELINE", "0")
    store = ObjectStore()
    setup = Client(store)
    setup.nodes().create_many([
        make_node(f"node{i:03d}",
                  capacity={"cpu": "64", "memory": "64Gi", "pods": 110})
        for i in range(16)])
    bound_by = {}

    def recorder(engine_id):
        def on_decision(pod, node_name, status):
            if node_name:
                bound_by[pod.metadata.name] = engine_id
        return on_decision

    ids = ("engine-0", "engine-1")
    engines = []
    try:
        for eid in ids:
            engines.append(start_ha_engine(
                Client(store), eid, cfg=default_full_roster_config(),
                ttl_s=5.0, max_wave=64, device="cpu",
                on_decision=recorder(eid)))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not all(
                e.membership.members() == ids for e in engines):
            time.sleep(0.02)
        assert all(e.membership.members() == ids for e in engines)
        pods = [make_pod(f"hp{i:04d}", requests={"cpu": "100m"})
                for i in range(300)]
        for p in pods:
            p.metadata.uid = f"uid-{p.metadata.name}"
        setup.pods().create_many(pods)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and len(bound_by) < len(pods):
            time.sleep(0.05)
    finally:
        for e in engines:
            e.stop()
    want = {}
    for eid in ids:
        jm = JMembership(JClient(JStore()), eid)
        jm._members = ids
        for p in pods:
            jp = j_make_pod(p.metadata.name)
            jp.metadata.uid = p.metadata.uid
            if jm.owns_pod(jp):
                want[p.metadata.name] = eid
    assert len(want) == len(pods)
    assert bound_by == want
    assert set(want.values()) == set(ids)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_held_dispatch_and_the_member_view(side):
    """The device engine holds its informer factory's dispatch from a
    bind batch to its next device call (``pause_dispatch``), on a card
    nearly all the time.  With the dispatch held longer than the TTL
    while both members keep renewing, JAX's membership (its Lease
    informer held too) reads every lease as expired at the next
    recompute, its own included, and so owns every pod (a plane of
    one); the port's reads those leases again from the store, finds
    them live and keeps both."""
    if side == "jax":
        from minisched_tpu.controlplane.client import Client as C
        from minisched_tpu.controlplane.informer import (
            SharedInformerFactory as F,
        )
        from minisched_tpu.controlplane.store import ObjectStore as S
        from minisched_tpu.ha.membership import Membership as M
    else:
        from minisched_tpu_torch.controlplane.informer import (
            SharedInformerFactory as F,
        )
        from minisched_tpu_torch.ha.membership import Membership as M
        C, S = Client, ObjectStore
    store = S()
    # renewals every 0.1 s, a TTL of 0.9 s, the gate held 1.5 s: past
    # the TTL, and short of the held informer's own 2 s wait
    me = M(C(store), "me", ttl_s=0.9, heartbeat_interval_s=0.1)
    peer = M(C(store), "peer", ttl_s=0.9, heartbeat_interval_s=0.1)
    factory = F(store)
    me.join()
    peer.join()
    me.attach(factory)
    factory.start()
    assert factory.wait_for_cache_sync(5.0)
    me.start()  # both renew throughout
    peer.start()
    try:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and me.members() != ("me",
                                                                "peer"):
            me.recompute()
            time.sleep(0.02)
        assert me.members() == ("me", "peer")
        factory.pause_dispatch()  # the engine's gate, held
        time.sleep(1.5)  # past the TTL; both renewed meanwhile
        me.recompute()  # the heartbeat's recompute
        held_view = me.members()
        owned = sum(me.owns(f"pod-{i:08d}") for i in range(400))
    finally:
        factory.resume_dispatch()
        me.stop(release=False)
        peer.stop(release=False)
        factory.shutdown()
    if side == "jax":
        assert held_view == () and owned == 400
    else:
        assert held_view == ("me", "peer") and 0 < owned < 400
