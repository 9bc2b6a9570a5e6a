"""The port's live engine over a device mesh, against its mesh-off path.

Mirrors JAX's ``tests/test_mesh_live.py`` (parity and the degenerate
mesh ``:107``, the policy ``:142``, gangs with the full roster ``:153``,
the fallback ladder ``:199``, the scan lane ``:247``), the mesh cases of
``test_device_scheduler.py`` (``:204`` a sharded live engine with
per-pod diagnosis, ``:368`` the blocked lane inside a mesh engine),
``test_churn.py:153`` (the mesh builder's idle-wave skip),
``test_cross_pod.py:228`` (the sharded step with constraint tables) and
``test_chaos.py:23`` (a WAL store, a flaky API, the mesh, crash
recovery), with the ``mesh.evaluate`` point armed there too.  The port's
engine runs on the CPU twins over a virtual mesh of the host
(``make_mesh(8, devices=[cpu] * 8)``: 2 x 4); every pod's uid is pinned
to its name (the tie-break seed), so the runs are comparable pod for
pod, and the mesh-off port engine is the JAX engine's twin
(``tests/test_torch_engine.py``), checked here once more on the simple
cluster.
"""

from __future__ import annotations

import random
import threading
import time

import numpy as np
import pytest
import torch

from minisched_tpu_torch.api.objects import (
    LabelSelector,
    TopologySpreadConstraint,
    make_gang_pods,
    make_node,
    make_pod,
)
from minisched_tpu_torch.controlplane.client import Client
from minisched_tpu_torch.controlplane.durable import DurableObjectStore
from minisched_tpu_torch.faults import FaultFabric
from minisched_tpu_torch.live import run_mesh_ladder
from minisched_tpu_torch.observability import counters
from minisched_tpu_torch.parallel import sharding
from minisched_tpu_torch.service.config import (
    default_full_roster_config,
    default_scheduler_config,
    gang_roster_config,
)
from minisched_tpu_torch.service.service import SchedulerService

CPU = torch.device("cpu")


def cpu_mesh(n: int = 8, pod_shards=None) -> sharding.Mesh:
    return sharding.make_mesh(n, pod_shards, devices=[CPU] * n)


@pytest.fixture(autouse=True)
def _serial_two_threads(monkeypatch):
    monkeypatch.setenv("MINISCHED_PIPELINE", "0")
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _wait_bound(client, n, timeout=180.0, sched=None):
    deadline = time.monotonic() + timeout
    bound = {}
    while time.monotonic() < deadline:
        bound = {p.metadata.name: p.spec.node_name
                 for p in client.pods().list() if p.spec.node_name}
        if len(bound) >= n:
            return bound
        if sched is not None and sched.loop_errors:
            raise AssertionError(f"loop raised: {sched.last_loop_error!r}")
        time.sleep(0.05)
    raise AssertionError(f"only {len(bound)}/{n} pods bound in {timeout}s")


def _run_live(nodes, pods, cfg, device_mesh, max_wave=1024, mesh_env=None,
              monkeypatch=None):
    """One engine lap over a store holding every node and pod (uids
    pinned to names): start, drain, return (placements, engine)."""
    if mesh_env is not None:
        monkeypatch.setenv("MINISCHED_MESH", mesh_env)
    client = Client()
    client.nodes().create_many([n.clone() for n in nodes],
                               return_objects=False)
    seeded = []
    for p in pods:
        c = p.clone()
        c.metadata.uid = f"uid-{c.metadata.name}"
        seeded.append(c)
    client.pods().create_many(seeded, return_objects=False)
    svc = SchedulerService(client)
    sched = svc.start_scheduler(cfg, device_mode=True, max_wave=max_wave,
                                device="cpu", device_mesh=device_mesh)
    try:
        bound = _wait_bound(client, len(pods), sched=sched)
    finally:
        svc.close()
    assert sched.loop_errors == 0
    return bound, sched


def _simple_cluster(objs_make_node=make_node, objs_make_pod=make_pod,
                    n_nodes=100, n_pods=150):
    rng = random.Random(11)
    nodes = [objs_make_node(f"node{i:03d}", unschedulable=rng.random() < 0.2,
                            capacity={"cpu": "16", "memory": "32Gi",
                                      "pods": 64})
             for i in range(n_nodes)]
    pods = [objs_make_pod(f"p{i:04d}",
                          requests={"cpu": "100m", "memory": "64Mi"})
            for i in range(n_pods)]
    return nodes, pods


@pytest.fixture(scope="module")
def simple_base():
    """The simple cluster (100 nodes over a 4-wide node axis: the last
    shard mostly padding) on the mesh-off port engine, and on the JAX
    engine (mesh off, serial, the same uids)."""
    from minisched_tpu.api import objects as jobj
    from minisched_tpu.controlplane.client import Client as JClient
    from minisched_tpu.service.config import (
        default_scheduler_config as jdefault,
    )
    from minisched_tpu.service.service import SchedulerService as JService

    mp = pytest.MonkeyPatch()
    mp.setenv("MINISCHED_PIPELINE", "0")
    mp.setenv("MINISCHED_MESH", "0")
    try:
        nodes, pods = _simple_cluster()
        base, sched = _run_live(nodes, pods, default_scheduler_config(),
                                device_mesh=None)
        assert sched.mesh is None
        jnodes, jpods = _simple_cluster(jobj.make_node, jobj.make_pod)
        client = JClient()
        client.nodes().create_many(jnodes, return_objects=False)
        for p in jpods:
            p.metadata.uid = f"uid-{p.metadata.name}"
        client.pods().create_many(jpods, return_objects=False)
        svc = JService(client)
        svc.start_scheduler(jdefault(), device_mode=True, max_wave=1024,
                            device_mesh=None)
        try:
            jax_bound = _wait_bound(client, len(jpods))
        finally:
            svc.close()
    finally:
        mp.undo()
    return nodes, pods, base, jax_bound


@pytest.mark.parametrize("how", ["env", "explicit-2x4", "explicit-1x8",
                                 "degenerate", "3x1"])
def test_live_mesh_parity_simple_and_degenerate(how, simple_base,
                                                monkeypatch):
    """Mesh-off, ``MINISCHED_MESH=1`` (a CPU engine's policy: a 1 x 1 mesh
    of the host), explicit 2 x 4, 1 x 8 and 3 x 1 meshes and a degenerate
    1-device mesh: bit-identical placements, equal to the JAX engine's;
    100 live nodes on a 4-wide node axis leave the last shard mostly
    padding (``wave_mesh.pad_node_rows``)."""
    nodes, pods, base, jax_bound = simple_base
    assert base == jax_bound
    counters.reset()
    mesh = {"env": None, "explicit-2x4": cpu_mesh(8),
            "explicit-1x8": cpu_mesh(8, 1),
            "degenerate": cpu_mesh(1), "3x1": cpu_mesh(3, 3)}[how]
    meshed, sched = _run_live(
        nodes, pods, default_scheduler_config(), device_mesh=mesh,
        mesh_env="1" if how == "env" else "0", monkeypatch=monkeypatch)
    assert sched.mesh is not None
    if how == "env":
        assert sched.mesh.shape == {"pods": 1, "nodes": 1}
    assert meshed == base
    assert counters.get("wave_mesh.waves") > 0
    assert counters.get("wave_mesh.fallbacks") == 0
    ps, ns = sharding.mesh_axis_sizes(sched.mesh)
    assert counters.get("wave_mesh.pod_shards") == ps
    assert counters.get("wave_mesh.node_shards") == ns
    assert {"wave_mesh.pod_shards",
            "wave_mesh.node_shards"} <= counters.GLOBAL.gauge_names()
    if ns > 1:
        assert counters.get("wave_mesh.pad_node_rows") > 0


@pytest.mark.parametrize("env, mesh, want", [
    ("0", None, None), ("1", None, (1, 1)), ("1", False, None),
    ("", None, None), ("0", "2x4", (2, 4))])
def test_engine_mesh_policy(monkeypatch, env, mesh, want):
    """``DeviceScheduler(mesh=None)`` applies ``resolve_mesh`` for its
    device (one host device here); ``mesh=False`` pins one device."""
    from minisched_tpu_torch.engine.device_scheduler import (
        new_device_scheduler,
    )
    from minisched_tpu_torch.controlplane.informer import (
        SharedInformerFactory,
    )

    monkeypatch.setenv("MINISCHED_MESH", env)
    client = Client()
    sched = new_device_scheduler(client, SharedInformerFactory(client.store),
                                 device="cpu",
                                 mesh=cpu_mesh(8) if mesh == "2x4" else mesh)
    got = None if sched.mesh is None else sharding.mesh_axis_sizes(sched.mesh)
    assert got == want
    if want is not None:
        assert sched._wave_cap(10) % (128 * want[0]) == 0


def test_config_pins_a_mesh(monkeypatch):
    """``SchedulerConfig.mesh_devices``/``mesh_pod_shards`` build exactly
    that mesh over the engine's visible devices (JAX ``:2481-2511``)."""
    from minisched_tpu_torch.controlplane.informer import (
        SharedInformerFactory,
    )
    from minisched_tpu_torch.engine.device_scheduler import (
        new_device_scheduler,
    )

    monkeypatch.setenv("MINISCHED_MESH", "0")
    cfg = default_full_roster_config()
    cfg.mesh_devices = 1
    client = Client()
    sched = new_device_scheduler(client, SharedInformerFactory(client.store),
                                 cfg, device="cpu")
    assert sharding.mesh_axis_sizes(sched.mesh) == (1, 1)
    cfg.mesh_devices = 2
    with pytest.raises(ValueError, match="only 1 available"):
        new_device_scheduler(client, SharedInformerFactory(client.store),
                             cfg, device="cpu")


def test_live_mesh_parity_gangs_full_roster():
    """The gang roster (full default chain, Coscheduling, GangTopology)
    over a 2 x 4 mesh: gangs admit all or nothing and land as on the
    mesh-off engine."""
    rng = random.Random(5)
    nodes = []
    for s in range(2):
        for h in range(8):
            nodes.append(make_node(
                f"slice{s}-host{h}",
                capacity={"cpu": "16", "memory": "32Gi", "pods": 64},
                slice_id=f"slice{s}", torus=(h % 4, h // 4, 0),
                host_index=h, slice_dims=(4, 2, 0)))
    nodes += [make_node(f"plain{i:02d}", unschedulable=rng.random() < 0.2,
                        capacity={"cpu": "16", "memory": "32Gi", "pods": 64})
              for i in range(20)]
    pods = (make_gang_pods("ga", 4, requests={"cpu": "500m"})
            + [make_pod(f"s{i:03d}", requests={"cpu": "250m"})
               for i in range(40)]
            + make_gang_pods("gb", 3, requests={"cpu": "500m"}))
    cfg = gang_roster_config()
    base, _ = _run_live(nodes, pods, cfg, device_mesh=None, max_wave=128)
    meshed, sched = _run_live(nodes, pods, cfg, device_mesh=cpu_mesh(8),
                              max_wave=128)
    assert sched.mesh is not None
    assert meshed == base
    for g, size in (("ga", 4), ("gb", 3)):
        members = [v for k, v in meshed.items() if k.startswith(f"{g}-")]
        assert len(members) == size and all(members)


@pytest.mark.parametrize("shape", [(2, 4), (1, 3)], ids=["2x4", "1x3"])
def test_mesh_sharding_failure_falls_back_per_wave(shape):
    """``mesh.evaluate`` armed once: that wave degrades to the
    single-device evaluator (counted, the same wave still placed), the
    next batch's waves are sharded again; every pod bound, no node over
    its pods."""
    ps, ns = shape
    run = run_mesh_ladder(cpu_mesh(ps * ns, ps), device="cpu")
    assert run.fires == 1 and run.loop_errors == 0
    assert run.after_first == {"wave_mesh.waves": 0,
                               "wave_mesh.fallbacks": 1}
    assert run.after_second["wave_mesh.fallbacks"] == 1
    assert run.after_second["wave_mesh.waves"] >= 1
    assert all(run.placements.values()) and len(run.placements) == 60
    per_node = {}
    for node in run.placements.values():
        per_node[node] = per_node.get(node, 0) + 1
    assert max(per_node.values()) <= 64


def test_scan_lane_mesh_parity():
    """The exact scan in the scan layout over the mesh builder's node
    shards (70 nodes: uneven on any node axis) equals the mesh-off scan
    over the builder's whole table."""
    from minisched_tpu_torch.framework.nodeinfo import build_node_infos
    from minisched_tpu_torch.models.constraints import build_constraint_tables
    from minisched_tpu_torch.models.tables import (
        CachedNodeTableBuilder,
        build_pod_table,
    )
    from minisched_tpu_torch.ops.sequential import SequentialScheduler
    from minisched_tpu_torch.plugins.nodenumber import NodeNumber
    from minisched_tpu_torch.plugins.nodeunschedulable import (
        NodeUnschedulable,
    )

    rng = random.Random(3)
    nodes = [make_node(f"n{i:03d}", unschedulable=rng.random() < 0.3)
             for i in range(70)]
    pods = [make_pod(f"p{i}") for i in range(40)]
    for p in pods:
        p.metadata.uid = p.metadata.name
    infos = build_node_infos(nodes, [])
    pt, _ = build_pod_table(pods, capacity=128, device="cpu")
    extra = build_constraint_tables(pods, nodes, [], pod_capacity=128,
                                    node_capacity=128, scan_planes=True,
                                    device="cpu")

    def run(mesh):
        b = CachedNodeTableBuilder("cpu", mesh=mesh)
        nt, _ = b.build(infos)
        if mesh is not None:
            assert isinstance(nt, sharding.NodeShards)
        nn = NodeNumber()
        scan = SequentialScheduler((NodeUnschedulable(),), (nn,), (nn,),
                                   weights={"NodeNumber": 1}, mesh=mesh)
        _, choice, best = scan(pt, nt, extra)
        return choice.tolist(), best.tolist()

    assert run(cpu_mesh(8)) == run(None)


def test_live_engine_sharded_over_mesh():
    """JAX ``test_device_scheduler.py:204``: the live engine over the 2 x 4
    mesh binds everything safely, and the per-pod diagnosis parks the one
    unschedulable pod with NodeAffinity among its failing plugins."""
    client = Client()
    for i in range(24):
        client.nodes().create(make_node(
            f"node{i:02d}", unschedulable=i % 6 == 0,
            capacity={"cpu": "2", "memory": "4Gi", "pods": 110}))
    for i in range(40):
        client.pods().create(make_pod(f"pod{i}", requests={"cpu": "500m"}))
    client.pods().create(make_pod("picky", requests={"cpu": "500m"},
                                  node_selector={"nope": "true"}))
    svc = SchedulerService(client)
    sched = svc.start_scheduler(default_full_roster_config(),
                                device_mode=True, max_wave=16, device="cpu",
                                device_mesh=cpu_mesh(8))
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            bound = [p for p in client.pods().list() if p.spec.node_name]
            if len(bound) == 40 and sched.queue.stats()["unschedulable"] == 1:
                break
            time.sleep(0.1)
        assert len(bound) == 40, f"only {len(bound)} bound"
        [qpi] = sched.queue.pending_unschedulable()
        assert qpi.pod.metadata.name == "picky"
        assert "NodeAffinity" in qpi.unschedulable_plugins
        per_node = {}
        for p in bound:
            per_node[p.spec.node_name] = per_node.get(p.spec.node_name, 0) + 1
            assert not client.nodes().get(p.spec.node_name).spec.unschedulable
        assert all(cnt * 500 <= 2000 for cnt in per_node.values())
        assert sched.loop_errors == 0
    finally:
        svc.shutdown_scheduler()


def test_blocked_scan_lane_under_mesh():
    """JAX ``test_device_scheduler.py:368``: a spread burst bigger than
    the block size on a mesh engine rides the blocked lane (unsharded
    inside the mesh engine): every pod binds, DoNotSchedule skew holds,
    no node over its CPU."""
    from minisched_tpu_torch.engine.device_scheduler import DeviceScheduler

    client = Client()
    n_zones = 4
    for i in range(32):
        client.nodes().create(make_node(
            f"node{i:03d}", labels={"zone": f"z{i % n_zones}"},
            capacity={"cpu": "8", "memory": "16Gi", "pods": 110}))
    n_spread, n_plain, n_apps = 48, 40, 6
    for i in range(n_plain):
        client.pods().create(make_pod(f"plain{i:03d}",
                                      requests={"cpu": "250m"}))
    for i in range(n_spread):
        app = f"app{i % n_apps}"
        p = make_pod(f"spread{i:03d}", labels={"app": app},
                     requests={"cpu": "250m", "memory": "128Mi"})
        p.spec.topology_spread_constraints = [TopologySpreadConstraint(
            max_skew=1, topology_key="zone",
            when_unsatisfiable="DoNotSchedule",
            label_selector=LabelSelector(match_labels={"app": app}))]
        client.pods().create(p)
    assert 1 < DeviceScheduler.SCAN_BLOCK_SIZE < n_spread
    svc = SchedulerService(client)
    sched = svc.start_scheduler(default_full_roster_config(),
                                device_mode=True, max_wave=128, device="cpu",
                                device_mesh=cpu_mesh(8))
    try:
        bound = list(_wait_bound(client, n_plain + n_spread, 300,
                                 sched).items())
        zone_of = {n.metadata.name: n.metadata.labels["zone"]
                   for n in client.nodes().list()}
        per_app, cpu = {}, {}
        for name, node in bound:
            cpu[node] = cpu.get(node, 0) + 250
            if name.startswith("spread"):
                app = client.pods().get(name).metadata.labels["app"]
                zones = per_app.setdefault(
                    app, {f"z{k}": 0 for k in range(n_zones)})
                zones[zone_of[node]] += 1
        for app, zones in per_app.items():
            counts = list(zones.values())
            assert max(counts) - min(counts) <= 1, (app, zones)
        assert all(v <= 8000 for v in cpu.values())
        assert sched.scan_stats["blocked"].calls >= 1
        assert counters.get("wave_mesh.waves") >= 1
    finally:
        svc.shutdown_scheduler()



def test_mesh_engine_exact_lane_keeps_its_step_log(monkeypatch):
    """A burst of 24 spread pods (one flush, under the 32-pod block size)
    rides the exact scan of a mesh engine in the scan layout: its
    ``LaneStats`` count the steps as the mesh-off engine's do (a step a
    pod), and the placements are the mesh-off engine's."""
    zones = 4
    nodes = [make_node(f"node{i:03d}", labels={"zone": f"z{i % zones}"},
                       capacity={"cpu": "8", "memory": "16Gi", "pods": 110})
             for i in range(20)]
    pods = []
    for i in range(24):
        app = f"app{i % 2}"
        p = make_pod(f"spread{i:03d}", labels={"app": app},
                     requests={"cpu": "500m"})
        p.spec.topology_spread_constraints = [TopologySpreadConstraint(
            max_skew=1, topology_key="zone",
            when_unsatisfiable="DoNotSchedule",
            label_selector=LabelSelector(match_labels={"app": app}))]
        pods.append(p)
    laps = {}
    for name, mesh in (("off", None), ("mesh", cpu_mesh(8))):
        bound, sched = _run_live(nodes, pods, default_full_roster_config(),
                                 device_mesh=mesh, max_wave=32, mesh_env="0",
                                 monkeypatch=monkeypatch)
        assert (sched.mesh is not None) == (mesh is not None)
        laps[name] = bound, sched.scan_stats["exact"], sched.scan_stats[
            "blocked"]
    (off, off_exact, off_blocked), (on, on_exact, on_blocked) = (
        laps["off"], laps["mesh"])
    assert on == off
    assert off_blocked.calls == on_blocked.calls == 0
    assert on_exact.calls == off_exact.calls >= 1
    assert on_exact.steps == off_exact.steps >= len(pods)
    assert on_exact.placed == off_exact.placed == len(pods)


def _infos(n):
    from minisched_tpu_torch.framework.nodeinfo import build_node_infos

    nodes = [make_node(f"n{i:02d}", capacity={"cpu": "8", "memory": "16Gi",
                                               "pods": 20})
             for i in range(n)]
    return build_node_infos(nodes, [])


@pytest.mark.parametrize("node_shards", [4, 3])
def test_idle_wave_skip_under_mesh(node_shards):
    """JAX ``test_churn.py:153``: the mesh builder's tracked builds reuse
    the previous tables wholesale when nothing changed, bit-identical to
    a fresh mesh build; capacities quantize to the node axis."""
    from minisched_tpu_torch.models.tables import CachedNodeTableBuilder

    mesh = cpu_mesh(node_shards, 1)
    infos = _infos(10)  # uneven across the node axis on purpose
    delta = {"n01": [125, 16, 0, 1, 125, 16, []]}
    b = CachedNodeTableBuilder("cpu", mesh=mesh)
    b.build_host(infos, dirty=None, epoch=3)
    host1, _ = b.build_host(infos, agg_delta=delta, dirty=set(), epoch=3)
    assert not b.last_build_skipped
    before = counters.get("wave_build.skipped")
    host2, _ = b.build_host(infos, agg_delta=delta, dirty=set(), epoch=3)
    assert b.last_build_skipped and host2 is host1
    assert counters.get("wave_build.skipped") == before + 1
    assert host2.capacity % sharding.cap_multiple(128, node_shards) == 0
    fresh = CachedNodeTableBuilder("cpu", mesh=mesh)
    full, _ = fresh.build_host(infos, agg_delta={
        "n01": [125, 16, 0, 1, 125, 16, []]}, dirty=None)
    np.testing.assert_array_equal(host2.agg.flat, full.agg.flat)
    shards = b.place(host2)
    whole = b.place_default(host2)
    assert len(shards.shards) == node_shards
    got = sharding.gather_nodes(shards, CPU)
    for name in ("req_cpu", "req_pods", "valid", "name_hash", "profile_id",
                 "prof_label_key"):
        assert torch.equal(getattr(got, name), getattr(whole, name)), name
    assert set(b.static_dev_default()) >= {"name_hash", "prof_label_key"}


def test_sharded_wave_step_with_constraints():
    """JAX ``test_cross_pod.py:228``: the mesh step takes and splits the
    constraint tables; the anti-affine pods avoid the noisy zone, as
    JAX's sharded step places them."""
    import jax

    from minisched_tpu.api import objects as jobj
    from minisched_tpu.models.constraints import (
        build_constraint_tables as jbuild,
    )
    from minisched_tpu.models.tables import (
        build_node_table as jnode_table,
        build_pod_table as jpod_table,
    )
    from minisched_tpu.ops.fused import BatchContext as JCtx
    from minisched_tpu.parallel import sharding as jsh
    from minisched_tpu.plugins.interpodaffinity import (
        InterPodAffinity as JIPA,
    )
    from minisched_tpu.plugins.nodeunschedulable import (
        NodeUnschedulable as JNU,
    )
    from minisched_tpu_torch.models import constraints as tconstraints
    from minisched_tpu_torch.ops.fused import BatchContext
    from minisched_tpu_torch.plugins.interpodaffinity import InterPodAffinity
    from minisched_tpu_torch.plugins.nodeunschedulable import (
        NodeUnschedulable,
    )
    from tests.test_cross_pod import _affinity_pod, _assigned, _term, _zone_nodes
    from tests.test_torch_plugins import jax_columns, port_tables

    nodes = sorted(_zone_nodes(), key=lambda n: n.metadata.name)
    assigned = [_assigned("noisy", "node-a0", {"app": "noisy"})]
    pods = [_affinity_pod(f"q{i}", anti=[_term({"app": "noisy"})])
            for i in range(6)]
    jn, names = jnode_table(nodes, {"node-a0": assigned})
    jp, _ = jpod_table(pods)
    je = jbuild(pods, nodes, assigned, pod_capacity=jp.capacity,
                node_capacity=jn.capacity)
    jmesh = jsh.make_mesh(len(jax.devices()))
    jstep = jsh.sharded_wave_step(jmesh, [JNU(), JIPA()], [], [], JCtx())
    jp_s, jn_s = jsh.shard_tables(jmesh, jp, jn)
    _, jchoice, jbest = jstep(jn_s, jp_s, je)
    tn, tp = port_tables(jn, jp)
    te = tconstraints.constraint_tables_from_numpy(jax_columns(je), "cpu")
    step = sharding.sharded_wave_step(cpu_mesh(8), [NodeUnschedulable(),
                                                    InterPodAffinity()],
                                      [], [], BatchContext())
    _, choice, best = step(tp, tn, te)
    np.testing.assert_array_equal(choice.numpy(), np.asarray(jchoice))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    placed = [names[c] for c in choice.tolist()[: len(pods)] if c >= 0]
    assert len(placed) == len(pods)
    assert all(not n.startswith("node-a") for n in placed)


def test_wal_mesh_faults_requeue_audit_recovery(tmp_path):
    """JAX ``test_chaos.py:23`` on the port: a durable store whose every
    7th Pod update fails once, the device engine over the 2 x 4 mesh with
    ``mesh.evaluate`` armed (two fallbacks), park and requeue; every pod
    bound, the safety audit, and after a reopen every acknowledged bind
    recovered."""
    wal = str(tmp_path / "chaos.wal")
    store = DurableObjectStore(wal)
    client = Client(store=store)
    fail_lock = threading.Lock()
    state = {"count": 0, "failed": set()}

    def flaky(op, kind, key):
        if op != "update" or kind != "Pod":
            return
        with fail_lock:
            state["count"] += 1
            if state["count"] % 7 == 0 and key not in state["failed"]:
                state["failed"].add(key)
                raise RuntimeError("injected: apiserver unavailable")

    for i in range(16):
        client.nodes().create(make_node(
            f"node{i:02d}", unschedulable=i % 8 == 0,
            capacity={"cpu": "4", "memory": "8Gi", "pods": 110}))
    for i in range(40):
        client.pods().create(make_pod(f"pod{i}", requests={"cpu": "500m"}))
    counters.reset()
    svc = SchedulerService(client)
    store.fault_injector = flaky
    sched = svc.start_scheduler(default_full_roster_config(),
                                device_mode=True, max_wave=16, device="cpu",
                                device_mesh=cpu_mesh(8))
    sched.faults = FaultFabric(7).on("mesh.evaluate", rate=1.0, max_fires=2)
    try:
        deadline = time.monotonic() + 120
        bound = []
        while time.monotonic() < deadline:
            bound = [p for p in client.pods().list() if p.spec.node_name]
            if len(bound) == 40:
                break
            if sched.queue.stats()["unschedulable"]:
                sched.queue.flush_unschedulable_leftover()
                sched.queue.flush_backoff_completed()
            time.sleep(0.25)
        assert len(bound) == 40, (f"only {len(bound)} bound; "
                                  f"queue={sched.queue.stats()}")
        assert state["failed"], "fault injector never fired"
        assert sched.faults.fires("mesh.evaluate") >= 1
        assert counters.get("wave_mesh.fallbacks") == sched.faults.fires(
            "mesh.evaluate")
        assert counters.get("wave_mesh.waves") >= 1
        per_node = {}
        for p in bound:
            per_node[p.spec.node_name] = per_node.get(p.spec.node_name, 0) + 1
            assert not client.nodes().get(p.spec.node_name).spec.unschedulable
        assert all(cnt * 500 <= 4000 for cnt in per_node.values())
        placements = {p.metadata.name: p.spec.node_name for p in bound}
    finally:
        store.fault_injector = None
        svc.shutdown_scheduler()
        store.close()
    store2 = DurableObjectStore(wal)
    try:
        recovered = {p.metadata.name: p.spec.node_name
                     for p in store2.list("Pod") if p.spec.node_name}
    finally:
        store2.close()
    assert recovered == placements
