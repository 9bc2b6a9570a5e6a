"""The port's live engine against the JAX package's, end to end on the CPU.

The JAX ``DeviceScheduler`` (serial path, ``MINISCHED_PIPELINE=0``) with
the JAX ``Client``, and the port's with the port's ``Client``
(``device="cpu"``: the kernels' plain twins), run the same scenario: the
same cluster, built from one seed with each package's objects, with the
same pod uids (the tie-break seeds come from them).  Every pod must end
on the same node on both engines — placements are discrete, so the
comparison is exact.  Where a case depends on wave compositions, the
test records them on both engines and asserts them equal first.

Also here: the port's ``CachedNodeTableBuilder`` against the JAX one on
the engines' own snapshots with assumed pods, and preemption through the
wave-loser pass, above and at the priority floor, on both engines.
The cross-pod backlog and the pipeline are held against the JAX engine in
``test_torch_backlog.py`` and ``test_torch_pipeline.py``.  Every wait has
a deadline; no test asserts a wall time.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import fields, replace

import numpy as np
import pytest

from minisched_tpu.api import objects as jobj
from minisched_tpu.controlplane.client import Client as JClient
from minisched_tpu.engine import device_scheduler as jds
from minisched_tpu.engine.device_scheduler import DeviceScheduler as JEngine
from minisched_tpu.models.tables import CachedNodeTableBuilder
from minisched_tpu.service import config as jconfig
from minisched_tpu.service.service import SchedulerService as JService

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.controlplane.client import Client as TClient
from minisched_tpu_torch.engine.device_scheduler import (
    DeviceScheduler as TEngine,
)
from minisched_tpu_torch.ops.repair import RepairingEvaluator
from minisched_tpu_torch.scenario.runner import ScenarioHarness, readme_scenario
from minisched_tpu_torch.service import config as tconfig
from minisched_tpu_torch.service import service as tservice
from minisched_tpu_torch.service.service import SchedulerService as TService
from tests.test_torch_tables import assert_tables_equal

SIDES = {
    "jax": (jobj, jconfig, JClient, JService, JEngine),
    "port": (tobj, tconfig, TClient, TService, TEngine),
}
HOST = "kubernetes.io/hostname"


def wait_for(pred, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


@contextlib.contextmanager
def live(side, cfg_name, monkeypatch, nodes=(), pods=(), max_wave=16,
         record_waves=False, assume_ttl_s=None, **cfg_kw):
    """A running engine of ``side`` over a store that already holds
    ``nodes`` and ``pods``: yields (client, scheduler, waves), ``waves``
    the pod names of every wave when ``record_waves``.  The JAX engine
    runs its serial path (``MINISCHED_PIPELINE=0``), which the port
    copies.  ``assume_ttl_s`` shortens the assume-lease TTL from before
    the first wave: at quiesce the last wave's assumptions drain only
    when their leases run out."""
    objs, config, Client, Service, Engine = SIDES[side]
    monkeypatch.setenv("MINISCHED_PIPELINE", "0")
    if assume_ttl_s is not None:
        module, new = ((jds, jds.new_device_scheduler) if side == "jax"
                       else (tservice, tservice.new_device_scheduler))

        def with_ttl(*args, **kw):
            sched = new(*args, **kw)
            sched.assume_ttl_s = assume_ttl_s
            return sched

        monkeypatch.setattr(module, "new_device_scheduler", with_ttl)
    waves = []
    if record_waves:
        orig = Engine.schedule_wave

        def recorded(self, qpis):
            waves.append([q.pod.metadata.name for q in qpis])
            return orig(self, qpis)

        monkeypatch.setattr(Engine, "schedule_wave", recorded)
    client = Client()
    if nodes:
        client.nodes().create_many(list(nodes))
    if pods:
        client.pods().create_many(list(pods))
    svc = Service(client)
    kw = {"device": "cpu"} if side == "port" else {}
    sched = svc.start_scheduler(getattr(config, cfg_name)(**cfg_kw),
                                device_mode=True, max_wave=max_wave, **kw)
    try:
        yield client, sched, waves
    finally:
        svc.close()


def placements(client):
    return {p.metadata.name: p.spec.node_name for p in client.pods().list()}


def settled(client, sched, n_pods):
    """Every pod bound or parked, nothing in flight."""
    st = sched.queue.stats()
    bound = sum(1 for p in client.pods().list() if p.spec.node_name)
    return (st["active"] == 0 and st["backoff"] == 0
            and bound + st["unschedulable"] == n_pods)


def with_uids(pods):
    for i, p in enumerate(pods):
        p.metadata.uid = f"pod-{i:08d}"
    return pods


def overflow_cluster(objs, seed=0, n_nodes=12, n_pods=60):
    """Nodes of 4 CPU (20% cordoned) and more pods than fit."""
    rng = np.random.default_rng(seed)
    nodes = [objs.make_node(f"n{i:03d}", unschedulable=bool(rng.random() < 0.2),
                            capacity={"cpu": "4", "memory": "8Gi", "pods": 110},
                            labels={"zone": f"z{i % 3}", HOST: f"n{i:03d}"})
             for i in range(n_nodes)]
    pods = with_uids([
        objs.make_pod(f"p{i:04d}", requests={
            "cpu": f"{int(rng.choice([500, 1000, 1500]))}m", "memory": "1Gi"})
        for i in range(n_pods)])
    return nodes, pods


def test_readme_scenario_on_both_engines(monkeypatch):
    with ScenarioHarness(tconfig.default_scheduler_config(time_scale=0.01),
                         device="cpu") as h:
        assert readme_scenario(h, log=lambda _: None) == "node10"
        assert h.service.scheduler.loop_errors == 0
    with live("jax", "default_scheduler_config", monkeypatch,
              max_wave=64, time_scale=0.01) as (client, sched, _):
        for i in range(9):
            client.nodes().create(jobj.make_node(f"node{i}",
                                                 unschedulable=True))
        client.pods().create(jobj.make_pod("pod1"))
        assert wait_for(lambda: sched.queue.stats()["unschedulable"] == 1)
        client.nodes().create(jobj.make_node("node10"))
        assert wait_for(
            lambda: client.pods().get("pod1").spec.node_name == "node10")


def _nodenumber_run(side, monkeypatch):
    objs = SIDES[side][0]
    # NodeNumber allows after suffix x time_scale and times out at 10 x
    # time_scale: 0.1 keeps node9's 0.9 s allow 0.1 s clear of its timeout
    with live(side, "default_scheduler_config", monkeypatch,
              time_scale=0.1) as (client, sched, _):
        for i in range(10):
            client.nodes().create(objs.make_node(f"node{i}"))
        client.pods().create_many(
            with_uids([objs.make_pod(f"pp{i:03d}") for i in range(48)]))
        assert wait_for(lambda: sum(
            1 for p in client.pods().list() if p.spec.node_name) == 48)
        return placements(client), getattr(sched, "loop_errors", 0)


def test_nodenumber_waves_place_as_jax(monkeypatch):
    """``default_scheduler_config``, 48 pods in waves of 16 created while
    the engine runs: NodeNumber placements do not depend on the wave
    compositions, and every pod lands on the JAX engine's node."""
    got, errors = _nodenumber_run("port", monkeypatch)
    want, _ = _nodenumber_run("jax", monkeypatch)
    assert got == want and errors == 0
    assert len(set(want.values())) > 1


def _overflow_run(side, monkeypatch):
    objs = SIDES[side][0]
    nodes, pods = overflow_cluster(objs)
    with live(side, "default_full_roster_config", monkeypatch, nodes, pods,
              record_waves=True, assume_ttl_s=0.5,
              time_scale=0.01) as (client, sched, waves):
        assert wait_for(lambda: settled(client, sched, len(pods)))
        if side == "port":
            assert wait_for(lambda: sched.assumed_count() == 0)
            assert sched.loop_errors == 0
        return placements(client), waves, sched.queue.stats()


def test_full_roster_overflow_places_as_jax(monkeypatch):
    """The full roster on a cluster created before the engine starts,
    with more pods than fit: the same waves, then the same node for every
    pod, and the same pods parked."""
    got, got_waves, got_stats = _overflow_run("port", monkeypatch)
    want, want_waves, want_stats = _overflow_run("jax", monkeypatch)
    assert got_waves == want_waves
    assert len(want_waves) >= 4
    assert got == want
    assert got_stats == want_stats
    assert 0 < sum(1 for v in want.values() if v) < len(want)


def _anti_affinity_run(side, monkeypatch):
    """Wave 1 fills three of four nodes; then a pod with a required
    hostname anti-affinity against ``app=web`` is bound to the empty
    node, and a pod labelled ``app=web`` arrives: its wave must keep it
    off that node (the constraint index saw the bind before the wave)."""
    objs = SIDES[side][0]
    nodes = [objs.make_node(f"n{i}", labels={HOST: f"n{i}"},
                            capacity={"cpu": "8", "memory": "16Gi",
                                      "pods": 110}) for i in range(4)]
    fill = with_uids([objs.make_pod(f"f{i}", requests={"cpu": "2"},
                                    node_name=f"n{i % 3}")
                      for i in range(6)])
    guard = objs.make_pod("guard", labels={"app": "db"}, node_name="n3")
    guard.metadata.uid = "pod-guard"
    guard.spec.affinity = objs.Affinity(pod_anti_affinity=objs.PodAntiAffinity(
        required=[objs.PodAffinityTerm(
            label_selector=objs.LabelSelector(match_labels={"app": "web"}),
            topology_key=HOST)]))
    web = objs.make_pod("web", labels={"app": "web"}, requests={"cpu": "1"})
    web.metadata.uid = "pod-web"
    lone = objs.make_pod("lone", requests={"cpu": "1"})
    lone.metadata.uid = "pod-lone"
    with live(side, "default_full_roster_config", monkeypatch, nodes, fill,
              time_scale=0.01) as (client, sched, _):
        client.pods().create(lone)
        assert wait_for(lambda: client.pods().get("lone").spec.node_name)
        client.pods().create(guard)
        client.pods().create(web)
        assert wait_for(lambda: client.pods().get("web").spec.node_name)
        assert getattr(sched, "loop_errors", 0) == 0
        return placements(client)


def test_anti_affinity_bound_between_waves(monkeypatch):
    got = _anti_affinity_run("port", monkeypatch)
    want = _anti_affinity_run("jax", monkeypatch)
    assert got == want
    # the emptiest node would win without the guard's anti-affinity
    assert got["lone"] == "n3" and got["web"] != "n3"


def frozen(built):
    """(table, names) with every column copied to the host now: a JAX
    table on the CPU can alias its builder's scratch buffer, which the
    next build overwrites."""
    import torch

    def copy(col):
        return col.clone() if isinstance(col, torch.Tensor) else np.array(col)

    table, names = built
    return replace(table, **{f.name: copy(getattr(table, f.name))
                             for f in fields(table) if f.name != "use"}), names


def test_node_table_with_assumed_pods_matches_jax_cached_builder():
    """A snapshot with bound pods plus assumed ones (some with host
    ports), taken by each engine: each engine's assume delta through its
    package's ``CachedNodeTableBuilder``, tracked (the cache's drained
    dirty set and epoch) as the wave path builds, gives node tables equal
    column for column; so does a second tracked build after more binds,
    which re-encodes only the rows they dirtied."""
    from minisched_tpu.controlplane.informer import (
        SharedInformerFactory as JFactory,
    )
    from minisched_tpu.engine.device_scheduler import (
        new_device_scheduler as j_new,
    )
    from minisched_tpu_torch.controlplane.informer import (
        SharedInformerFactory as TFactory,
    )
    from minisched_tpu_torch.engine.device_scheduler import (
        new_device_scheduler as t_new,
    )
    from minisched_tpu_torch.models.tables import (
        CachedNodeTableBuilder as TBuilder,
    )

    tables = {}
    for side in ("port", "jax"):
        objs, config, Client, _, _ = SIDES[side]
        nodes, pods = overflow_cluster(objs, seed=3, n_nodes=20, n_pods=80)
        for i, p in enumerate(pods[:40]):
            p.spec.node_name = nodes[(3 * i) % 20].metadata.name
            if i % 5 == 0:
                p.spec.containers[0].ports = [8000 + i]
        for i, p in enumerate(pods[40:60]):
            if i % 4 == 0:
                p.spec.containers[0].ports = [9000 + i]
        client = Client()
        client.nodes().create_many(nodes)
        client.pods().create_many(pods)
        if side == "port":
            factory = TFactory(client.store)
            sched = t_new(client, factory, config.default_full_roster_config(),
                          device="cpu")
            builder = TBuilder("cpu")
        else:
            factory = JFactory(client.store)
            sched = j_new(client, factory, config.default_full_roster_config())
            builder = CachedNodeTableBuilder(device_static=False)
        factory.start()
        try:
            assert factory.wait_for_cache_sync(timeout=30.0)
            assert wait_for(lambda: len(sched.cache.snapshot_with_assigned()[1])
                            == 40)
            for i, p in enumerate(pods[40:60]):
                sched._assume(client.pods().get(p.metadata.name),
                              nodes[(7 * i) % 20].metadata.name)
            infos, delta, leftover, dirty, epoch = sched._snapshot_for_tables()
            assert len(leftover) == 20 and dirty is None
            first = frozen(builder.build(infos, agg_delta=delta, dirty=dirty,
                                         epoch=epoch))
            targets = [nodes[(5 * i + 1) % 20].metadata.name for i in range(6)]
            for p, node in zip(pods[60:66], targets):
                client.pods().bind(objs.Binding(p.metadata.name,
                                                p.metadata.namespace, node))
            assert wait_for(lambda: len(sched.cache.snapshot_with_assigned()[1])
                            == 46)
            infos, delta, leftover, dirty, epoch = sched._snapshot_for_tables()
            assert dirty == set(targets)
            second = frozen(builder.build(infos, agg_delta=delta,
                                          dirty=dirty, epoch=epoch))
            tables[side] = (first, second, builder.last_dirty_rows)
        finally:
            factory.shutdown()
    for k in (0, 1):
        assert tables["port"][k][1] == tables["jax"][k][1]
        assert_tables_equal(tables["port"][k][0], tables["jax"][k][0])
    assert tables["port"][2] == tables["jax"][2] == 4  # distinct targets


def _preemption_run(side, monkeypatch, priority):
    """One 2-CPU node held by a priority-0 pod; a pod of ``priority``
    asking for 1 CPU arrives.  Each engine preempts when the newcomer
    outranks the holder; at the floor the pass ends first."""
    objs = SIDES[side][0]
    node = objs.make_node("n0", capacity={"cpu": "2", "memory": "8Gi",
                                          "pods": 110})
    holder = objs.make_pod("holder", requests={"cpu": "2"}, node_name="n0")
    holder.metadata.uid = "pod-holder"
    high = objs.make_pod("high", requests={"cpu": "1"})
    high.metadata.uid = "pod-high"
    high.spec.priority = priority
    with live(side, "default_full_roster_config", monkeypatch, [node],
              [holder, high]) as (client, sched, _):
        assert wait_for(lambda: sched.queue.stats()["unschedulable"] == 1
                        or client.pods().get("high").spec.node_name
                        or getattr(sched, "loop_errors", 0))
        if priority:
            assert wait_for(lambda: client.pods().get("high").spec.node_name)
        time.sleep(0.3)
        names = {p.metadata.name for p in client.pods().list()}
        high = client.pods().get("high")
        return (names, high.spec.node_name, high.status.nominated_node_name,
                getattr(sched, "loop_errors", 0))


def test_preemption_matches_jax(monkeypatch):
    # above the priority floor both engines evict the holder and bind high
    want = _preemption_run("jax", monkeypatch, priority=10)
    assert want[:2] == ({"high"}, "n0")
    got = _preemption_run("port", monkeypatch, priority=10)
    assert got[:3] == want[:3] and got[3] == 0, (got, want)
    # at the floor (config 5: every pod at priority 0) neither preempts
    want = _preemption_run("jax", monkeypatch, priority=0)
    assert want[:2] == ({"holder", "high"}, "")
    got = _preemption_run("port", monkeypatch, priority=0)
    assert got[:3] == want[:3] and got[3] == 0, (got, want)


def test_failed_evaluation_parks_the_wave_and_counts(monkeypatch):
    """A wave whose device evaluation fails (a kernel that does not
    launch) parks its pods, as the JAX engine does, and the loop counts
    the exception instead of passing over it."""
    def broken(self, pods, nodes, extra=None):
        raise RuntimeError("minisched_select_hosts launch failed")

    monkeypatch.setattr(RepairingEvaluator, "__call__", broken)
    nodes, pods = overflow_cluster(tobj, n_nodes=4, n_pods=6)
    with live("port", "default_full_roster_config", monkeypatch, nodes,
              pods) as (client, sched, _):
        assert wait_for(lambda: sched.loop_errors == 1)
        assert wait_for(lambda: sched.queue.stats()["unschedulable"] == 6)
        assert "launch failed" in str(sched.last_loop_error)
        assert sched.assumed_count() == 0
        assert not any(v for v in placements(client).values())


def test_service_runs_on_the_card_unless_asked_and_restarts(monkeypatch):
    """``device_mode`` defaults to True and ``device=None`` is the card:
    without one, starting raises before a thread starts;
    ``device_mode=False`` starts the scalar engine, which schedules; a
    restarted scheduler keeps its engine and scheduling on the same
    store."""
    import torch

    svc = TService(TClient())
    if torch.cuda.is_available():
        sched = svc.start_scheduler()
        assert sched.device.type == "cuda"
        svc.shutdown_scheduler()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            svc.start_scheduler()
        assert svc.scheduler is None
    svc.close()
    client = TClient()
    client.nodes().create(tobj.make_node("n0"))
    svc = TService(client)
    sched = svc.start_scheduler(tconfig.default_full_roster_config(),
                                device_mode=False)
    assert not isinstance(sched, TEngine)
    client.pods().create(tobj.make_pod("s"))
    assert wait_for(lambda: client.pods().get("s").spec.node_name == "n0")
    sched = svc.restart_scheduler()
    assert not isinstance(sched, TEngine)
    client.pods().create(tobj.make_pod("s2"))
    assert wait_for(lambda: client.pods().get("s2").spec.node_name == "n0")
    assert sched.loop_errors == 0
    svc.close()
    client = TClient()
    client.nodes().create(tobj.make_node("n0"))
    svc = TService(client)
    svc.start_scheduler(tconfig.default_full_roster_config(),
                        device_mode=True, device="cpu")
    client.pods().create(tobj.make_pod("a"))
    assert wait_for(lambda: client.pods().get("a").spec.node_name == "n0")
    with pytest.raises(RuntimeError, match="already running"):
        svc.start_scheduler(device_mode=True, device="cpu")
    sched = svc.restart_scheduler()
    assert sched is svc.scheduler and sched.device.type == "cpu"
    assert [p.name() for p in sched.filter_plugins][:2] == [
        "NodeUnschedulable", "NodeName"]
    client.pods().create(tobj.make_pod("b"))
    assert wait_for(lambda: client.pods().get("b").spec.node_name == "n0")
    assert sched.loop_errors == 0
    svc.close()
    assert svc.scheduler is None and svc.informer_factory is None


def _snapshot_with_assumption(side, monkeypatch):
    objs = SIDES[side][0]
    nodes = [objs.make_node("node1", unschedulable=True), objs.make_node("n2")]
    pods = with_uids([objs.make_pod("pod1", node_selector={"pin": "none"})])
    with live(side, "default_full_roster_config", monkeypatch, nodes, pods,
              time_scale=0.01) as (client, sched, _):
        assert wait_for(lambda: sched.queue.stats()["unschedulable"] == 1)
        before = [(ni.name, len(ni.pods)) for ni in sched.snapshot_nodes()]
        sched._assume(client.pods().get("pod1"), "node1")
        after = [(ni.name, sorted(p.metadata.name for p in ni.pods))
                 for ni in sched.snapshot_nodes()]
        return before, after


def test_snapshot_nodes_folds_assumed_pods_as_jax(monkeypatch):
    """``DeviceScheduler.snapshot_nodes`` folds the surviving assumptions
    into the cloned NodeInfos, as JAX's override does: one node, one
    assumed pod, one pod on it in the snapshot on both engines."""
    got = _snapshot_with_assumption("port", monkeypatch)
    want = _snapshot_with_assumption("jax", monkeypatch)
    assert got == want
    assert want[0] == [("n2", 0), ("node1", 0)]
    assert want[1] == [("n2", []), ("node1", ["pod1"])]
