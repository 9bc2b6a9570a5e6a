"""The port's scalar halves and scalar runners against the JAX package's.

Every plugin of the full and gang rosters has a scalar half (per pod and
node: pre-filter, filter, pre-score, score, normalize) beside its batch
half.  The same clusters are built with each package's objects from one
seed (``feature_cluster``: the node-local features; ``constraint_cluster``:
every cross-pod and volume feature, with its claims and volumes in a
store; ``gang_cluster``: slices and gangs), and each plugin of the port is
driven through its halves exactly as the JAX one is.  Compared, with
tolerance 0 (every result is an int, a name or a status): each status's
code, reasons and plugin; the pre-filter and pre-score results the
plugin keeps in the CycleState; the scores; the normalized scores.

Then the runners: ``schedule_pod_once`` against JAX's, and against the
port's batch ``FusedEvaluator`` on a wave of one pod (as
``tests/test_parity.py`` holds the JAX pair); ``schedule_pods_sequentially``
against JAX's and against the port's exact scan.  Last, the JAX
package's scalar-engine cases (``tests/test_engine.py``'s end-to-end,
bind-precondition and scenario tests) on the port's scalar engine.
"""

from __future__ import annotations

import dataclasses
import random
import time
from types import SimpleNamespace

import pytest
import torch

from minisched_tpu.api import objects as jobj
from minisched_tpu.controlplane.client import Client as JClient
from minisched_tpu.engine import scheduler as jsched
from minisched_tpu.framework import nodeinfo as jnodeinfo
from minisched_tpu.framework import types as jtypes
from minisched_tpu.plugins.registry import build_plugins as jbuild_plugins
from minisched_tpu.service import config as jconfig

from minisched_tpu_torch import fullchain
from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.controlplane.client import Client as TClient
from minisched_tpu_torch.controlplane.informer import SharedInformerFactory
from minisched_tpu_torch.controlplane.store import Conflict
from minisched_tpu_torch.engine import scheduler as tsched
from minisched_tpu_torch.framework import nodeinfo as tnodeinfo
from minisched_tpu_torch.framework import types as ttypes
from minisched_tpu_torch.headline import pods_by_node
from minisched_tpu_torch.models.constraints import build_constraint_tables
from minisched_tpu_torch.models.tables import build_node_table, build_pod_table
from minisched_tpu_torch.ops.fused import FusedEvaluator
from minisched_tpu_torch.plugins.registry import build_plugins
from minisched_tpu_torch.scenario.runner import ScenarioHarness, readme_scenario
from minisched_tpu_torch.service import config as tconfig

from tests.test_torch_constraints import constraint_cluster
from tests.test_torch_gang import gang_cluster
from tests.test_torch_plugins import feature_cluster

SIDES = {
    "jax": SimpleNamespace(objs=jobj, Client=JClient, types=jtypes,
                           infos=jnodeinfo.build_node_infos, sched=jsched,
                           build=jbuild_plugins, config=jconfig),
    "port": SimpleNamespace(objs=tobj, Client=TClient, types=ttypes,
                            infos=tnodeinfo.build_node_infos, sched=tsched,
                            build=build_plugins, config=tconfig),
}
#: the volume-limit plugins, held at 1 volume a node so they reject
LIMITS = ("NodeVolumeLimits", "EBSLimits", "GCEPDLimits", "AzureDiskLimits")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Test files run on parallel workers: this one keeps torch to two
    threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _bound(pod, node_name):
    pod.spec.node_name = node_name
    return pod


def build_cluster(side: str, name: str):
    """(nodes, assigned, pending, pvcs, pvs) of cluster ``name`` with
    ``side``'s objects; every assigned pod has its ``spec.node_name``."""
    objs = SIDES[side].objs
    if name == "feature":
        nodes, by_node, pods = feature_cluster(objs, 3, n_nodes=30,
                                               n_pods=40)
        assigned = [_bound(p, n) for n, ps in by_node.items() for p in ps]
        return nodes, assigned, pods, [], []
    if name == "volume":
        return constraint_cluster(objs, 2, n_nodes=24, n_assigned=40,
                                  n_pods=40, requests={"cpu": "500m"})
    nodes, assigned, pods = gang_cluster(objs, n_gangs=6)
    return nodes, assigned, pods, [], []


def roster(side: str):
    """The gang roster (the full roster plus GangTopology), the volume
    limits at 1, its chains built and the client-reading plugins given a
    store client holding ``pvcs`` and ``pvs`` later (``with_store``)."""
    m = SIDES[side]
    cfg = m.config.gang_roster_config()
    for name in LIMITS:
        cfg.plugin_args[name] = {"max_volumes": 1}
    return cfg, m.build(cfg)


def with_store(side: str, chains, nodes, pvcs, pvs):
    client = SIDES[side].Client()
    for n in nodes:
        client.nodes().create(n)
    for pvc in pvcs:
        client.store.create("PersistentVolumeClaim", pvc)
    for pv in pvs:
        client.store.create("PersistentVolume", pv)
    for p in chains.needs_client:
        p.store_client = client
    return client


def plain(x):
    """A structure of plain values, comparable across the two packages'
    objects: dataclasses as dicts, sets and dicts as sorted item lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return sorted((plain(k), plain(v)) for k, v in x.items())
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def status(st):
    return None if st is None else (int(st.code), list(st.reasons), st.plugin)


def fresh_state(side: str, node_infos):
    state = SIDES[side].types.CycleState()
    for ni in node_infos:
        state.write("nodeinfo/" + ni.name, ni)
    state.write("nodeinfos", node_infos)
    return state


def kept(state):
    """What the plugins wrote into the CycleState (the snapshot aside)."""
    return plain({k: v for k, v in state._storage.items()
                  if not k.startswith("nodeinfo")})


def trace(side: str, pl, pods, node_infos):
    """Every scalar half of ``pl`` on every pod, in the engine's order;
    one record per call."""
    out = []
    for pod in pods:
        state = fresh_state(side, node_infos)
        if hasattr(pl, "pre_filter"):
            out.append(("pre_filter", status(pl.pre_filter(state, pod,
                                                            node_infos)),
                        kept(state)))
        if hasattr(pl, "filter"):
            out.append(("filter", [status(pl.filter(state, pod, ni))
                                   for ni in node_infos]))
        if hasattr(pl, "pre_score"):
            out.append(("pre_score",
                        status(pl.pre_score(state, pod,
                                            [ni.node for ni in node_infos])),
                        kept(state)))
        if hasattr(pl, "score"):
            scored = [pl.score(state, pod, ni.name) for ni in node_infos]
            out.append(("score", [(s, status(st)) for s, st in scored]))
            ext = pl.score_extensions()
            if ext is not None and all(st.is_success() for _, st in scored):
                lst = [SIDES[side].types.NodeScore(ni.name, s)
                       for ni, (s, _) in zip(node_infos, scored)]
                st = ext.normalize_score(state, pod, lst)
                out.append(("normalize", status(st),
                            [ns.score for ns in lst]))
    return out


CLUSTERS = ("feature", "volume", "gang")
PLUGINS = sorted({e.name for point in ("filter", "pre_score", "score")
                  for e in getattr(tconfig.gang_roster_config(),
                                   point).enabled})


@pytest.fixture(scope="module")
def traces():
    """(cluster, plugin) → (JAX trace, port trace)."""
    out = {}
    for cluster in CLUSTERS:
        per_side = {}
        for side in SIDES:
            nodes, assigned, pods, pvcs, pvs = build_cluster(side, cluster)
            _, chains = roster(side)
            client = with_store(side, chains, nodes, pvcs, pvs)
            infos = SIDES[side].infos(
                sorted(nodes, key=lambda n: n.metadata.name), assigned)
            plugins = {p.name(): p for p in
                       chains.filter + chains.pre_score + chains.score}
            per_side[side] = {name: trace(side, plugins[name], pods, infos)
                              for name in PLUGINS}
            del client
        for name in PLUGINS:
            out[cluster, name] = (per_side["jax"][name],
                                  per_side["port"][name])
    return out


def test_rosters_have_every_plugin():
    assert len(PLUGINS) == 18, PLUGINS  # 15 filters, 8 scorers, 5 shared


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("name", PLUGINS)
def test_scalar_halves_match_jax(cluster, name, traces):
    want, got = traces[cluster, name]
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, (k, g[0])


def test_traces_reach_every_verdict(traces):
    """Across the clusters every filter rejects somewhere and every scorer
    gives at least two values, so the equality above is not vacuous."""
    filters = {e.name for e in tconfig.gang_roster_config().filter.enabled}
    for name in PLUGINS:
        rejected, values = False, set()
        for cluster in CLUSTERS:
            for rec in traces[cluster, name][1]:
                if rec[0] == "filter":
                    rejected |= any(st is not None and st[0] != 0
                                    for st in rec[1])
                if rec[0] == "score":
                    values |= {s for s, _ in rec[1]}
        if name in filters:
            assert rejected, name
        else:
            assert len(values) >= 2, name


# ---------------------------------------------------------------------------
# the runners
# ---------------------------------------------------------------------------


def placed_once(side: str, cluster: str):
    """``schedule_pod_once`` for every pending pod of ``cluster`` against
    its assigned pods (stateless): (node name or the FitError's failed
    plugins and per-node statuses)."""
    m = SIDES[side]
    nodes, assigned, pods, pvcs, pvs = build_cluster(side, cluster)
    cfg, chains = roster(side)
    with_store(side, chains, nodes, pvcs, pvs)
    infos = m.infos(sorted(nodes, key=lambda n: n.metadata.name), assigned)
    out = []
    for pod in pods:
        try:
            out.append(m.sched.schedule_pod_once(
                chains.filter, chains.pre_score, chains.score,
                cfg.score_weights(), pod, infos))
        except m.types.FitError as err:
            d = err.diagnosis
            out.append((sorted(d.unschedulable_plugins),
                        {k: status(v) for k, v in d.node_to_status.items()}))
    return out


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_schedule_pod_once_matches_jax(cluster):
    got, want = placed_once("port", cluster), placed_once("jax", cluster)
    assert got == want
    assert any(isinstance(g, str) for g in got)


def _one_pod_waves(nodes, assigned, pods, pvcs, pvs, chains, weights):
    """Each pod alone through the port's ``FusedEvaluator`` on the CPU:
    node names ('' = unschedulable)."""
    nodes = sorted(nodes, key=lambda n: n.metadata.name)
    node_table, names = build_node_table(nodes, pods_by_node(assigned),
                                         device="cpu")
    ev = FusedEvaluator(chains.filter, chains.pre_score, chains.score,
                        weights)
    out = []
    for pod in pods:
        pod_table, _ = build_pod_table([pod], device="cpu")
        extra = build_constraint_tables(
            [pod], nodes, assigned, pod_capacity=pod_table.capacity,
            node_capacity=node_table.capacity, pvcs=pvcs, pvs=pvs,
            device="cpu")
        c = int(ev(pod_table, node_table, extra).choice[0])
        out.append(names[c] if c >= 0 else "")
    return out


@pytest.mark.parametrize("seed", [10, 11])
def test_schedule_pod_once_matches_a_fused_wave_of_one(seed):
    """The full roster on a constraint cluster (resources bind, no int32
    wrap), and the reference chain on cordoned nodes with tolerations."""
    nodes, assigned, pods, pvcs, pvs = constraint_cluster(
        tobj, seed, n_nodes=16, n_assigned=40, n_pods=24,
        requests={"cpu": "1500m"})
    cfg = tconfig.default_full_roster_config()
    chains = build_plugins(cfg)
    with_store("port", chains, nodes, pvcs, pvs)
    infos = tnodeinfo.build_node_infos(
        sorted(nodes, key=lambda n: n.metadata.name), assigned)
    scalar = []
    for pod in pods:
        try:
            scalar.append(tsched.schedule_pod_once(
                chains.filter, chains.pre_score, chains.score,
                cfg.score_weights(), pod, infos))
        except ttypes.FitError:
            scalar.append("")
    batch = _one_pod_waves(nodes, assigned, pods, pvcs, pvs, chains,
                           cfg.score_weights())
    assert scalar == batch
    assert "" in scalar and len({s for s in scalar if s}) > 2

    rng = random.Random(seed)
    nodes = [tobj.make_node(f"n{i}", unschedulable=rng.random() < 0.3)
             for i in range(rng.randrange(5, 40))]
    tol = tobj.Toleration(key="node.kubernetes.io/unschedulable",
                          operator="Exists", effect="NoSchedule")
    pods = [tobj.make_pod(f"pod{i}", tolerations=[tol] if i % 3 else [])
            for i in range(23)]
    chains = build_plugins(tconfig.default_scheduler_config())
    infos = tnodeinfo.build_node_infos(
        sorted(nodes, key=lambda n: n.metadata.name), [])
    scalar = [tsched.schedule_pod_once(chains.filter, chains.pre_score,
                                       chains.score, {}, p, infos)
              for p in pods]
    assert scalar == _one_pod_waves(nodes, [], pods, [], [], chains, {})


@pytest.mark.parametrize("seed", [2024, 7])
def test_schedule_pods_sequentially_matches_jax_and_the_scan(seed):
    """Each placement committed before the next pod: JAX's loop, the
    port's loop and the port's exact scan (``fullchain.schedule_scan`` on
    the CPU) place alike."""
    got = {}
    for side in SIDES:
        m = SIDES[side]
        nodes, assigned, pods, pvcs, pvs = constraint_cluster(
            m.objs, seed, n_nodes=24, n_assigned=40, n_pods=48,
            requests={"cpu": "1"})
        cfg = m.config.default_full_roster_config()
        chains = m.build(cfg)
        with_store(side, chains, nodes, pvcs, pvs)
        infos = m.infos(sorted(nodes, key=lambda n: n.metadata.name),
                        assigned)
        got[side] = m.sched.schedule_pods_sequentially(
            chains.filter, chains.pre_score, chains.score,
            cfg.score_weights(), pods, infos)
    run = fullchain.schedule_scan(nodes, pods, assigned=assigned, pvcs=pvcs,
                                  pvs=pvs, device="cpu")
    scan = [run.node_names[c] if c >= 0 else "" for c in run.choices.tolist()]
    assert got["port"] == got["jax"] == scan
    assert "" in scan and len(set(scan)) > 4


# ---------------------------------------------------------------------------
# the JAX package's scalar-engine cases (tests/test_engine.py:166-320)
# ---------------------------------------------------------------------------


def wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def start_default_stack(time_scale=0.02):
    client = TClient()
    factory = SharedInformerFactory(client.store)
    sched = tsched.new_scheduler(client, factory, time_scale=time_scale)
    factory.start()
    factory.wait_for_cache_sync()
    sched.run()
    return client, sched, factory


def test_pod_binds_to_matching_suffix_node():
    client, sched, factory = start_default_stack()
    try:
        for i in range(1, 4):
            client.nodes().create(tobj.make_node(f"node{i}"))
        client.pods().create(tobj.make_pod("pod2"))
        assert wait_until(
            lambda: client.pods().get("pod2").spec.node_name == "node2")
    finally:
        sched.stop()
        factory.shutdown()
    assert sched.loop_errors == 0


def test_unschedulable_pod_parks_then_event_requeues():
    client, sched, factory = start_default_stack()
    try:
        client.nodes().create(tobj.make_node("node1", unschedulable=True))
        client.pods().create(tobj.make_pod("pod1"))
        assert wait_until(lambda: sched.queue.stats()["unschedulable"] == 1)
        assert client.pods().get("pod1").spec.node_name == ""
        n = client.nodes().get("node1")
        n.spec.unschedulable = False
        client.nodes().update(n)
        assert wait_until(
            lambda: client.pods().get("pod1").spec.node_name == "node1",
            timeout=10.0)
    finally:
        sched.stop()
        factory.shutdown()


def test_permit_delays_binding():
    client, sched, factory = start_default_stack(time_scale=0.2)
    try:
        client.nodes().create(tobj.make_node("node3"))
        client.pods().create(tobj.make_pod("pod3"))
        t0 = time.monotonic()
        assert wait_until(
            lambda: client.pods().get("pod3").spec.node_name == "node3",
            timeout=10.0)
        # NodeNumber delays the bind by nodenum * time_scale = 0.6 s
        assert time.monotonic() - t0 >= 0.5
    finally:
        sched.stop()
        factory.shutdown()


def _bind_stack():
    client = TClient()
    factory = SharedInformerFactory(client.store)
    sched = tsched.new_scheduler(client, factory)  # never run: bind direct
    client.nodes().create(tobj.make_node("node0"))
    return client, sched, factory


def test_conflict_injection_rejects_stale_bind():
    client, sched, _ = _bind_stack()
    client.pods().create(tobj.make_pod("p1"))
    evaluated = client.pods().get("p1")
    client.pods().mutate("p1", lambda p: p)  # a writer bumps the version
    with pytest.raises(Conflict):
        sched.bind(evaluated, "node0")
    assert client.pods().get("p1").spec.node_name == ""
    sched.bind(client.pods().get("p1"), "node0")
    assert client.pods().get("p1").spec.node_name == "node0"


def test_unstamped_pod_still_binds():
    client, sched, _ = _bind_stack()
    client.pods().create(tobj.make_pod("p2"))
    sched.bind(tobj.make_pod("p2"), "node0")  # local object, version 0
    assert client.pods().get("p2").spec.node_name == "node0"


def test_conflict_while_in_flight_refreshes_not_livelocks():
    client, sched, factory = _bind_stack()
    client.pods().create(tobj.make_pod("p3"))
    factory.start()
    assert factory.wait_for_cache_sync()
    try:
        stale = client.pods().get("p3")
        client.pods().mutate("p3", lambda p: p)
        assert wait_until(
            lambda: factory.informer_for("Pod").get("default/p3")
            .metadata.resource_version > stale.metadata.resource_version)
        qpi = ttypes.QueuedPodInfo(ttypes.PodInfo(stale))
        sched._binding_cycle(qpi, stale, "node0")  # Conflict inside
        assert client.pods().get("p3").spec.node_name == ""
        assert (qpi.pod.metadata.resource_version
                > stale.metadata.resource_version)
        sched._binding_cycle(qpi, qpi.pod, "node0")
        assert client.pods().get("p3").spec.node_name == "node0"
    finally:
        factory.shutdown()


def test_peer_bound_pod_is_dropped_not_requeued():
    client, sched, factory = _bind_stack()
    client.nodes().create(tobj.make_node("node1"))
    client.pods().create(tobj.make_pod("p4"))
    factory.start()
    assert factory.wait_for_cache_sync()
    try:
        ours = client.pods().get("p4")
        sched.bind(client.pods().get("p4"), "node1")  # the peer wins
        assert wait_until(
            lambda: (factory.informer_for("Pod").get("default/p4")
                     or ours).spec.node_name == "node1")
        qpi = ttypes.QueuedPodInfo(ttypes.PodInfo(ours))
        sched._binding_cycle(qpi, ours, "node0")  # AlreadyBound inside
        assert sched.queue.stats()["unschedulable"] == 0
        assert client.pods().get("p4").spec.node_name == "node1"
    finally:
        factory.shutdown()


def test_readme_scenario_on_the_scalar_engine():
    with ScenarioHarness(tconfig.default_scheduler_config(time_scale=0.05),
                         device_mode=False) as h:
        assert readme_scenario(h, log=lambda *_: None) == "node10"
        assert h.service.scheduler.loop_errors == 0
