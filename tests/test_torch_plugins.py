"""The port's node-local batch plugins and roster config against the JAX
package's.

Seeded clusters carry every feature the plugins read: taints of every
effect and tolerations of every form, node selectors, required node
affinity with every operator (and an empty term list), weighted preferred
terms, multi-container images, duplicate host ports, pinned and unpinned
pods, over-committed nodes, zero-request pods, and nodes large enough
that the int32 resource math wraps.  The same tables go to both packages
(JAX tables, carried to the port with ``tables_from_numpy``), and every
``batch_filter``, ``batch_score`` and ``batch_normalize`` must agree
exactly: the outputs are integers and bools, so the tolerance is 0.
"""

from __future__ import annotations

import random
from dataclasses import replace

import numpy as np
import pytest
import torch

from minisched_tpu.api import objects as jobj
from minisched_tpu.models import tables as jtables
from minisched_tpu.ops.fused import BatchContext as JBatchContext
from minisched_tpu.plugins import registry as jregistry
from minisched_tpu.plugins.imagelocality import ImageLocality as JImageLocality
from minisched_tpu.plugins.nodeaffinity import NodeAffinity as JNodeAffinity
from minisched_tpu.plugins.nodename import NodeName as JNodeName
from minisched_tpu.plugins.nodeports import NodePorts as JNodePorts
from minisched_tpu.plugins.noderesources import (
    NodeResourcesBalancedAllocation as JBalanced,
    NodeResourcesFit as JFit,
    NodeResourcesLeastAllocated as JLeast,
)
from minisched_tpu.plugins.tainttoleration import TaintToleration as JTaint
from minisched_tpu.service import config as jconfig

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.models import tables as ttables
from minisched_tpu_torch.ops import fused as tfused
from minisched_tpu_torch.plugins import registry as tregistry
from minisched_tpu_torch.plugins.imagelocality import ImageLocality
from minisched_tpu_torch.plugins.nodeaffinity import NodeAffinity
from minisched_tpu_torch.plugins.nodename import NodeName
from minisched_tpu_torch.plugins.nodeports import NodePorts
from minisched_tpu_torch.plugins.noderesources import (
    NodeResourcesBalancedAllocation,
    NodeResourcesFit,
    NodeResourcesLeastAllocated,
)
from minisched_tpu_torch.plugins.tainttoleration import TaintToleration
from minisched_tpu_torch.service import config as tconfig

from tests.test_torch_tables import assert_tables_equal, jax_columns

EFFECTS = ["NoSchedule", "PreferNoSchedule", "NoExecute"]
IMAGES = ["nginx", "envoy", "redis", "busybox", "pause"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs test files on parallel workers: this file's torch
    work keeps to two threads so it does not crowd the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _requirement(objs, rng: random.Random):
    op = rng.choice(["In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"])
    if op in ("In", "NotIn"):
        key = rng.choice(["zone", "pool", "disk"])
        values = rng.sample(["z0", "z1", "z2", "gpu", "cpu", "ssd"],
                            rng.randrange(1, 4))
    elif op in ("Gt", "Lt"):
        key = rng.choice(["rank", "zone"])  # zone: never numeric
        values = [rng.choice(["3", "10", "-2", "x"])]
    else:
        key, values = rng.choice(["zone", "pool", "disk", "rank"]), []
    return objs.LabelSelectorRequirement(key, op, values)


def _term(objs, rng: random.Random):
    return objs.NodeSelectorTerm(
        [_requirement(objs, rng) for _ in range(rng.randrange(1, 4))])


def feature_cluster(objs, seed: int, n_nodes: int = 60, n_pods: int = 150,
                    cpu_request: str = ""):
    """(nodes, assigned pods by node name, pending pods), built with the
    ``objs`` module (JAX or port objects) from one seed.  ``cpu_request``
    gives every pending pod that CPU request (for contention); otherwise
    requests are random and a fifth of the pods ask for nothing."""
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        labels = {}
        if rng.random() < 0.7:
            labels["zone"] = f"z{rng.randrange(3)}"
        if rng.random() < 0.5:
            labels["rank"] = str(rng.randrange(-5, 20))
        if rng.random() < 0.3:
            labels["pool"] = rng.choice(["gpu", "cpu"])
        if rng.random() < 0.2:
            labels["disk"] = "ssd"
        taints = [objs.Taint(key=rng.choice(["dedicated", "spot", "gpu"]),
                             value=rng.choice(["", "a", "b"]),
                             effect=rng.choice(EFFECTS))
                  for _ in range(rng.choice([0, 0, 1, 2]))]
        taints = list({(t.key, t.effect): t for t in taints}.values())
        capacity = {"cpu": rng.choice(["2", "4", "8"]),
                    "memory": rng.choice(["4Gi", "16Gi"]),
                    "pods": rng.choice([3, 10, 110]),
                    "ephemeral-storage": rng.choice(["0", "10Gi"])}
        if i == 0:
            capacity = {"cpu": "64", "memory": "128Gi", "pods": 110}
        elif i == 1:  # (a - requested) * 100 wraps in int32
            capacity = {"cpu": "30000", "memory": "32Ti", "pods": 110}
        elif i == 2:  # min(requested, 2a) * FRAC_SCALE wraps in int32
            capacity = {"cpu": "8", "memory": "1536Gi", "pods": 110}
        node = objs.make_node(f"n{i:03d}", unschedulable=rng.random() < 0.15,
                              labels=labels, capacity=capacity, taints=taints)
        if rng.random() < 0.5:
            node.status.images = {
                img: rng.randrange(1, 1500) * 1024 * 1024
                for img in rng.sample(IMAGES, rng.randrange(1, 4))}
        nodes.append(node)

    assigned = {}
    for node in nodes:
        held = []
        for k in range(rng.choice([0, 0, 1, 2])):
            pod = objs.make_pod(f"old-{node.metadata.name}-{k}",
                                requests={"cpu": f"{rng.randrange(100, 3000)}m",
                                          "memory": f"{rng.randrange(64, 6000)}Mi"})
            if rng.random() < 0.4:
                pod.spec.containers[0].ports = rng.sample([80, 443, 8080, 9090], 2)
            held.append(pod)
        if node.metadata.name == "n002":  # over-committed past 2 TiB
            held.append(objs.make_pod("old-huge",
                                      requests={"cpu": "1", "memory": "2100Gi"}))
        if held:
            assigned[node.metadata.name] = held

    pods = []
    for i in range(n_pods):
        kw = {}
        if rng.random() < 0.4:
            kw["tolerations"] = [
                objs.Toleration(
                    key=rng.choice(["dedicated", "spot", "gpu", ""]),
                    operator=rng.choice(["Exists", "Equal"]),
                    value=rng.choice(["", "a", "b"]),
                    effect=rng.choice(["", *EFFECTS]))
                for _ in range(rng.randrange(1, 4))]
        if rng.random() < 0.3:
            kw["node_selector"] = {"zone": f"z{rng.randrange(3)}"}
            if rng.random() < 0.3:
                kw["node_selector"]["pool"] = rng.choice(["gpu", "cpu"])
        if rng.random() < 0.4:
            required = None
            roll = rng.random()
            if roll < 0.15:
                required = []  # an empty term list matches nothing
            elif roll < 0.6:
                required = [_term(objs, rng) for _ in range(rng.randrange(1, 3))]
            preferred = [objs.PreferredSchedulingTerm(rng.randrange(1, 100),
                                                      _term(objs, rng))
                         for _ in range(rng.randrange(0, 3))]
            kw["affinity"] = objs.Affinity(node_affinity=objs.NodeAffinity(
                required_terms=required, preferred=preferred))
        if rng.random() < 0.1:
            kw["node_name"] = f"n{rng.randrange(n_nodes):03d}"
        if cpu_request:
            requests = {"cpu": cpu_request, "memory": "256Mi"}
        elif rng.random() < 0.2:
            requests = None  # zero-request pod
        else:
            requests = {"cpu": f"{rng.randrange(1, 2000)}m",
                        "memory": f"{rng.randrange(1, 3000)}Mi"}
            if rng.random() < 0.3:
                requests["ephemeral-storage"] = f"{rng.randrange(1, 4)}Gi"
        pod = objs.make_pod(f"p{i:03d}", requests=requests, **kw)
        if rng.random() < 0.5:
            pod.spec.containers[0].image = rng.choice(IMAGES)
        if rng.random() < 0.3:
            pod.spec.containers[0].ports = [rng.choice([80, 443, 8080, 9090])]
        if rng.random() < 0.3:
            # a second container: another image, maybe the same host port
            side_ports = ([rng.choice([80, 443, 8080, 9090])]
                          if rng.random() < 0.5 else [])
            pod.spec.containers.append(objs.Container(
                name="side", image=rng.choice(IMAGES + [""]),
                requests=objs.ResourceList.parse({"cpu": "10m"}),
                ports=side_ports))
        pods.append(pod)
    return nodes, assigned, pods


def jax_tables(seed: int, **kw):
    nodes, assigned, pods = feature_cluster(jobj, seed, **kw)
    jn, _ = jtables.build_node_table(nodes, assigned)
    jp, _ = jtables.build_pod_table(pods)
    return jn, jp


def port_tables(jn, jp):
    return ttables.tables_from_numpy(jax_columns(jn), jax_columns(jp), "cpu")


SEEDS = [3, 11]

FILTERS = [(JNodeName, NodeName), (JTaint, TaintToleration),
           (JNodeAffinity, NodeAffinity), (JNodePorts, NodePorts),
           (JFit, NodeResourcesFit)]
SCORERS = [(JBalanced, NodeResourcesBalancedAllocation),
           (JImageLocality, ImageLocality), (JFit, NodeResourcesFit),
           (JLeast, NodeResourcesLeastAllocated), (JNodeAffinity, NodeAffinity),
           (JTaint, TaintToleration)]


def _ids(pairs):
    return [t.__name__ for _, t in pairs]


@pytest.fixture(scope="module")
def clusters():
    return {seed: jax_tables(seed) for seed in SEEDS}


def test_feature_cluster_reaches_every_feature(clusters):
    """The clusters really carry what the plugin tests claim to cover."""
    jn, jp = clusters[SEEDS[0]]
    num_ports = np.asarray(jp.num_ports)
    ports = np.asarray(jp.port)
    assert set(np.asarray(jn.prof_taint_effect).ravel()) >= {1, 2, 3}
    assert np.asarray(jp.num_tols).max() >= 2
    assert set(np.asarray(jp.tol_effect).ravel()) >= {0, 1, 2, 3}
    assert (np.asarray(jp.num_sel) > 0).any()
    assert set(np.asarray(jp.aff_op).ravel()) >= set(range(6))
    required = np.asarray(jp.aff_required)
    assert (required & (np.asarray(jp.aff_nterms) == 0)).any()  # empty list
    assert (np.asarray(jp.pref_weight) > 1).any()
    assert (np.asarray(jp.num_containers) > 1).any()
    assert any(len(set(ports[i, :n])) < n for i, n in enumerate(num_ports))
    assert (np.asarray(jp.spec_node_name) != 0).any()
    assert (np.asarray(jp.spec_node_name) == 0).any()
    assert ((np.asarray(jp.req_cpu) == 0) & np.asarray(jp.valid)).any()
    req, alloc = np.asarray(jn.req_mem), np.asarray(jn.alloc_mem)
    assert (req > alloc).any()  # over-committed
    assert alloc[0] == 128 * 1024 and alloc[1] > (1 << 31) // 100
    assert int(req[2]) * 1000 > (1 << 31)  # BalancedAllocation's product wraps
    assert (np.asarray(jn.num_images) > 1).any()


@pytest.mark.parametrize("objs_name", ["port", "jax"])
def test_port_objects_build_the_jax_tables(objs_name):
    """The port's own object model (node affinity included) encodes the
    same tables as the JAX package's objects."""
    objs = tobj if objs_name == "port" else jobj
    nodes, assigned, pods = feature_cluster(objs, SEEDS[0])
    jn, jp = jax_tables(SEEDS[0])
    tn, _ = ttables.build_node_table(nodes, assigned, device="cpu")
    tp, _ = ttables.build_pod_table(pods, device="cpu")
    assert_tables_equal(tn, jn)
    assert_tables_equal(tp, jp)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("jcls,tcls", FILTERS, ids=_ids(FILTERS))
def test_batch_filter_matches_jax(jcls, tcls, seed, clusters):
    jn, jp = clusters[seed]
    tn, tp = port_tables(jn, jp)
    want = _np(jcls().batch_filter(JBatchContext(), jp, jn))
    got = tcls().batch_filter(tfused.BatchContext(), tp, tn)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(np.broadcast_to(_np(got), want.shape), want)
    assert want.any() and not want.all()


def _masks(jn, jp, seed: int):
    """Normalize masks: the node-local filter conjunction, a random mask,
    and one with empty rows."""
    ctx = JBatchContext()
    mask = np.asarray(jp.valid)[:, None] & np.asarray(jn.valid)[None, :]
    for jcls, _ in FILTERS:
        mask = mask & np.asarray(jcls().batch_filter(ctx, jp, jn))
    rng = np.random.default_rng(seed)
    rand = rng.random(mask.shape) < 0.5
    rand[::3] = False
    return [mask, rand]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("jcls,tcls", SCORERS, ids=_ids(SCORERS))
def test_batch_score_and_normalize_match_jax(jcls, tcls, seed, clusters):
    jn, jp = clusters[seed]
    tn, tp = port_tables(jn, jp)
    jpl, tpl = jcls(), tcls()
    jctx, tctx = JBatchContext(), tfused.BatchContext()
    jaux = jpl.batch_pre_score(jctx, jp, jn) if hasattr(jpl, "batch_pre_score") else {}
    want = np.asarray(jpl.batch_score(jctx, jp, jn, jaux))
    got = tpl.batch_score(tctx, tp, tn, tpl.batch_pre_score(tctx, tp, tn))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for mask in _masks(jn, jp, seed):
        jnorm = np.asarray(jpl.batch_normalize(jctx, want, mask))
        tnorm = tpl.batch_normalize(tctx, got, torch.from_numpy(mask))
        np.testing.assert_array_equal(_np(tnorm), jnorm)


def test_scores_reach_their_interesting_values(clusters):
    """ImageLocality, NodeAffinity and TaintToleration score above zero
    somewhere, and on the node past 2 TiB BalancedAllocation's wrapped
    product gives negative scores (as the JAX package's does: the parity
    tests above hold both to each other)."""
    jn, jp = clusters[SEEDS[0]]
    tn, tp = port_tables(jn, jp)
    ctx = tfused.BatchContext()
    for pl in (ImageLocality(), NodeAffinity(), TaintToleration()):
        assert (pl.batch_score(ctx, tp, tn, {}) > 0).any(), pl.name()
    balanced = NodeResourcesBalancedAllocation().batch_score(ctx, tp, tn, {})
    assert (balanced[:, 2] < 0).all()
    least = NodeResourcesLeastAllocated().batch_score(ctx, tp, tn, {})
    assert (least[:, 1] != least[:, 1].clamp(0, 100)).any()  # wrapped


def _use(**kw):
    return replace(ttables.PodUse(tol_slots=0, sel_slots=0,
                                  aff_required=False, pref_terms=False,
                                  gangs=False), **kw)


WAVE_USES = {
    "plain": _use(),
    "tolerations": _use(tol_slots=2),
    "selector": _use(sel_slots=2),
    "required": _use(aff_required=True),
    "preferred": _use(pref_terms=True),
}


def _profile_wave(objs, kind: str):
    """Tainted nodes that each carry their own ``kubernetes.io/hostname``
    (one label set per node), and a wave whose odd pods use one kind of
    toleration or node affinity."""
    taints = [[objs.Taint(key="dedicated", value="a", effect="NoSchedule")],
              [objs.Taint(key="spot", value="", effect="PreferNoSchedule")],
              [], []]
    nodes = [objs.make_node(f"n{i:03d}", taints=taints[i % 4], labels={
        "kubernetes.io/hostname": f"n{i:03d}", "zone": f"z{i % 3}"})
        for i in range(40)]
    term = objs.NodeSelectorTerm(
        [objs.LabelSelectorRequirement("zone", "In", ["z0", "z2"])])
    pods = []
    for i in range(20):
        kw = {}
        if i % 2 and kind == "tolerations":
            kw["tolerations"] = [
                objs.Toleration(key="dedicated", operator="Equal", value="a",
                                effect="NoSchedule"),
                objs.Toleration(key="spot", operator="Exists", value="",
                                effect="")]
        elif i % 2 and kind == "selector":
            kw["node_selector"] = {"zone": "z1", "kubernetes.io/hostname":
                                   f"n{i:03d}"}
        elif i % 2 and kind == "required":
            kw["affinity"] = objs.Affinity(node_affinity=objs.NodeAffinity(
                required_terms=[term], preferred=[]))
        elif i % 2 and kind == "preferred":
            kw["affinity"] = objs.Affinity(node_affinity=objs.NodeAffinity(
                required_terms=None,
                preferred=[objs.PreferredSchedulingTerm(7, term)]))
        pods.append(objs.make_pod(f"p{i:03d}", **kw))
    return nodes, pods


@pytest.mark.parametrize("kind", list(WAVE_USES))
def test_profile_plugins_skip_what_no_pod_of_the_wave_uses(kind):
    """``PodTable.use``, read on the host, says which toleration slots,
    selector slots and term lookups a wave uses; TaintToleration and
    NodeAffinity skip the rest (the JAX NodeAffinity skips the same with
    ``lax.cond``).  Filters and scores equal JAX's and the full
    computation (a table with the default ``use``)."""
    want_use = WAVE_USES[kind]
    t_nodes, t_pods = _profile_wave(tobj, kind)
    assert ttables.build_pod_table(t_pods, device="cpu")[0].use == want_use
    nodes, pods = _profile_wave(jobj, kind)
    jn, _ = jtables.build_node_table(nodes)
    jp, _ = jtables.build_pod_table(pods)
    tn, tp = port_tables(jn, jp)
    assert tp.use == want_use
    assert int(np.asarray(jn.prof_num_labels).astype(bool).sum()) == 40
    full = replace(tp, use=ttables.PodUse())
    jctx, tctx = JBatchContext(), tfused.BatchContext()
    for jpl, tpl in ((JNodeAffinity(), NodeAffinity()),
                     (JTaint(), TaintToleration())):
        want = np.asarray(jpl.batch_filter(jctx, jp, jn))
        want_score = np.asarray(jpl.batch_score(jctx, jp, jn, {}))
        for table in (tp, full):
            got = tpl.batch_filter(tctx, table, tn)
            np.testing.assert_array_equal(
                np.broadcast_to(got.numpy(), want.shape), want)
            got = tpl.batch_score(tctx, table, tn, {})
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want_score)


def test_roster_configs_match_jax():
    def listing(cfg):
        return {point: [(e.name, e.weight) for e in ps.enabled]
                for point, ps in cfg.extension_points().items()}

    assert listing(tconfig.default_full_roster_config()) == listing(
        jconfig.default_full_roster_config())
    assert listing(tconfig.default_scheduler_config()) == listing(
        jconfig.default_scheduler_config())
    custom = dict(
        filter=dict(disabled=list(tconfig.CONSTRAINT_FILTERS)),
        pre_score=dict(disabled=list(tconfig.CONSTRAINT_SCORERS)),
        score=dict(disabled=["*"], enabled=[("ImageLocality", 3),
                                            ("NodeNumber", 2)]),
    )

    def merged(mod):
        sets = {p: mod.PluginSet(
            disabled=list(v.get("disabled", [])),
            enabled=[mod.PluginEnabled(n, w) for n, w in v.get("enabled", [])])
            for p, v in custom.items()}
        return mod.apply_plugin_customization(
            mod.default_full_roster_config(),
            mod.SchedulerConfig(plugin_args={"X": {"a": 1}}, **sets))

    assert listing(merged(tconfig)) == listing(merged(jconfig))
    assert merged(tconfig).plugin_args == merged(jconfig).plugin_args
    node_local = tconfig.node_local_roster_config()
    want = jconfig.apply_plugin_customization(
        jconfig.default_full_roster_config(), jconfig.SchedulerConfig(
            filter=jconfig.PluginSet(disabled=list(tconfig.CONSTRAINT_FILTERS)),
            pre_score=jconfig.PluginSet(disabled=list(tconfig.CONSTRAINT_SCORERS)),
            score=jconfig.PluginSet(disabled=list(tconfig.CONSTRAINT_SCORERS))))
    assert listing(node_local) == listing(want)
    assert [e.name for e in node_local.filter.enabled] == [
        "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity",
        "NodePorts", "NodeResourcesFit"]
    assert node_local.score_weights() == want.score_weights()


def test_build_plugins_matches_jax_chains():
    cfg = tconfig.node_local_roster_config()
    chains = tregistry.build_plugins(cfg)
    jcfg = jconfig.default_full_roster_config()
    jcfg.filter.enabled = [e for e in jcfg.filter.enabled
                           if e.name not in tconfig.CONSTRAINT_FILTERS]
    for point in ("pre_score", "score"):
        ps = getattr(jcfg, point)
        ps.enabled = [e for e in ps.enabled
                      if e.name not in tconfig.CONSTRAINT_SCORERS]
    jchains = jregistry.build_plugins(jcfg)
    for point in ("filter", "pre_score", "score"):
        assert ([p.name() for p in getattr(chains, point)]
                == [p.name() for p in getattr(jchains, point)]), point
    # one instance per name across points
    fit = [p for p in chains.filter if p.name() == "NodeResourcesFit"]
    assert any(p is fit[0] for p in chains.score)
    assert [p.name() for p in chains.post_filter] == ["DefaultPreemption"]
    assert chains.reserve == chains.permit == []


def test_build_plugins_builds_the_full_roster_as_jax():
    """The full default roster: 15 filters, 3 pre-scores and 7 scores in
    the JAX order, one instance per name, the same weights and the same
    plugin arguments (``max_volumes``)."""
    cfg = tconfig.default_full_roster_config()
    cfg.plugin_args["EBSLimits"] = {"max_volumes": 7}
    jcfg = jconfig.default_full_roster_config()
    jcfg.plugin_args["EBSLimits"] = {"max_volumes": 7}
    chains = tregistry.build_plugins(cfg)
    jchains = jregistry.build_plugins(jcfg)
    for point in ("filter", "pre_score", "score"):
        assert ([p.name() for p in getattr(chains, point)]
                == [p.name() for p in getattr(jchains, point)]), point
    assert (len(chains.filter), len(chains.pre_score), len(chains.score)) == (15, 3, 7)
    assert cfg.score_weights() == jcfg.score_weights()
    assert cfg.score_weights()["PodTopologySpread"] == 2
    for got, want in zip(chains.filter, jchains.filter):
        assert getattr(got, "max_volumes", None) == getattr(want, "max_volumes", None)
    ipa = [p for p in chains.filter if p.name() == "InterPodAffinity"]
    assert any(p is ipa[0] for p in chains.score)
    assert any(p is ipa[0] for p in chains.pre_score)
    assert [p.name() for p in chains.post_filter] == ["DefaultPreemption"]
    assert chains.reserve == chains.permit == []


def test_gang_roster_builds_the_jax_chains():
    """``gang_roster_config`` gives the JAX roster's device chains (the
    full roster plus GangTopology at pre-score and score), weights, and
    and its host-side points (Coscheduling at Permit)."""
    cfg, jcfg = tconfig.gang_roster_config(), jconfig.gang_roster_config()
    chains = tregistry.build_plugins(cfg)
    jchains = jregistry.build_plugins(jcfg)
    for point in ("filter", "pre_score", "score"):
        assert ([p.name() for p in getattr(chains, point)]
                == [p.name() for p in getattr(jchains, point)]), point
    assert (len(chains.filter), len(chains.pre_score), len(chains.score)) == (15, 4, 8)
    assert cfg.score_weights() == jcfg.score_weights()
    assert cfg.score_weights()["GangTopology"] == 1
    gang = [p for p in chains.score if p.name() == "GangTopology"]
    assert any(p is gang[0] for p in chains.pre_score)
    for point in ("post_filter", "reserve", "permit"):
        assert ([p.name() for p in getattr(chains, point)]
                == [p.name() for p in getattr(jchains, point)]), point
    assert [p.name() for p in chains.permit] == ["Coscheduling"]
    for attr in ("needs_handle", "needs_client"):
        assert ([p.name() for p in getattr(chains, attr)]
                == [p.name() for p in getattr(jchains, attr)]), attr
    assert chains.permit[0] in chains.needs_handle
    assert chains.post_filter[0] in chains.needs_handle


def test_build_plugins_refuses_the_full_roster_and_unknown_names():
    cfg = tconfig.node_local_roster_config()
    cfg.filter.enabled.append(tconfig.PluginEnabled("NoSuchPlugin"))
    with pytest.raises(KeyError, match="unknown plugin"):
        tregistry.build_plugins(cfg)
    cfg = tconfig.node_local_roster_config()
    cfg.filter.enabled.append(tconfig.PluginEnabled("ImageLocality"))
    with pytest.raises(TypeError, match="does not implement filter"):
        tregistry.build_plugins(cfg)


@pytest.mark.parametrize("shape", [(3, 5, 8), (1, 8), (2, 3, 4, 8)])
def test_any_last_axis_equals_any(shape):
    from minisched_tpu_torch.utils.reduce import any_last_axis

    rng = np.random.default_rng(len(shape) * 10 + shape[0])
    x = torch.from_numpy(rng.random(shape) < 0.15)
    x[..., 0, :] = False  # rows with no true slot
    assert torch.equal(any_last_axis(x), x.any(dim=-1))


@pytest.mark.parametrize("layout", ["width7", "width16", "shifted", "strided",
                                    "int8"])
def test_any_last_axis_refuses_other_layouts(layout):
    from minisched_tpu_torch.utils.reduce import any_last_axis

    x = torch.from_numpy(np.random.default_rng(3).random((4, 5, 8)) < 0.2)
    bad = {
        "width7": lambda: x[..., :7].contiguous(),
        "width16": lambda: x.reshape(2, 5, 16),
        "shifted": lambda: torch.zeros(x.numel() + 1, dtype=torch.bool)[1:]
        .view(x.shape),
        "strided": lambda: x.transpose(-1, -2).contiguous().transpose(-1, -2),
        "int8": lambda: x.to(torch.int8),
    }[layout]()
    with pytest.raises(ValueError, match="any_last_axis needs"):
        any_last_axis(bad)
