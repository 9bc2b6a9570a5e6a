"""The port's cross-pod plugins (InterPodAffinity, PodTopologySpread) and
``minmax_normalize_batch`` against the JAX package's.

The clusters are those of ``tests/test_cross_pod.py``
(``_random_cross_pod_cluster``: zone keys, assigned pods with every term
kind) at several seeds, the richer ``constraint_cluster`` of
``tests/test_torch_constraints.py`` (hostname-like keys, nodes without
the key, node selectors that make nodes ineligible for spread), and one
cluster whose largest zone holds more than 4,096 matching pods.  The same
tables go to both packages (JAX tables, carried to the port with
``tables_from_numpy`` and ``constraint_tables_from_numpy``); every
``batch_filter``, ``batch_score`` and ``batch_normalize`` must agree
exactly, and the port of ``test_parity_config4_randomized`` must place
as the scalar oracle does.  Tolerance 0: integers and bools.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest
import torch

from minisched_tpu.api import objects as jobj
from minisched_tpu.models import constraints as jconstraints
from minisched_tpu.models import tables as jtables
from minisched_tpu.ops.fused import BatchContext as JBatchContext
from minisched_tpu.plugins.interpodaffinity import InterPodAffinity as JIPA
from minisched_tpu.plugins.normalize import minmax_normalize_batch as jnormalize
from minisched_tpu.plugins.nodeunschedulable import (
    NodeUnschedulable as JNodeUnschedulable,
)
from minisched_tpu.plugins.podtopologyspread import PodTopologySpread as JPTS

from minisched_tpu_torch.headline import pods_by_node as by_node
from minisched_tpu_torch.models import constraints as tconstraints
from minisched_tpu_torch.models import tables as ttables
from minisched_tpu_torch.ops import fused as tfused
from minisched_tpu_torch.plugins.interpodaffinity import InterPodAffinity
from minisched_tpu_torch.plugins.nodeunschedulable import NodeUnschedulable
from minisched_tpu_torch.plugins.normalize import minmax_normalize_batch
from minisched_tpu_torch.plugins.podtopologyspread import PodTopologySpread

from tests.test_cross_pod import _random_cross_pod_cluster
from tests.test_parity import oracle_placements
from tests.test_torch_constraints import ZONE_KEY, constraint_cluster
from tests.test_torch_plugins import port_tables


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs test files on parallel workers: this file's torch
    work keeps to two threads so it does not crowd the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_columns(table) -> dict:
    return {f.name: np.asarray(getattr(table, f.name))
            for f in dataclasses.fields(table)}


def both_waves(nodes, assigned, pods, pvcs=(), pvs=(), scan_planes=True):
    """((JAX node, pod, constraint tables), (the port's copies on the
    CPU)) of one wave, nodes in name order."""
    nodes = sorted(nodes, key=lambda n: n.metadata.name)
    jn, _ = jtables.build_node_table(nodes, by_node(assigned))
    jp, _ = jtables.build_pod_table(pods)
    je = jconstraints.build_constraint_tables(
        pods, nodes, assigned, pod_capacity=jp.capacity,
        node_capacity=jn.capacity, pvcs=pvcs, pvs=pvs, scan_planes=scan_planes)
    tn, tp = port_tables(jn, jp)
    te = tconstraints.constraint_tables_from_numpy(jax_columns(je), "cpu")
    return (jn, jp, je), (tn, tp, te)


def big_domain_cluster():
    """Zone z0 holds 4,200 pods of app=web (beyond what TF32 keeps
    exact), the other zones a few; the pending pods spread over zones
    with DoNotSchedule and ScheduleAnyway, some ineligible on half the
    nodes."""
    rng = random.Random(5)
    nodes = [jobj.make_node(f"n{i:03d}", labels={
        ZONE_KEY: f"z{i % 4}", "disk": "ssd" if i % 3 else "hdd"})
        for i in range(64)]
    assigned = []
    for i in range(4300):
        node = nodes[4 * rng.randrange(16)] if i < 4200 else rng.choice(nodes)
        p = jobj.make_pod(f"old{i}", labels={"app": "web"})
        p.spec.node_name = node.metadata.name
        assigned.append(p)
    pods = []
    for i in range(40):
        pod = jobj.make_pod(f"p{i}", labels={"app": "web"})
        if i % 2:
            pod.spec.node_selector = {"disk": "ssd"}
        pod.spec.topology_spread_constraints = [jobj.TopologySpreadConstraint(
            max_skew=rng.choice([1, 4100, 4300]), topology_key=ZONE_KEY,
            when_unsatisfiable=rng.choice(["DoNotSchedule", "ScheduleAnyway"]),
            label_selector=jobj.LabelSelector(match_labels={"app": "web"}))]
        pods.append(pod)
    return nodes, assigned, pods


def _cluster(name: str):
    kind, seed = name.rsplit("-", 1)
    if kind == "crosspod":
        return _random_cross_pod_cluster(random.Random(int(seed)), 24, 30, 40)
    if kind == "features":
        nodes, assigned, pods, _, _ = constraint_cluster(jobj, int(seed))
        return nodes, assigned, pods
    return big_domain_cluster()


CLUSTERS = ["crosspod-44", "crosspod-3", "crosspod-9", "features-1",
            "features-7", "bigdomain-0"]


@pytest.fixture(scope="module")
def waves():
    return {name: both_waves(*_cluster(name)) for name in CLUSTERS}


PLUGINS = [(JIPA, InterPodAffinity), (JPTS, PodTopologySpread)]
IDS = ["InterPodAffinity", "PodTopologySpread"]


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("jcls,tcls", PLUGINS, ids=IDS)
def test_crosspod_filter_matches_jax(jcls, tcls, cluster, waves):
    (jn, jp, je), (tn, tp, te) = waves[cluster]
    want = np.asarray(jcls().batch_filter(JBatchContext(), jp, jn, je))
    got = tcls().batch_filter(tfused.BatchContext(), tp, tn, te)
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _masks(jn, jp, je, seed: int):
    """The two plugins' filter conjunction, and a random mask with empty
    rows."""
    ctx = JBatchContext()
    mask = np.asarray(jp.valid)[:, None] & np.asarray(jn.valid)[None, :]
    for jcls, _ in PLUGINS:
        mask = mask & np.asarray(jcls().batch_filter(ctx, jp, jn, je))
    rng = np.random.default_rng(seed)
    rand = rng.random(mask.shape) < 0.5
    rand[::3] = False
    return [mask, rand]


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("jcls,tcls", PLUGINS, ids=IDS)
def test_crosspod_score_and_normalize_match_jax(jcls, tcls, cluster, waves):
    (jn, jp, je), (tn, tp, te) = waves[cluster]
    want = np.asarray(jcls().batch_score(JBatchContext(), jp, jn, {}, je))
    got = tcls().batch_score(tfused.BatchContext(), tp, tn, {}, te)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for mask in _masks(jn, jp, je, len(cluster)):
        jnorm = np.asarray(jcls().batch_normalize(JBatchContext(), want, mask))
        tnorm = tcls().batch_normalize(tfused.BatchContext(), got,
                                       torch.from_numpy(mask))
        np.testing.assert_array_equal(tnorm.numpy(), jnorm)


def test_clusters_reach_every_branch(waves):
    """Between them the clusters reject and admit on every path: reverse
    anti-affinity, own anti-affinity and affinity, hostname-like and
    zone-like spread, non-zero symmetric and preferred scores."""
    (_, _, _), (tn, tp, te) = waves["features-1"]
    use = te.in_use
    assert use.ex and use.pa and use.pan and use.ppa and use.rev
    assert use.ts_hard and use.ts_soft and te.topo_unique.any()
    ctx = tfused.BatchContext()
    for name in CLUSTERS:
        (_, _, _), (tn, tp, te) = waves[name]
        for pl in (InterPodAffinity(), PodTopologySpread()):
            m = pl.batch_filter(ctx, tp, tn, te)[: int(tp.valid.sum())]
            if name != "bigdomain-0" or pl.name() == "PodTopologySpread":
                assert m.any() and not m.all(), (name, pl.name())
    (_, _, _), (tn, tp, te) = waves["bigdomain-0"]
    assert int(te.combo_dsum.max()) > 4096
    score = InterPodAffinity().batch_score(ctx, tp, tn, {}, te)
    assert not score.any()  # no affinity terms at all there
    (_, _, _), (tn, tp, te) = waves["crosspod-44"]
    score = InterPodAffinity().batch_score(ctx, tp, tn, {}, te)
    assert (score > 0).any() and (score < 0).any()


@pytest.mark.parametrize("reverse", [False, True])
def test_minmax_normalize_matches_jax(reverse):
    """Negative raw scores, int32 extremes, all-equal and empty rows."""
    rng = np.random.default_rng(11 + reverse)
    scores = rng.integers(-5000, 5000, size=(64, 96), dtype=np.int32)
    scores[3] = 7  # all equal
    scores[5, :3] = [np.iinfo(np.int32).min + 1, np.iinfo(np.int32).max, 0]
    mask = rng.random(scores.shape) < 0.6
    mask[7] = False  # no feasible node
    fill = 100 if reverse else 0
    want = np.asarray(jnormalize(scores, mask, reverse=reverse, fill=fill))
    got = minmax_normalize_batch(torch.from_numpy(scores),
                                 torch.from_numpy(mask), reverse, fill)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [44, 45, 46])
def test_parity_config4_randomized(seed):
    """``tests/test_cross_pod.py``'s config-4 parity on the port: the
    port's FusedEvaluator (tables built by the port from the same objects)
    places every pod as the scalar oracle does."""
    rng = random.Random(seed)
    nodes, assigned, pods = _random_cross_pod_cluster(rng, 24, 30, 40)
    ipa, ts = JIPA(), JPTS()
    weights = {"PodTopologySpread": 2}
    want = oracle_placements(pods, nodes, [JNodeUnschedulable(), ipa, ts],
                             [ipa, ts], [ipa, ts], weights, assigned=assigned)
    nodes = sorted(nodes, key=lambda n: n.metadata.name)
    nt, names = ttables.build_node_table(nodes, by_node(assigned), device="cpu")
    pt, _ = ttables.build_pod_table(pods, device="cpu")
    extra = tconstraints.build_constraint_tables(
        pods, nodes, assigned, pod_capacity=pt.capacity,
        node_capacity=nt.capacity, device="cpu")
    tipa, tts = InterPodAffinity(), PodTopologySpread()
    ev = tfused.FusedEvaluator([NodeUnschedulable(), tipa, tts], [tipa, tts],
                               [tipa, tts], weights)
    choice = ev(pt, nt, extra).choice.tolist()[: len(pods)]
    got = [names[c] if c >= 0 else "" for c in choice]
    assert got == want
    assert any(got)
