"""The port's constraint tables against the JAX package's, byte for byte.

``constraint_cluster`` builds a seeded cluster with every feature the
tables encode, with either package's object model: zone-like and
hostname-like topology keys (and nodes lacking them), pod affinity and
anti-affinity (required and preferred, both signs, own-namespace and
listed namespaces, the bootstrap self-match), assigned pods carrying
every kind of term, DoNotSchedule and ScheduleAnyway spread constraints,
node selectors that make nodes ineligible, and volumes: bound, unbound
and missing claims, claims bound to a missing PV, shared read-only and
writable mounts of one PV, all four driver families, zone-labelled PVs
and PVs with required node labels.  Every column of the port's
``build_constraint_tables`` must equal the JAX one in dtype, shape and
bytes, with ``scan_planes`` on and off; so must the slots the port marks
in use.  The other ``tests/test_torch_*`` files reuse the generator.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest
import torch

from minisched_tpu.api import objects as jobj
from minisched_tpu.models import constraints as jconstraints

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.models import constraints as tconstraints

GI = 1024**3
APPS = ["web", "db", "cache"]
ZONE_KEY = "topology.kubernetes.io/zone"
HOST_KEY = "kubernetes.io/hostname"
FAMILY_DRIVERS = ["", "ebs", "gcepd", "azuredisk", "csi-other"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs test files on parallel workers: this file's torch
    work keeps to two threads so it does not crowd the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _selector(objs, rng: random.Random):
    if rng.random() < 0.2:
        return objs.LabelSelector(match_expressions=[
            objs.LabelSelectorRequirement("app", "In", rng.sample(APPS, 2))])
    return objs.LabelSelector(match_labels={"app": rng.choice(APPS)})


def _term(objs, rng: random.Random, topo: str = ""):
    topo = topo or rng.choice([ZONE_KEY, ZONE_KEY, HOST_KEY])
    namespaces = ["default", "other"] if rng.random() < 0.15 else []
    return objs.PodAffinityTerm(label_selector=_selector(objs, rng),
                                topology_key=topo, namespaces=namespaces)


def _weighted(objs, rng: random.Random):
    return objs.WeightedPodAffinityTerm(weight=rng.randrange(1, 101),
                                        term=_term(objs, rng))


def _bound(pod, node_name: str):
    pod.spec.node_name = node_name
    return pod


def constraint_cluster(objs, seed: int, n_nodes: int = 40,
                       n_assigned: int = 50, n_pods: int = 60,
                       requests=None):
    """(nodes, assigned pods, pending pods, pvcs, pvs) built with the
    ``objs`` module (JAX or port objects) from one seed."""
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        labels = {}
        if rng.random() < 0.9:
            labels[ZONE_KEY] = f"z{rng.randrange(4)}"
        if rng.random() < 0.9:
            labels[HOST_KEY] = f"n{i:03d}"
        if rng.random() < 0.5:
            labels["disk"] = rng.choice(["ssd", "hdd"])
        nodes.append(objs.make_node(
            f"n{i:03d}", unschedulable=rng.random() < 0.1, labels=labels,
            capacity={"cpu": "8", "memory": "16Gi", "pods": 110}))

    pvs, pvcs = [], []

    def pv(name, claim="", driver="", zone=None, node_labels=None,
           capacity=GI):
        labels = {ZONE_KEY: zone} if zone else {}
        pvs.append(objs.PersistentVolume(
            metadata=objs.ObjectMeta(name=name, namespace="", labels=labels),
            spec=objs.PVSpec(capacity=capacity, claim_ref=claim, driver=driver,
                             required_node_labels=dict(node_labels or {}))))

    def pvc(name, volume="", read_only=False, request=GI, namespace="default"):
        pvcs.append(objs.PersistentVolumeClaim(
            metadata=objs.ObjectMeta(name=name, namespace=namespace),
            spec=objs.PVCSpec(request=request, volume_name=volume,
                              read_only=read_only)))

    # bound claims across the families, some zone-pinned or label-pinned
    for v in range(16):
        driver = FAMILY_DRIVERS[v % len(FAMILY_DRIVERS)]
        zone = f"z{rng.randrange(4)}" if rng.random() < 0.3 else None
        node_labels = {"disk": "ssd"} if rng.random() < 0.2 else None
        pv(f"pv{v}", claim=f"default/c{v}", driver=driver, zone=zone,
           node_labels=node_labels)
        pvc(f"c{v}", volume=f"pv{v}", read_only=rng.random() < 0.3)
    # second claims on shared PVs: read-only and writable
    for v in range(4):
        pvc(f"share-ro{v}", volume=f"pv{v}", read_only=True)
        pvc(f"share-rw{v}", volume=f"pv{v}")
    # unbound claims: free PVs of several sizes (one label-pinned)
    pv("free-big", capacity=4 * GI)
    pv("free-ssd", capacity=2 * GI, node_labels={"disk": "ssd"})
    pv("free-small", capacity=GI // 2)
    for u in range(4):
        pvc(f"loose{u}", request=rng.choice([GI, 3 * GI, 8 * GI]))
    pvc("dangling", volume="pv-gone")  # bound to a PV that does not exist
    claim_names = ([f"c{v}" for v in range(16)]
                   + [f"share-ro{v}" for v in range(4)]
                   + [f"share-rw{v}" for v in range(4)]
                   + [f"loose{u}" for u in range(4)] + ["dangling", "ghost"])

    def volumes():
        if rng.random() < 0.55:
            return []
        return rng.sample(claim_names, rng.randrange(1, 5))

    assigned = []
    for i in range(n_assigned):
        ns = "other" if rng.random() < 0.15 else "default"
        p = objs.make_pod(f"asg{i:03d}", namespace=ns,
                          labels={"app": rng.choice(APPS)},
                          requests={"cpu": "100m"})
        r = rng.random()
        if r < 0.2:
            p.spec.affinity = objs.Affinity(pod_anti_affinity=objs.PodAntiAffinity(
                required=[_term(objs, rng)]))
        elif r < 0.45:
            p.spec.affinity = objs.Affinity(
                pod_affinity=objs.PodAffinity(
                    required=[_term(objs, rng)] if rng.random() < 0.5 else [],
                    preferred=[_weighted(objs, rng)]),
                pod_anti_affinity=objs.PodAntiAffinity(
                    preferred=[_weighted(objs, rng)]))
        if ns == "default":
            p.spec.volumes = volumes()
        assigned.append(_bound(p, rng.choice(nodes).metadata.name))

    pods = []
    for i in range(n_pods):
        app = rng.choice(APPS)
        kw = {}
        if rng.random() < 0.3:
            kw["node_selector"] = {"disk": "ssd"}
        pod = objs.make_pod(f"p{i:03d}", labels={"app": app},
                            requests=requests, **kw)
        pa, pan = objs.PodAffinity(), objs.PodAntiAffinity()
        if rng.random() < 0.3:
            term = _term(objs, rng)
            if rng.random() < 0.3:  # matches itself: the bootstrap case
                term.label_selector = objs.LabelSelector(
                    match_labels={"app": app})
            pa.required.append(term)
        if rng.random() < 0.2:
            pan.required.append(_term(objs, rng))
        if rng.random() < 0.3:
            pa.preferred.append(_weighted(objs, rng))
        if rng.random() < 0.2:
            pan.preferred.append(_weighted(objs, rng))
        if pa.required or pa.preferred or pan.required or pan.preferred:
            pod.spec.affinity = objs.Affinity(pod_affinity=pa,
                                              pod_anti_affinity=pan)
        for _ in range(rng.choice([0, 0, 1, 2])):
            pod.spec.topology_spread_constraints.append(
                objs.TopologySpreadConstraint(
                    max_skew=rng.choice([1, 2]),
                    topology_key=rng.choice([ZONE_KEY, ZONE_KEY, HOST_KEY]),
                    when_unsatisfiable=rng.choice(["DoNotSchedule",
                                                   "ScheduleAnyway"]),
                    label_selector=objs.LabelSelector(match_labels={"app": app})))
        pod.spec.volumes = volumes()
        pods.append(pod)
    return nodes, assigned, pods, pvcs, pvs


def jax_constraint_columns(nodes, assigned, pods, pvcs, pvs, **kw) -> dict:
    extra = jconstraints.build_constraint_tables(pods, nodes, assigned,
                                                 pvcs=pvcs, pvs=pvs, **kw)
    return {f.name: np.asarray(getattr(extra, f.name))
            for f in dataclasses.fields(extra)}


def port_constraint_tables(cols: dict):
    """JAX columns → the port's tables on the CPU."""
    return tconstraints.constraint_tables_from_numpy(cols, "cpu")


SEEDS = [1, 7, 13]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scan_planes", [True, False])
def test_constraint_tables_match_jax(seed, scan_planes):
    jcluster = constraint_cluster(jobj, seed)
    want = jax_constraint_columns(*jcluster, scan_planes=scan_planes)
    nodes, assigned, pods, pvcs, pvs = constraint_cluster(tobj, seed)
    got = tconstraints.build_constraint_tables(
        pods, nodes, assigned, pvcs=pvcs, pvs=pvs, scan_planes=scan_planes,
        device="cpu")
    names = [f.name for f in dataclasses.fields(got) if f.name != "in_use"]
    assert names == list(want)
    assert len(names) == 40
    for name in names:
        g = getattr(got, name).numpy()
        w = want[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name
    # the JAX tables carried into the port give the same slots in use
    assert port_constraint_tables(want).in_use == got.in_use


def test_constraint_cluster_reaches_every_feature():
    nodes, assigned, pods, pvcs, pvs = constraint_cluster(tobj, SEEDS[0])
    t = tconstraints.build_constraint_tables(pods, nodes, assigned, pvcs=pvcs,
                                             pvs=pvs, device="cpu")
    use = t.in_use
    assert use.ts_hard and use.ts_soft and use.rev and use.ex
    assert use.pa and use.pan and use.ppa > 1 and use.vols >= 3
    assert t.topo_unique.any() and not t.topo_unique.all()  # both key kinds
    assert (t.ppa_w < 0).any() and (t.ppa_w > 0).any()
    assert t.pa_self.any() and (t.combo_global == 0).any()
    assert not t.vol_ok[: len(pods)].all() and t.vol_ok[: len(pods)].any()
    assert (t.pod_missing > 0).any()
    fam = t.claim_family[: int((t.claim_mask.any(dim=1)).sum())]
    assert set(fam.tolist()) >= {0, 1, 2, 3}
    assert t.claim_ro.any() and (t.claim_vol < 0).any()
    assert t.vol_any.any() and t.vol_rw.any() and (t.node_vols_fam > 0).any()
    assert (~t.claim_zone_ok[:4]).any()
