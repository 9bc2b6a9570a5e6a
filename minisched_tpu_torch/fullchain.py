"""Config 5 and config 4 of the JAX package, in repair waves.

Counterpart of the config-5 and config-4 flows of ``bench.py``
(``_c5_cluster``, ``bench_config4``): the clusters' objects, and
``schedule_repair_waves``, which runs them through the wave driver's
``"repair"`` route (``headline.schedule_waves``): every wave runs
evaluate-accept-commit rounds (``ops/repair.py``) until its pods are
placed or have no feasible node, and the updated table carries to the
next wave.  Every round ends in ``select_hosts``, the hand-written
seeded-argmax kernel on a card.  The roster is ``cfg``, by default the
full default roster (``service.config.default_full_roster_config``),
whose volume and cross-pod plugins read each wave's constraint tables;
``node_local_roster_config`` is the same roster without them.

Usage (on the card)::

    from minisched_tpu_torch.fullchain import mk_c5_cluster, schedule_repair_waves
    nodes, pods = mk_c5_cluster()
    run = schedule_repair_waves(nodes, pods)
    print(run.rounds, run.schedule_s, run.constraint_build_s)
"""

from __future__ import annotations

import random
from typing import Any, List, Optional, Sequence, Tuple

from minisched_tpu_torch.api.objects import (
    Affinity,
    LabelSelector,
    ObjectMeta,
    PersistentVolume,
    PersistentVolumeClaim,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PVCSpec,
    PVSpec,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
    make_node,
    make_pod,
)
from minisched_tpu_torch.headline import WaveRun, schedule_waves
from minisched_tpu_torch.service.config import (
    SchedulerConfig,
    default_full_roster_config,
)

WAVE = 16_384  # pods per wave of the config-5 run
C5_REQUESTS = {"cpu": "500m", "memory": "256Mi"}


def mk_c5_cluster(n_nodes: int = 10_000,
                  n_pods: int = 100_000) -> Tuple[List[Any], List[Any]]:
    """The config-5 cluster (the objects of ``bench.py`` ``_c5_cluster``,
    without the control plane): ``n_nodes`` nodes ``node00000`` … of 8
    CPU, 16 Gi and 110 pods, zone labels ``z0`` … ``z15``, each cordoned
    with probability 0.2 from ``random.Random(55)``; ``n_pods`` pods asking
    for 500m and 256 Mi, of which the last 2% (``special*``) carry a node
    selector no node matches."""
    rng = random.Random(55)
    nodes = [
        make_node(
            f"node{i:05d}",
            unschedulable=rng.random() < 0.2,
            capacity={"cpu": "8", "memory": "16Gi", "pods": 110},
            labels={"zone": f"z{i % 16}"},
        )
        for i in range(n_nodes)
    ]
    n_special = max(n_pods // 50, 1)
    pods = [make_pod(f"pod{i:06d}", requests=C5_REQUESTS)
            for i in range(n_pods - n_special)]
    pods += [make_pod(f"special{i:05d}", requests=C5_REQUESTS,
                      node_selector={"special": "true"})
             for i in range(n_special)]
    return nodes, pods


def mk_c4_cluster() -> Tuple[List[Any], List[Any], List[Any]]:
    """The config-4 cluster (the objects of ``bench.py`` ``bench_config4``,
    ``random.Random(4)``): 2,048 nodes ``node00000`` … in 8 zones, 512
    assigned pods of 8 apps, and 2,048 pods each with a required zone pod
    affinity to its app and a ScheduleAnyway zone spread of skew 2.
    Returns (nodes, assigned pods, pending pods)."""
    rng = random.Random(4)
    zones = [f"z{i}" for i in range(8)]
    nodes = sorted(
        (make_node(f"node{i:05d}", labels={"zone": rng.choice(zones)})
         for i in range(2048)),
        key=lambda n: n.metadata.name,
    )
    assigned = []
    for i in range(512):
        p = make_pod(f"asg{i}", labels={"app": f"app{rng.randrange(8)}"})
        p.metadata.uid = f"asg{i}"
        p.spec.node_name = rng.choice(nodes).metadata.name
        assigned.append(p)
    pods = []
    for i in range(2048):
        app = f"app{rng.randrange(8)}"
        pod = make_pod(f"pod{i}", labels={"app": app})
        selector = LabelSelector(match_labels={"app": app})
        pod.spec.affinity = Affinity(pod_affinity=PodAffinity(required=[
            PodAffinityTerm(label_selector=selector, topology_key="zone")]))
        pod.spec.topology_spread_constraints = [TopologySpreadConstraint(
            max_skew=2, topology_key="zone",
            when_unsatisfiable="ScheduleAnyway", label_selector=selector)]
        pods.append(pod)
    return nodes, assigned, pods


ZONE_KEY = "topology.kubernetes.io/zone"
HOST_KEY = "kubernetes.io/hostname"
GI = 1024**3


def mk_mixed_cluster(n_nodes: int = 2048, n_pods: int = 8192,
                     seed: int = 10) -> Tuple[List[Any], ...]:
    """A cluster that carries every feature of the full default roster:
    (nodes, assigned pods, pending pods, pvcs, pvs), from
    ``random.Random(seed)``.

    Nodes sit in 8 zones (``topology.kubernetes.io/zone``), each carries
    its own ``kubernetes.io/hostname`` (as the kubelet labels it), half
    carry a ``disk`` label and a tenth are cordoned.  Zone z0 holds more
    than 4,096 assigned ``app=web`` pods,
    so its domain sum of that app exceeds what TF32 keeps exact.  Other
    assigned pods carry required anti-affinity and preferred (anti-)
    affinity terms and mount volumes.  Pending pods mix required and
    preferred (anti-)affinity on zone and hostname keys, DoNotSchedule
    and ScheduleAnyway spread on both keys, node selectors, and volumes:
    bound claims of all four driver families, read-only and writable
    second claims of shared PVs, unbound claims (with free PVs to bind)
    and missing claims."""
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        labels = {ZONE_KEY: f"z{i % 8}", HOST_KEY: f"node{i:05d}"}
        if rng.random() < 0.5:
            labels["disk"] = rng.choice(["ssd", "hdd"])
        nodes.append(make_node(
            f"node{i:05d}", unschedulable=rng.random() < 0.1, labels=labels,
            capacity={"cpu": "32", "memory": "64Gi", "pods": 110}))
    apps = ["web", "db", "cache", "queue"]

    def selector(app: str) -> LabelSelector:
        return LabelSelector(match_labels={"app": app})

    def term(app: str, key: str) -> PodAffinityTerm:
        return PodAffinityTerm(label_selector=selector(app), topology_key=key)

    pvs, pvcs = [], []
    drivers = ["", "ebs", "gcepd", "azuredisk"]
    for v in range(256):
        zone = f"z{v % 8}" if v % 5 == 0 else None
        pvs.append(PersistentVolume(
            ObjectMeta(name=f"pv{v}", namespace="",
                       labels={ZONE_KEY: zone} if zone else {}),
            PVSpec(capacity=GI, claim_ref=f"default/c{v}",
                   driver=drivers[v % 4])))
        pvcs.append(PersistentVolumeClaim(
            ObjectMeta(name=f"c{v}"),
            PVCSpec(request=GI, volume_name=f"pv{v}", read_only=v % 7 == 0)))
    for v in range(32):  # second claims of shared PVs
        pvcs.append(PersistentVolumeClaim(
            ObjectMeta(name=f"ro{v}"),
            PVCSpec(request=GI, volume_name=f"pv{v}", read_only=True)))
        pvcs.append(PersistentVolumeClaim(
            ObjectMeta(name=f"rw{v}"), PVCSpec(request=GI, volume_name=f"pv{v}")))
    for v in range(16):  # unbound claims and free PVs to bind them
        pvcs.append(PersistentVolumeClaim(
            ObjectMeta(name=f"loose{v}"), PVCSpec(request=(v % 3 + 1) * GI)))
        pvs.append(PersistentVolume(
            ObjectMeta(name=f"free{v}", namespace=""),
            PVSpec(capacity=2 * GI,
                   required_node_labels={"disk": "ssd"} if v % 2 else {})))
    claims = ([f"c{v}" for v in range(256)] + [f"ro{v}" for v in range(32)]
              + [f"rw{v}" for v in range(32)] + [f"loose{v}" for v in range(16)]
              + ["missing0", "missing1"])

    zone0 = [n for n in nodes if n.metadata.labels[ZONE_KEY] == "z0"]
    assigned = []
    for i in range(4200):  # z0's app=web domain sum: 4,200 > 4,096
        p = make_pod(f"web-old{i:05d}", labels={"app": "web"},
                     requests={"cpu": "10m"})
        p.spec.node_name = rng.choice(zone0).metadata.name
        assigned.append(p)
    for i in range(600):
        app = rng.choice(apps)
        p = make_pod(f"old{i:05d}", labels={"app": app},
                     requests={"cpu": "100m"})
        roll = rng.random()
        if roll < 0.1:
            p.spec.affinity = Affinity(pod_anti_affinity=PodAntiAffinity(
                required=[term(rng.choice(apps[1:]), HOST_KEY)]))
        elif roll < 0.3:
            p.spec.affinity = Affinity(
                pod_affinity=PodAffinity(
                    required=[term(rng.choice(apps), ZONE_KEY)],
                    preferred=[WeightedPodAffinityTerm(
                        rng.randrange(1, 101), term(rng.choice(apps), ZONE_KEY))]),
                pod_anti_affinity=PodAntiAffinity(preferred=[
                    WeightedPodAffinityTerm(rng.randrange(1, 101),
                                            term(rng.choice(apps), HOST_KEY))]))
        if rng.random() < 0.3:
            p.spec.volumes = [f"c{rng.randrange(256)}"]
        p.spec.node_name = rng.choice(nodes).metadata.name
        assigned.append(p)

    pods = []
    for i in range(n_pods):
        app = rng.choice(apps)
        kw = {}
        if rng.random() < 0.2:
            kw["node_selector"] = {"disk": "ssd"}
        pod = make_pod(f"pod{i:05d}", labels={"app": app},
                       requests={"cpu": "500m", "memory": "256Mi"}, **kw)
        pa, pan = PodAffinity(), PodAntiAffinity()
        roll = rng.random()
        if roll < 0.1:
            pa.required.append(term(app, rng.choice([ZONE_KEY, HOST_KEY])))
        elif roll < 0.15:
            pan.required.append(term(rng.choice(apps), HOST_KEY))
        elif roll < 0.2:
            pan.required.append(term("queue", ZONE_KEY))
        if rng.random() < 0.2:
            pa.preferred.append(WeightedPodAffinityTerm(
                rng.randrange(1, 101), term(rng.choice(apps), ZONE_KEY)))
        if rng.random() < 0.1:
            pan.preferred.append(WeightedPodAffinityTerm(
                rng.randrange(1, 101), term(app, HOST_KEY)))
        if pa.required or pa.preferred or pan.required or pan.preferred:
            pod.spec.affinity = Affinity(pod_affinity=pa, pod_anti_affinity=pan)
        if rng.random() < 0.3:
            pod.spec.topology_spread_constraints.append(TopologySpreadConstraint(
                max_skew=rng.choice([1, 3, 50]),
                topology_key=rng.choice([ZONE_KEY, HOST_KEY]),
                when_unsatisfiable=rng.choice(["DoNotSchedule",
                                               "ScheduleAnyway"]),
                label_selector=selector(app)))
        if rng.random() < 0.3:
            pod.spec.volumes = rng.sample(claims, rng.randrange(1, 4))
        pods.append(pod)
    return nodes, assigned, pods, pvcs, pvs


def schedule_repair_waves(nodes: Sequence[Any], pods: Sequence[Any],
                          wave: int = WAVE, device=None,
                          cfg: Optional[SchedulerConfig] = None,
                          assigned: Sequence[Any] = (),
                          pvcs: Sequence[Any] = (),
                          pvs: Sequence[Any] = ()) -> WaveRun:
    """Schedule ``pods`` against ``nodes`` in repair waves of ``wave``
    (``schedule_waves`` on the ``"repair"`` route) with the roster ``cfg``
    (default: the full default roster).  ``assigned`` pods (with
    ``spec.node_name`` set) hold resources and count in the constraint
    tables, as do ``pvcs`` and ``pvs``.  ``device=None`` means the card
    (and raises without one); ``device="cpu"`` runs the plain twins on the
    host."""
    return schedule_waves(nodes, pods, wave=wave, route="repair",
                          device=device,
                          cfg=cfg or default_full_roster_config(),
                          assigned=assigned, pvcs=pvcs, pvs=pvs)
