"""Configs 3, 4 and 5 of the JAX package: repair waves and the scan lanes.

Counterpart of the config-3, config-4 and config-5 flows of ``bench.py``
(``bench_config3``, ``bench_config4``, ``_c5_cluster``,
``bench_fullchain_parity``) and of the live engine's cross-pod lane
(``engine/device_scheduler.py`` ``_schedule_scan_blocked``): the
clusters' objects and three entry points.

* ``schedule_repair_waves`` runs pods through the wave driver's
  ``"repair"`` route (``headline.schedule_waves``): every wave runs
  evaluate-accept-commit rounds (``ops/repair.py``) until its pods are
  placed or have no feasible node, and the updated table carries to the
  next wave.
* ``schedule_scan`` places pods with the exact scan
  (``ops/sequential.SequentialScheduler``), in chunks: pod i sees every
  bind before it.
* ``schedule_crosspod`` is the blocked lane: it groups the pods by
  interaction (``engine/scan_groups.py``), orders them into blocks of 32
  and runs the blocked scan in chunks of 8,192 rows, for up to 3
  attempts; pods that lost a same-node capacity race are regrouped and
  tried again against the state the last attempt left, and what is left
  after the attempts goes through the exact scan.  With no live engine
  yet, the pods go in the order given: one backlog flush at queue drain.

``mk_c5_gang_cluster`` is config 5 with gangs (run with
``service.config.gang_roster_config``): each wave and scan chunk gets the
placed aggregate of its gangs (``engine.gang.PlacedGangs``), as the JAX
engine passes its ``gang_view``.

Every round or step ends in ``select_hosts``, the hand-written
seeded-argmax kernel on a card.  The roster is ``cfg``, by default the
full default roster (``service.config.default_full_roster_config``),
whose volume and cross-pod plugins read constraint tables built on the
host (each wave's, each scan chunk's) with the pods placed so far as
assigned pods; ``node_local_roster_config`` is the same roster without
them.

Usage (on the card)::

    from minisched_tpu_torch.fullchain import mk_c5_cluster, schedule_repair_waves
    nodes, pods = mk_c5_cluster()
    run = schedule_repair_waves(nodes, pods)
    print(run.rounds, run.schedule_s, run.constraint_build_s)
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from minisched_tpu_torch import resolve_device
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
    make_gang_pods,
    make_node,
    make_pod,
)
from minisched_tpu_torch.engine.device_scheduler import DeviceScheduler
from minisched_tpu_torch.engine.gang import PlacedGangs
from minisched_tpu_torch.engine.scan_groups import (
    interaction_sets,
    order_into_blocks,
)
from minisched_tpu_torch.headline import (
    ConstraintFeed,
    WaveRun,
    commit,
    pods_by_node,
    schedule_waves,
    synchronize,
)
from minisched_tpu_torch.models.tables import (
    NodeTable,
    build_pod_table,
    pack_node_table,
    pad_to,
)
from minisched_tpu_torch.ops.sequential import (
    BlockedSequentialScheduler,
    SequentialScheduler,
    StepLog,
)
from minisched_tpu_torch.plugins.registry import build_plugins
from minisched_tpu_torch.service.config import (
    PluginEnabled,
    PluginSet,
    SchedulerConfig,
    default_full_roster_config,
)
from minisched_tpu_torch.utils import build

WAVE = 16_384  # pods per wave of the config-5 run
C5_REQUESTS = {"cpu": "500m", "memory": "256Mi"}
C5_MAX_SKEW = 4  # max_skew of config 5's spread pods (``bench.py``)

# the live engine's lane constants
SCAN_MAX_CHUNK = DeviceScheduler.SCAN_MAX_CHUNK  # pods per exact-scan chunk
SCAN_BLOCK_SIZE = DeviceScheduler.SCAN_BLOCK_SIZE  # pods per block
SCAN_BLOCK_RETRIES = DeviceScheduler.SCAN_BLOCK_RETRIES  # blocked attempts
BLOCKED_MAX_CHUNK = DeviceScheduler.BLOCKED_MAX_CHUNK  # rows per blocked call
#: the blocked lane's capacity tiers: 128, 1,024, 8,192 rows
_blocked_cap = DeviceScheduler._blocked_cap


def c3_roster_config() -> SchedulerConfig:
    """Config 3's chain (``bench_config3``): the NodeUnschedulable and
    NodeResourcesFit filters and the NodeResourcesLeastAllocated score."""
    return SchedulerConfig(
        filter=PluginSet(enabled=[PluginEnabled("NodeUnschedulable"),
                                  PluginEnabled("NodeResourcesFit")]),
        score=PluginSet(enabled=[PluginEnabled("NodeResourcesLeastAllocated")]))


def mk_c3_cluster(n_nodes: int = 4096,
                  n_pods: int = 4096) -> Tuple[List[Any], List[Any]]:
    """The config-3 cluster (the objects of ``bench.py`` ``bench_config3``,
    ``random.Random(3)``): ``n_nodes`` nodes ``node00000`` … of 4 or 8
    CPU, 16 Gi and 110 pods, and ``n_pods`` pods ``pod0`` … asking for
    500m, 1 or 2 CPU and 2 Gi."""
    rng = random.Random(3)
    nodes = [
        make_node(f"node{i:05d}",
                  capacity={"cpu": rng.choice(["4", "8"]), "memory": "16Gi",
                            "pods": 110})
        for i in range(n_nodes)
    ]
    pods = [make_pod(f"pod{i}", requests={"cpu": rng.choice(["500m", "1", "2"]),
                                          "memory": "2Gi"})
            for i in range(n_pods)]
    return nodes, pods


def mk_c5_cluster(n_nodes: int = 10_000, n_pods: int = 100_000,
                  n_crosspod: int = 0) -> Tuple[List[Any], List[Any]]:
    """The config-5 cluster (the objects of ``bench.py`` ``_c5_cluster``,
    without the control plane): ``n_nodes`` nodes ``node00000`` … of 8
    CPU, 16 Gi and 110 pods, zone labels ``z0`` … ``z15``, each cordoned
    with probability 0.2 from ``random.Random(55)``; ``n_pods`` pods asking
    for 500m and 256 Mi, in bench's order: plain pods, then
    ``n_crosspod`` pods ``spread*`` of 32 apps (``app{i % 32}``), each with
    a DoNotSchedule zone spread of max skew 4 over its app, then the last
    2% (``special*``), which carry a node selector no node matches."""
    nodes = _c5_nodes(n_nodes)
    n_special = max(n_pods // 50, 1)
    pods = [make_pod(f"pod{i:06d}", requests=C5_REQUESTS)
            for i in range(n_pods - n_special - n_crosspod)]
    pods += [c5_spread_pod(f"spread{i:05d}", f"app{i % 32}")
             for i in range(n_crosspod)]
    pods += [make_pod(f"special{i:05d}", requests=C5_REQUESTS,
                      node_selector={"special": "true"})
             for i in range(n_special)]
    return nodes, pods


def c5_spread_pod(name: str, app: str) -> Any:
    """A spread pod of config 5: 500m and 256 Mi, labelled ``app``, with a
    DoNotSchedule zone spread of max skew 4 over its app."""
    pod = make_pod(name, requests=C5_REQUESTS, labels={"app": app})
    pod.spec.topology_spread_constraints = [TopologySpreadConstraint(
        max_skew=C5_MAX_SKEW, topology_key="zone",
        when_unsatisfiable="DoNotSchedule",
        label_selector=LabelSelector(match_labels={"app": app}))]
    return pod


def _c5_nodes(n_nodes: int, sliced: bool = False) -> List[Any]:
    """Config 5's nodes (``random.Random(55)`` cordons 20%); ``sliced``
    puts node i on slice ``i // SLICE_HOSTS`` as host ``i % SLICE_HOSTS``
    of a 4 x 4 torus, as ``bench.py`` ``bench_gang`` lays out its hosts;
    even slices declare their dimensions (4, 4, 1), so the ring wraps, odd
    slices none (the distance does not wrap)."""
    rng = random.Random(55)
    nodes = []
    for i in range(n_nodes):
        kw = {}
        if sliced:
            s, h = divmod(i, SLICE_HOSTS)
            kw = dict(slice_id=f"slice{s:03d}", torus=(h % 4, h // 4, 0),
                      host_index=h, slice_dims=(4, 4, 1) if s % 2 == 0 else None)
        nodes.append(make_node(
            f"node{i:05d}",
            unschedulable=rng.random() < 0.2,
            capacity={"cpu": "8", "memory": "16Gi", "pods": 110},
            labels={"zone": f"z{i % 16}"}, **kw))
    return nodes


SLICE_HOSTS = 16  # hosts a slice of the gang cluster
GANG_SIZE = 8  # members a gang of the gang cluster
GANG_EVERY = 16  # plain pods before each gang's pending members


def mk_c5_gang_cluster(n_nodes: int = 10_000, n_pods: int = 100_000,
                       n_gangs: int = 4_096
                       ) -> Tuple[List[Any], List[Any], List[Any]]:
    """Config 5 with gangs: (nodes, assigned pods, pending pods).

    The nodes are config 5's, each also on one of ``n_nodes // 16`` slices
    of 16 hosts (``_c5_nodes(sliced=True)``).  ``n_gangs`` gangs of 8
    members ``gang{g:04d}-{m}`` ask for config 5's 500m and 256 Mi; for a
    quarter of them (drawn from ``random.Random(56)``) members 0-3 are
    already bound to 4 uncordoned hosts of one slice, the rest pending:
    the stragglers of a gang whose peers landed.  The pending pods come in
    the order the JAX queue keeps gang members, adjacent: 16 plain pods
    ``pod{i:06d}``, then one gang's pending members, for every gang; then
    the plain pods left; then the last 2% (``special*``, a node selector
    no node matches).  At full size: 28,672 gang members, 69,328 plain
    and 2,000 special pods, 4,096 assigned."""
    nodes = _c5_nodes(n_nodes, sliced=True)
    rng = random.Random(56)
    open_hosts: List[List[Any]] = []
    for s in range(0, n_nodes, SLICE_HOSTS):
        hosts = [n for n in nodes[s:s + SLICE_HOSTS] if not n.spec.unschedulable]
        if len(hosts) >= GANG_SIZE // 2:
            open_hosts.append(hosts)
    stragglers = set(rng.sample(range(n_gangs), n_gangs // 4))
    assigned, gang_pending = [], []
    for g in range(n_gangs):
        members = make_gang_pods(f"gang{g:04d}", GANG_SIZE,
                                 requests=C5_REQUESTS)
        if g in stragglers:
            half = GANG_SIZE // 2
            for pod, host in zip(members[:half],
                                 rng.sample(rng.choice(open_hosts), half)):
                pod.spec.node_name = host.metadata.name
                assigned.append(pod)
            members = members[half:]
        gang_pending.append(members)
    n_special = max(n_pods // 50, 1)
    n_plain = n_pods - n_special - sum(len(m) for m in gang_pending)
    plain = iter([make_pod(f"pod{i:06d}", requests=C5_REQUESTS)
                  for i in range(n_plain)])
    pods: List[Any] = []
    for members in gang_pending:
        pods += [p for _, p in zip(range(GANG_EVERY), plain)]
        pods += members
    pods += list(plain)
    pods += [make_pod(f"special{i:05d}", requests=C5_REQUESTS,
                      node_selector={"special": "true"})
             for i in range(n_special)]
    return nodes, assigned, pods


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


@dataclass
class ScanRun:
    """What ``schedule_scan`` returns.  Times are host wall seconds, closed
    by a device synchronise on a card."""

    choices: np.ndarray  # int64[n_pods] node row per pod, -1 = unplaced
    best: np.ndarray  # int64[n_pods] winning score (0 when unplaced)
    node_table: NodeTable  # the resident table after the last chunk
    node_names: List[str]
    build_s: float  # host encoding of the node table
    #: every chunk: pod and constraint tables built on the host, the scan
    #: and the read of its choices
    schedule_s: float
    #: the part of ``schedule_s`` in constraint builds and their commits
    constraint_build_s: float
    chunks: int
    log: StepLog = field(default_factory=StepLog)
    #: per chunk with gang members: the gang view its pod table was given
    gang_views: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class CrosspodRun:
    """What ``schedule_crosspod`` returns."""

    choices: np.ndarray  # int64[n_pods] node row per pod, -1 = unplaced
    node_table: NodeTable
    attempts: int  # blocked attempts made (at most SCAN_BLOCK_RETRIES)
    blocks: List[int]  # blocks of each attempt
    #: per blocked call, in order: (choice, accepted) of its rows in block
    #: order (padding rows included)
    calls: List[Tuple[np.ndarray, np.ndarray]]
    exact_pods: int  # capacity-race leftovers placed by the exact scan
    schedule_s: float  # the whole lane, host builds included
    grouping_s: float  # interaction sets and block order, every attempt
    constraint_build_s: float
    log: StepLog = field(default_factory=StepLog)


def _scan_chains(cfg: Optional[SchedulerConfig]):
    cfg = cfg or default_full_roster_config()
    return build_plugins(cfg), cfg.score_weights()


def _chunk_tables(pods: Sequence[Any], capacity: int,
                  feed: Optional[ConstraintFeed], gangs: Optional[PlacedGangs],
                  device: torch.device, invalid_rows: Sequence[int] = ()):
    """The pod table of one chunk, with its gangs' placed members when it
    has gang members, and, when the roster reads them, its constraint
    tables from ``feed``.  The gang view stays fixed inside the chunk, as
    in the JAX engine: members placed earlier in the chunk do not warm
    it."""
    pod_table, _ = build_pod_table(
        pods, capacity=capacity, device=device, invalid_rows=invalid_rows,
        gang_view=gangs.view(pods) if gangs else None)
    return pod_table, (feed.tables(pods, capacity) if feed else None)


def _exact_chunks(sched: SequentialScheduler, pods: Sequence[Any],
                  node_table: NodeTable, feed: Optional[ConstraintFeed],
                  gangs: Optional[PlacedGangs], log: StepLog
                  ) -> Tuple[NodeTable, List[int], List[int]]:
    """The exact scan over ``pods`` in chunks of ``SCAN_MAX_CHUNK``, each
    chunk's placements committed to ``feed`` and ``gangs``: (node table,
    choices, best scores)."""
    choices: List[int] = []
    best: List[int] = []
    device = node_table.valid.device
    for start in range(0, len(pods), SCAN_MAX_CHUNK):
        part = pods[start:start + SCAN_MAX_CHUNK]
        pod_table, extra = _chunk_tables(part, pad_to(len(part)), feed,
                                         gangs, device)
        node_table, choice, score = sched(pod_table, node_table, extra, log)
        rows = choice[: len(part)].tolist()
        choices += rows
        best += score[: len(part)].tolist()
        commit(part, rows, feed, gangs)
    return node_table, choices, best


def schedule_scan(nodes: Sequence[Any], pods: Sequence[Any],
                  cfg: Optional[SchedulerConfig] = None,
                  assigned: Sequence[Any] = (), pvcs: Sequence[Any] = (),
                  pvs: Sequence[Any] = (), device=None,
                  log: Optional[StepLog] = None) -> ScanRun:
    """Place ``pods`` in order with the exact scan and the roster ``cfg``
    (default: the full default roster), in chunks of ``SCAN_MAX_CHUNK``
    pods against one resident node table.  Each chunk's constraint tables
    count the ``assigned`` pods and every pod placed by an earlier chunk.
    ``device=None`` means the card (and raises without one)."""
    device = resolve_device(device)
    log = log or StepLog()
    chains, weights = _scan_chains(cfg)
    sched = SequentialScheduler(chains.filter, chains.pre_score, chains.score,
                                weights=weights)
    if device.type == "cuda":
        build.load_library()
    t0 = time.monotonic()
    node_host, node_names = pack_node_table(nodes, pods_by_node(assigned),
                                            capacity=pad_to(len(nodes)))
    node_table = node_host.to_device(device)
    synchronize(device)
    build_s = time.monotonic() - t0
    t0 = time.monotonic()
    feed = ConstraintFeed.for_step(sched, nodes, node_names, assigned, pvcs,
                                   pvs, node_table.capacity, device,
                                   scan_planes=True)
    gangs = PlacedGangs.for_pods(pods, nodes, assigned)
    node_table, choices, best = _exact_chunks(sched, pods, node_table, feed,
                                              gangs, log)
    synchronize(device)
    return ScanRun(
        choices=np.asarray(choices, np.int64), best=np.asarray(best, np.int64),
        node_table=node_table, node_names=node_names, build_s=build_s,
        schedule_s=time.monotonic() - t0,
        constraint_build_s=feed.build_s if feed else 0.0,
        chunks=-(-len(pods) // SCAN_MAX_CHUNK), log=log,
        gang_views=gangs.views if gangs else [])


def schedule_crosspod(nodes: Sequence[Any], pods: Sequence[Any],
                      node_table: NodeTable, assigned: Sequence[Any] = (),
                      cfg: Optional[SchedulerConfig] = None,
                      pvcs: Sequence[Any] = (), pvs: Sequence[Any] = (),
                      device=None, log: Optional[StepLog] = None
                      ) -> CrosspodRun:
    """Place cross-pod-constrained ``pods`` through the blocked lane, as
    the live engine's ``_schedule_scan_blocked`` does (module docstring),
    against ``node_table`` (rows in the order of ``nodes``, on ``device``)
    whose committed pods are ``assigned``.  ``device=None`` means the
    card."""
    device = resolve_device(device)
    if node_table.valid.device.type != device.type:
        raise ValueError(f"node table on {node_table.valid.device}, lane on "
                         f"{device}")
    log = log or StepLog()
    chains, weights = _scan_chains(cfg)
    blocked = BlockedSequentialScheduler(
        chains.filter, chains.pre_score, chains.score, weights=weights,
        block_size=SCAN_BLOCK_SIZE)
    t_start = time.monotonic()
    feed = ConstraintFeed.for_step(
        blocked, nodes, [n.metadata.name for n in nodes], assigned, pvcs, pvs,
        node_table.capacity, device, scan_planes=True)
    gangs = PlacedGangs.for_pods(pods, nodes, assigned)
    position = {id(p): k for k, p in enumerate(pods)}
    choices = np.full(len(pods), -1, np.int64)
    dummy = make_pod("scan-pad")
    calls: List[Tuple[np.ndarray, np.ndarray]] = []
    blocks_of: List[int] = []
    grouping_s = 0.0
    pending = list(pods)
    for _attempt in range(SCAN_BLOCK_RETRIES):
        t0 = time.monotonic()
        sets = interaction_sets(pending)
        blocks = order_into_blocks(pending, sets, SCAN_BLOCK_SIZE)
        flat = [m for blk in blocks for m in blk]
        grouping_s += time.monotonic() - t0
        blocks_of.append(len(blocks))
        retry = []
        for start in range(0, len(flat), BLOCKED_MAX_CHUNK):
            part = flat[start:start + BLOCKED_MAX_CHUNK]
            pad_rows = [i for i, m in enumerate(part) if m is None]
            pod_table, extra = _chunk_tables(
                [m if m is not None else dummy for m in part],
                _blocked_cap(len(part)), feed, gangs, device,
                invalid_rows=pad_rows)
            node_table, choice, _, accepted = blocked(
                pod_table, node_table, extra, log)
            rows = choice[: len(part)].tolist()
            won = accepted[: len(part)].tolist()
            calls.append((np.asarray(rows, np.int64), np.asarray(won, bool)))
            placed, placed_rows = [], []
            for m, row, ok in zip(part, rows, won):
                if m is None:
                    continue
                if row >= 0 and ok:
                    choices[position[id(m)]] = row
                    placed.append(m)
                    placed_rows.append(row)
                elif row >= 0:
                    retry.append(m)  # feasible; lost a same-node race
            commit(placed, placed_rows, feed, gangs)
        pending = retry
        if not pending:
            break
    exact_pods = len(pending)
    if pending:
        # the capacity-race stragglers: a sequential order never fails
        # them, so neither may this lane
        exact = SequentialScheduler(chains.filter, chains.pre_score,
                                    chains.score, weights=weights)
        node_table, rows, _ = _exact_chunks(exact, pending, node_table, feed,
                                            gangs, log)
        for m, row in zip(pending, rows):
            choices[position[id(m)]] = row
    synchronize(device)
    return CrosspodRun(
        choices=choices, node_table=node_table, attempts=len(blocks_of),
        blocks=blocks_of, calls=calls, exact_pods=exact_pods,
        schedule_s=time.monotonic() - t_start, grouping_s=grouping_s,
        constraint_build_s=feed.build_s if feed else 0.0, log=log)
