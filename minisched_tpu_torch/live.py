"""Config 5 and the gang cluster through the live engine, with their audits.

The drivers ``chip_smoke.py`` (phases 17-18) and the ``c5`` bench role
share: the cluster is created in the port's store, then
``SchedulerService.start_scheduler(device_mode=True)`` runs the engine
until the run's goal holds, and the audits read the store's final state.

``run_config5_live`` is ``bench.py``'s ``_bench_config5_fullchain_once``
(``:469-640``): config 5 (``fullchain.mk_c5_cluster``: 10,000 nodes, 20%
cordoned, 98,000 plain pods and 2,000 ``special*`` pods whose node
selector no node matches) with the full default roster in waves of
16,384.  The first drain binds the plain pods and parks the special ones;
then 2,000 schedulable nodes (``random.Random(55)``, as ``bench.py``
draws them) get the label ``special=true`` and the Node label updates
requeue the parked pods until all 100,000 are bound.

With ``n_crosspod`` spread pods (``bench.py`` with ``BENCH_C5_CROSSPOD``)
the engine defers them into its backlog and places them through the scan
lanes; ``audit_spread`` is ``bench.py``'s spread audit (``:655-688``).
``pipeline`` picks the engine's loop: the pipelined default, or the
serial loop whose first drain ``schedule_repair_waves`` reproduces.
With ``preempt_burst`` the run goes on once every pod is bound: that
many ``high*`` pods of 4 CPU and 1 Gi at priority 100 arrive at once (the
JAX scale test's preemptors, ``tests/test_preemption.py``), and each must
preempt its way in through the wave-loser pass and DefaultPreemption
(``BurstRun``).  Config 5's waves leave nodes unevenly full (many with 4
CPU or more free), so first every schedulable node with 4 CPU free is
topped up with ``fill*`` pods of config 5's shape at priority 0, bound
where they are created, until it has less; the store is then checked to
hold no such node.

``run_gang_live`` drives ``fullchain.mk_c5_gang_cluster`` (gangs of 8,
a quarter with 4 members already bound) with ``gang_roster_config``:
Coscheduling admits each gang all or nothing at Permit.

``run_mixed_recorded`` is ``record_results`` on the mixed cluster
(``fullchain.mk_mixed_cluster``, with its claims and PVs) on the serial
engine: each pod's bindings and parsed ``scheduler-simulator/*``
annotations, and which pods a record call carried.  ``run_config5_http``
is the standalone process (``__main__.start``) fed config 5 over its REST
façade and watched over it until the plain pods are bound; with
``trace_pods`` it then reads the span ring off ``/debug/trace``, whose
chains ``audit_trace`` checks.  ``run_config5_durable`` is the same
process over a ``file://`` WAL, SIGKILLed mid-run as a child and
recovered in this process, where the recovered engine binds the rest.
``run_config5_remote`` schedules config 5 over the wire through a
SIGKILL and restart of the API server, and ``run_config5_replicated``
through a SIGKILL of the leader of a three-replica plane
(``controlplane/replproc``), the engine's ``RemoteClient`` finding the
new leader on its own.
``count_grpc_binds`` is an external gRPC watcher, the body of a process
of its own, for a run's ``after_setup``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from minisched_tpu_torch.api.objects import gang_key, make_node, make_pod
from minisched_tpu_torch.controlplane.client import Client
from minisched_tpu_torch.engine.device_scheduler import DeviceScheduler
from minisched_tpu_torch.fullchain import (
    C5_MAX_SKEW,
    C5_REQUESTS,
    c5_spread_pod,
    mk_c5_cluster,
    mk_c5_gang_cluster,
    mk_mixed_cluster,
)
from minisched_tpu_torch.observability import annotation
from minisched_tpu_torch.observability import counters, hist
from minisched_tpu_torch.observability.profiling import CycleMetrics
from minisched_tpu_torch.service.config import (
    default_full_roster_config,
    gang_roster_config,
)
from minisched_tpu_torch.service.service import SchedulerService

#: the engine's phases ``bench.py`` prints for config 5, in its order
SPLIT = ("loop_pop", "wave", "wave_snapshot", "wave_build_tables",
         "wave_build_constraints", "wave_device", "wave_winners", "bind",
         "loop_gc")
#: the pipeline's and the scan lanes' phases, reported beside ``SPLIT``
#: (``wave_place``: the pipelined wave's tables copied to the card;
#: ``wave_pipeline_build``: the worker's whole build of a wave)
SPLIT_MORE = ("wave_place", "wave_pipeline_stall", "wave_pipeline_build",
              "scan_flush", "scan_grouping", "scan_build", "scan_evaluate")
#: the engine's counters a live run reports
COUNTERS = ("wave_pipeline.waves", "wave_pipeline.rearb_requeued",
            "wave_pipeline.build_fallback", "wave_build.skipped",
            "wave_build.full", "wave_build.dirty_rows", "wave_mesh.waves",
            "wave_mesh.fallbacks", "wave_mesh.pad_pod_rows",
            "wave_mesh.pad_node_rows")
#: assume-lease TTL of the live runs: at quiesce the last wave's
#: assumptions drain when their leases run out (``bench.py`` ``bench_gang``
#: sets the same)
QUIESCE_TTL_S = 3.0
#: a preemptor of the burst: 4 CPU and 1 Gi at priority 100
BURST_CPU_M = 4_000
BURST_PRIORITY = 100


def closed_waves(metrics: CycleMetrics, timeout_s: float, sched: Any) -> int:
    """The engine's wave count once every wave begun has closed.  A wave
    observes ``wave_size`` as it starts and ``wave`` as it ends, after its
    binds, so a count read as the last pod binds can miss that pod's
    wave."""
    def counts() -> Tuple[int, int]:
        snap = metrics.snapshot()
        return (int(snap.get("wave_size", {}).get("count", 0)),
                int(snap.get("wave", {}).get("count", 0)))

    wait_until(lambda: len(set(counts())) == 1, timeout_s,
               "every wave begun to close", sched)
    return counts()[1]


def wait_until(pred, timeout_s: float, what: str, sched: Any) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        if sched.loop_errors:
            raise AssertionError(f"{what}: the engine loop raised: "
                                 f"{sched.last_loop_error!r}")
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}: queue "
                         f"{sched.queue.stats()}, loop errors "
                         f"{sched.loop_errors}")


class BindCounter:
    """``on_decision`` hook counting binds (installed before the loop),
    with the monotonic time of the last."""

    def __init__(self) -> None:
        self.n = 0
        self.last_t = 0.0
        self._mu = threading.Lock()

    def __call__(self, pod, node_name, status) -> None:
        if node_name:
            with self._mu:
                self.n += 1
                self.last_t = time.monotonic()

    def count(self) -> int:
        with self._mu:
            return self.n


def split(metrics: CycleMetrics) -> Dict[str, float]:
    """Seconds in each of the engine phases of ``SPLIT`` and
    ``SPLIT_MORE``."""
    snap = metrics.snapshot()
    return {name: snap.get(name, {}).get("total_s", 0.0)
            for name in SPLIT + SPLIT_MORE}


def label_sample(n_nodes: int, n_special: int,
                 open_nodes: Sequence[str]) -> List[str]:
    """The nodes ``bench.py`` labels: ``random.Random(55)`` after its
    cordon draws, one per parked pod."""
    rng = random.Random(55)
    for _ in range(n_nodes):
        rng.random()
    return rng.sample(list(open_nodes), min(len(open_nodes), n_special))


@dataclass
class LiveRun:
    client: Client
    nodes: List[Any]
    #: the pods as the store holds them before the engine starts (with
    #: their uids), in store order: the order the engine's queue gets them
    pods: List[Any]
    #: pod name → node after the first drain ('' = parked)
    first_drain: Dict[str, str]
    setup_s: float
    start_s: float  # service start: informer sync and evaluator build
    first_drain_s: float
    label_loop_s: float
    bound_wait_s: float
    total_s: float
    waves: int
    split: Dict[str, float]
    loop_errors: int
    assumed_left: int
    labelled: List[str] = field(default_factory=list)
    #: ``sched.time_to_bind_s`` bucket upper bounds, seconds
    ttb_p50_le_s: Optional[float] = None
    ttb_p99_le_s: Optional[float] = None
    #: the engine's ``scan_stats`` (the exact and blocked lanes) and its
    #: ``COUNTERS`` over the run
    scan_stats: Dict[str, Any] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    pipelined: bool = True
    burst: Optional["BurstRun"] = None


@dataclass
class BurstRun:
    """A preemption burst after config 5 is bound (``preempt_burst``)."""

    #: the most CPU (millicores) any schedulable node had free after
    #: config 5, the ``fill*`` pods that topped nodes up, and the most
    #: free after them
    max_free_cpu_m: int
    fillers: int
    max_free_filled_cpu_m: int
    #: first create to last bind, seconds
    wall_s: float
    waves: int
    #: PostFilter passes and their seconds
    passes: int
    post_filter_s: float
    #: the wave-loser pass: its seconds and the preemption-eligible losers
    losers_handle_s: float
    preempt_eligible: int
    #: the pods DefaultPreemption reported in ``last_victims``, and the
    #: pods gone from the store, name → priority before the burst
    reported: Dict[str, int]
    deleted: Dict[str, int]
    #: pod name → node for every pod after the burst (the preemptors'
    #: included), and the nominations PostFilter returned, pass by pass
    #: (pod name, node or None)
    placements: Dict[str, str]
    nominations: List[Any]


def free_cpu(client: Client) -> Dict[str, int]:
    """CPU (millicores) free on each schedulable node, from the store."""
    used: Dict[str, int] = defaultdict(int)
    for p in client.pods().list():
        if p.spec.node_name:
            used[p.spec.node_name] += p.resource_requests().milli_cpu
    return {n.metadata.name: n.status.allocatable.milli_cpu
            - used[n.metadata.name]
            for n in client.nodes().list() if not n.spec.unschedulable}


def fill_below(client: Client, cpu_m: int) -> int:
    """Bind ``fill*`` pods of config 5's shape (priority 0) onto every
    schedulable node with ``cpu_m`` or more CPU free until it has less.
    Returns how many were created."""
    each = make_pod("fill", requests=C5_REQUESTS).resource_requests().milli_cpu
    fillers = []
    for name, free in sorted(free_cpu(client).items()):
        while free >= cpu_m:
            fillers.append(make_pod(f"fill{len(fillers):06d}",
                                    requests=C5_REQUESTS, node_name=name))
            free -= each
    if fillers:
        client.pods().create_many(fillers, return_objects=False)
    return len(fillers)


def _record_post_filter(sched: Any, reported: List[Any],
                        nominations: List[Any]) -> None:
    """Wrap each PostFilter plugin so every victim it reports in
    ``last_victims`` is also appended to ``reported`` (the engine's loser
    pass consumes and clears the plugin's list), and each nomination it
    returns to ``nominations`` (a bind clears the pod's own)."""
    for pl in sched.post_filter_plugins:
        def recorded(state, pod, node_infos, diagnosis, _pl=pl,
                     _orig=pl.post_filter):
            out = _orig(state, pod, node_infos, diagnosis)
            reported.extend(getattr(_pl, "last_victims", ()))
            nominations.append((pod.metadata.name, out[0]))
            return out

        pl.post_filter = recorded


def _metric(metrics: CycleMetrics, name: str) -> Dict[str, float]:
    snap = metrics.snapshot().get(name, {})
    return {"count": snap.get("count", 0), "total_s": snap.get("total_s", 0.0)}


def _run_burst(client: Client, sched: Any, metrics: CycleMetrics,
               bound: BindCounter, n_burst: int, timeout_s: float,
               before_burst: Optional[Callable[[], None]]) -> BurstRun:
    free = max(free_cpu(client).values())
    n0 = bound.count()
    fillers = fill_below(client, BURST_CPU_M)
    filled = max(free_cpu(client).values())
    if filled >= BURST_CPU_M:
        raise AssertionError(f"preemption burst: a schedulable node has "
                             f"{filled}m CPU free, a preemptor would fit")
    pods = client.pods().list()
    on_nodes = sum(1 for p in pods if p.spec.node_name)
    # the engine's cache holds the fillers before the preemptors arrive
    wait_until(lambda: sched.cache.assigned_count() >= on_nodes, timeout_s,
               f"{fillers} fill pods in the engine's cache", sched)
    before = {p.metadata.name: p.spec.priority for p in pods}
    reported: List[Any] = []
    nominations: List[Any] = []
    _record_post_filter(sched, reported, nominations)
    names = ("wave", "post_filter", "losers_handle", "wave_preempt_eligible")
    m0 = {k: _metric(metrics, k) for k in names}
    highs = [make_pod(f"high{i:03d}", requests={
        "cpu": f"{BURST_CPU_M}m", "memory": "1Gi"}, priority=BURST_PRIORITY)
        for i in range(n_burst)]
    if before_burst is not None:
        before_burst()
    t0 = time.monotonic()
    client.pods().create_many(highs, return_objects=False)
    wait_until(lambda: bound.count() >= n0 + n_burst, timeout_s,
               f"{n_burst} preemptors bound", sched)
    wall_s = bound.last_t - t0
    m1 = {k: _metric(metrics, k) for k in names}
    d = {k: {f: m1[k][f] - m0[k][f] for f in ("count", "total_s")}
         for k in names}
    pods = client.pods().list()
    left = {p.metadata.name for p in pods}
    return BurstRun(
        free, fillers, filled, wall_s, int(d["wave"]["count"]), int(d["post_filter"]["count"]),
        d["post_filter"]["total_s"], d["losers_handle"]["total_s"],
        int(round(d["wave_preempt_eligible"]["total_s"])),
        {v.metadata.name: v.spec.priority for v in reported},
        {k: v for k, v in before.items() if k not in left},
        {p.metadata.name: p.spec.node_name for p in pods}, nominations)


def run_config5_live(n_nodes: int = 10_000, n_pods: int = 100_000,
                     max_wave: int = 16_384, device: Any = None,
                     timeout_s: float = 900.0, n_crosspod: int = 0,
                     pipeline: bool = True, preempt_burst: int = 0,
                     before_burst: Optional[Callable[[], None]] = None,
                     after_setup: Optional[Callable[[Client], None]] = None,
                     mesh: Any = None) -> LiveRun:
    """Config 5 (with ``n_crosspod`` spread pods) through the live engine,
    park and requeue included; ``pipeline=False`` runs the serial loop.
    ``preempt_burst`` preemptors follow once every pod is bound
    (``LiveRun.burst``); ``before_burst`` is called just before they are
    created (the run's other fields stop there).  ``after_setup`` is
    called with the client once the cluster is in the store, just before
    the engine starts (a watch opened there sees every bind).  ``mesh``:
    the engine's ``device_mesh`` (a ``parallel.sharding.Mesh``)."""
    nodes, pods = mk_c5_cluster(n_nodes, n_pods, n_crosspod=n_crosspod)
    n_special = sum(p.metadata.name.startswith("special") for p in pods)
    client = Client()
    t0 = time.monotonic()
    client.nodes().create_many(nodes, return_objects=False)
    client.pods().create_many(pods, return_objects=False)
    stored = client.pods().list()
    setup_s = time.monotonic() - t0
    hist.reset()
    counters.reset()
    if after_setup is not None:
        after_setup(client)
    svc = SchedulerService(client)
    metrics, bound = CycleMetrics(), BindCounter()
    t0 = time.monotonic()
    sched = svc.start_scheduler(default_full_roster_config(),
                                device_mode=True, max_wave=max_wave,
                                on_decision=bound, metrics=metrics,
                                device=device, prewarm_scan=n_crosspod > 0,
                                pipeline=pipeline, device_mesh=mesh)
    sched.assume_ttl_s = QUIESCE_TTL_S
    t_loop = time.monotonic()
    try:
        wait_until(lambda: bound.count() >= n_pods - n_special
                   and sched.queue.stats()["unschedulable"] == n_special,
                   timeout_s, f"{n_pods - n_special} bound and {n_special} "
                   "parked", sched)
        first_drain_s = time.monotonic() - t_loop
        first = {p.metadata.name: p.spec.node_name
                 for p in client.pods().list()}
        open_nodes = [n.metadata.name for n in nodes
                      if not n.spec.unschedulable]
        labelled = label_sample(n_nodes, n_special, open_nodes)
        t1 = time.monotonic()
        for name in labelled:
            node = client.nodes().get(name)
            node.metadata.labels["special"] = "true"
            client.nodes().update(node)
        label_loop_s = time.monotonic() - t1
        t1 = time.monotonic()
        wait_until(lambda: bound.count() >= n_pods, timeout_s,
                   f"all {n_pods} bound", sched)
        bound_wait_s = time.monotonic() - t1
        total_s = time.monotonic() - t_loop
        waves = closed_waves(metrics, timeout_s, sched)
        phases = split(metrics)
        wait_until(lambda: sched.assumed_count() == 0,
                   QUIESCE_TTL_S * 20, "the assume cache to drain", sched)
        p50 = hist.quantile_bounds("sched.time_to_bind_s", 0.5)
        p99 = hist.quantile_bounds("sched.time_to_bind_s", 0.99)
        scan_stats = dict(sched.scan_stats)
        counts = {name: counters.get(name) for name in COUNTERS}
        burst = None
        if preempt_burst:
            burst = _run_burst(client, sched, metrics, bound, preempt_burst,
                               timeout_s, before_burst)
            wait_until(lambda: sched.assumed_count() == 0,
                       QUIESCE_TTL_S * 20, "the assume cache to drain",
                       sched)
    finally:
        svc.close()
    return LiveRun(client, nodes, stored, first, setup_s, t_loop - t0,
                   first_drain_s, label_loop_s, bound_wait_s, total_s,
                   int(waves), phases, sched.loop_errors,
                   sched.assumed_count(), labelled,
                   p50[1] if p50 else None, p99[1] if p99 else None,
                   scan_stats, counts, sched.pipeline_enabled, burst)


@dataclass
class MeshLadderRun:
    """``run_mesh_ladder``'s outcome."""

    #: pod name → node, every pod of both batches
    placements: Dict[str, str]
    fires: int  # ``mesh.evaluate`` fires
    #: the engine's ``wave_mesh.*`` counters after each batch
    after_first: Dict[str, int]
    after_second: Dict[str, int]
    loop_errors: int
    wall_s: float


def run_mesh_ladder(mesh: Any, n_nodes: int = 40, n_pods: int = 30,
                    device: Any = None, timeout_s: float = 300.0
                    ) -> MeshLadderRun:
    """JAX's ``test_mesh_sharding_failure_falls_back_per_wave``
    (``tests/test_mesh_live.py:199``) as a run: a mesh engine with the
    ``mesh.evaluate`` point armed once (seed 1234, rate 1), waves of 64;
    ``n_pods`` pods of 100m, then as many again once they are bound.  The
    first batch's wave falls back to the single-device evaluator; the
    second batch's waves are sharded.  The roster is the full default one
    (the engine's default): JAX's test runs the reference's NodeNumber
    chain, whose Permit holds each pod up to its node's number of seconds
    (and, time-scaled down, can time a pod out and park it until the next
    flush, which would add a wave)."""
    from minisched_tpu_torch.faults import FaultFabric

    rng = random.Random(11)
    nodes = [make_node(f"node{i:03d}", unschedulable=rng.random() < 0.2,
                       capacity={"cpu": "16", "memory": "32Gi", "pods": 64})
             for i in range(n_nodes)]
    batches = [[make_pod(f"{tag}{i:03d}", requests={"cpu": "100m"})
                for i in range(n_pods)] for tag in ("a", "b")]
    fabric = FaultFabric(1234).on("mesh.evaluate", rate=1.0, max_fires=1)
    client = Client()
    client.nodes().create_many(nodes, return_objects=False)
    counters.reset()
    names = ("wave_mesh.waves", "wave_mesh.fallbacks")
    svc = SchedulerService(client)
    t0 = time.monotonic()
    sched = svc.start_scheduler(default_full_roster_config(),
                                device_mode=True, max_wave=64, device=device,
                                device_mesh=mesh, prewarm_scan=False)
    sched.faults = fabric
    after = []
    try:
        for k, batch in enumerate(batches):
            client.pods().create_many(batch, return_objects=False)
            want = n_pods * (k + 1)
            wait_until(lambda: sum(1 for p in client.pods().list()
                                   if p.spec.node_name) >= want,
                       timeout_s, f"{want} bound", sched)
            after.append({name: counters.get(name) for name in names})
    finally:
        svc.close()
    return MeshLadderRun(
        {p.metadata.name: p.spec.node_name for p in client.pods().list()},
        fabric.fires("mesh.evaluate"), after[0], after[1],
        sched.loop_errors, time.monotonic() - t0)


def audit_store(client: Client,
                labelled: Optional[Sequence[str]] = None,
                pods: Optional[List[Any]] = None) -> Dict[str, int]:
    """Config 5's audit from the store's final state: no node over its
    allocatable CPU, memory or pod count, no pod on a cordoned node, and
    (given ``labelled``) every ``special*`` pod bound on one of those
    nodes.  ``pods``: a listing the caller already took.  Returns the
    bound and node counts."""
    cpu: Dict[str, int] = defaultdict(int)
    mem: Dict[str, int] = defaultdict(int)
    cnt: Dict[str, int] = defaultdict(int)
    pods = client.pods().list() if pods is None else pods
    for p in pods:
        if p.spec.node_name:
            r = p.resource_requests()
            cpu[p.spec.node_name] += r.milli_cpu
            mem[p.spec.node_name] += r.memory
            cnt[p.spec.node_name] += 1
    nodes = client.nodes().list()
    for node in nodes:
        name, alloc = node.metadata.name, node.status.allocatable
        if (cpu[name] > alloc.milli_cpu or mem[name] > alloc.memory
                or cnt[name] > alloc.pods):
            raise AssertionError(f"audit: {name} over its allocatable")
        if cnt[name] and node.spec.unschedulable:
            raise AssertionError(f"audit: pods on cordoned node {name}")
    special_ok = set(labelled or ())
    misplaced = [p.metadata.name for p in pods
                 if p.metadata.name.startswith("special")
                 and p.spec.node_name not in special_ok]
    if labelled is not None and misplaced:
        raise AssertionError(f"audit: special pods off the labelled nodes: "
                             f"{misplaced[:5]}")
    return {"bound": sum(cnt.values()), "nodes": len(nodes)}


@dataclass
class DrainRun:
    client: Client
    #: pod name → node for every pod ('' = parked), the lone pod included
    placements: Dict[str, str]
    waves: int
    wall_s: float
    loop_errors: int
    scan_stats: Dict[str, Any]
    pipelined: bool


def run_crosspod_drain(n_nodes: int, n_pods: int, n_crosspod: int,
                       max_wave: int = 4_096, device: Any = None,
                       pipeline: bool = False,
                       timeout_s: float = 900.0) -> DrainRun:
    """Config 5 with ``n_crosspod`` spread pods through the live engine to
    the end of its first drain (the ``special*`` pods parked, no label
    update), then one more spread pod, ``lone``, created alone, so its
    flush takes the exact scan.  On the serial engine every binding
    follows from the store order: two runs on two devices bind alike."""
    nodes, pods = mk_c5_cluster(n_nodes, n_pods, n_crosspod=n_crosspod)
    n_special = sum(p.metadata.name.startswith("special") for p in pods)
    client = Client()
    client.nodes().create_many(nodes, return_objects=False)
    client.pods().create_many(pods, return_objects=False)
    svc = SchedulerService(client)
    metrics, bound = CycleMetrics(), BindCounter()
    t0 = time.monotonic()
    sched = svc.start_scheduler(default_full_roster_config(),
                                device_mode=True, max_wave=max_wave,
                                on_decision=bound, metrics=metrics,
                                device=device, pipeline=pipeline)
    sched.assume_ttl_s = QUIESCE_TTL_S
    try:
        wait_until(lambda: bound.count() >= n_pods - n_special
                   and sched.queue.stats()["unschedulable"] == n_special,
                   timeout_s, f"{n_pods - n_special} bound", sched)
        client.pods().create(c5_spread_pod("lone", "app0"))
        wait_until(lambda: bound.count() > n_pods - n_special, timeout_s,
                   "the lone spread pod bound", sched)
        wall_s = time.monotonic() - t0
        waves = metrics.snapshot().get("wave", {}).get("count", 0)
    finally:
        svc.close()
    return DrainRun(client, {p.metadata.name: p.spec.node_name
                             for p in client.pods().list()},
                    int(waves), wall_s, sched.loop_errors,
                    dict(sched.scan_stats), sched.pipeline_enabled)


def audit_spread(client: Client, max_skew: int = C5_MAX_SKEW,
                 prefix: str = "spread") -> int:
    """``bench.py``'s spread audit from the store's final state: per app
    of the ``prefix*`` pods, the pods in each zone that has a schedulable
    node differ by at most ``max_skew`` (a cordoned-only zone stays at
    0).  Returns the apps audited."""
    zone_of, eligible = {}, set()
    for n in client.nodes().list():
        zone = n.metadata.labels.get("zone")
        zone_of[n.metadata.name] = zone
        if zone and not n.spec.unschedulable:
            eligible.add(zone)
    per_app: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for p in client.pods().list():
        if p.metadata.name.startswith(prefix):
            per_app[p.metadata.labels.get("app")][
                zone_of.get(p.spec.node_name)] += 1
    zones = sorted(eligible)
    bad = [(app, [by_zone.get(z, 0) for z in zones])
           for app, by_zone in per_app.items()
           if max(by_zone.get(z, 0) for z in zones)
           - min(by_zone.get(z, 0) for z in zones) > max_skew]
    if bad:
        raise AssertionError(f"spread audit: skew above {max_skew}: "
                             f"{bad[:3]}")
    return len(per_app)


@dataclass
class GangRun:
    client: Client
    nodes: List[Any]
    assigned: List[Any]
    pods: List[Any]
    wall_s: float
    bound: int
    gangs: int
    loop_errors: int
    assumed_left: int
    pending_gangs: Dict[str, int]
    split: Dict[str, float]


def run_gang_live(n_nodes: int, n_pods: int, n_gangs: int,
                  max_wave: int = 4_096, device: Any = None,
                  timeout_s: float = 600.0) -> GangRun:
    """``mk_c5_gang_cluster`` through the live engine with
    ``gang_roster_config``: the assigned members are created bound, the
    pending pods in the cluster's order; runs until every pod but the
    ``special*`` ones is bound, then until the assume cache drains."""
    nodes, assigned, pods = mk_c5_gang_cluster(n_nodes, n_pods,
                                               n_gangs=n_gangs)
    n_special = sum(p.metadata.name.startswith("special") for p in pods)
    client = Client()
    client.nodes().create_many(nodes, return_objects=False)
    client.pods().create_many(assigned + pods, return_objects=False)
    svc = SchedulerService(client)
    metrics, bound = CycleMetrics(), BindCounter()
    t0 = time.monotonic()
    sched = svc.start_scheduler(gang_roster_config(), device_mode=True,
                                max_wave=max_wave, on_decision=bound,
                                metrics=metrics, device=device)
    sched.assume_ttl_s = QUIESCE_TTL_S
    cosched = next(p for p in sched.permit_plugins
                   if p.name() == "Coscheduling")
    try:
        wait_until(lambda: bound.count() >= len(pods) - n_special
                   and sched.queue.stats()["unschedulable"] == n_special,
                   timeout_s, f"{len(pods) - n_special} bound", sched)
        wall_s = time.monotonic() - t0
        wait_until(lambda: sched.assumed_count() == 0
                   and not cosched.pending_gangs(),
                   QUIESCE_TTL_S * 20, "quiesce", sched)
        phases = split(metrics)
    finally:
        svc.close()
    return GangRun(client, nodes, assigned, pods, wall_s, bound.count(),
                   n_gangs, sched.loop_errors, sched.assumed_count(),
                   cosched.pending_gangs(), phases)


def audit_gangs(client: Client) -> Dict[str, int]:
    """Every gang fully bound, none partly (``bench.py`` ``bench_gang``'s
    audit), plus ``audit_store``'s capacity rules.  Returns the gang
    count."""
    members: Dict[str, List[bool]] = defaultdict(list)
    for p in client.pods().list():
        key = gang_key(p)
        if key is not None:
            members[key].append(bool(p.spec.node_name))
    partial = [k for k, v in members.items() if any(v) and not all(v)]
    if partial:
        raise AssertionError(f"gang audit: partly bound gangs {partial[:5]}")
    unplaced = [k for k, v in members.items() if not any(v)]
    if unplaced:
        raise AssertionError(f"gang audit: gangs never placed {unplaced[:5]}")
    audit_store(client)
    return {"gangs": len(members)}


def store_choices(client: Client, nodes: Sequence[Any],
                  pods: Sequence[Any]) -> List[int]:
    """Each of ``pods``' node row in ``nodes`` from the store (-1 when
    unbound), for ``audit.one_slice_share``."""
    row = {n.metadata.name: i for i, n in enumerate(nodes)}
    where = {p.metadata.key: p.spec.node_name for p in client.pods().list()}
    return [row.get(where.get(p.metadata.key) or "", -1) for p in pods]


# -- record_results on the mixed cluster ------------------------------------


@dataclass
class RecordRun:
    client: Client
    #: pod name → node ('' = parked), the pending pods only
    placements: Dict[str, str]
    #: pod name → the three annotations parsed (None where absent)
    annotations: Dict[str, tuple]
    #: keys of the pods some ``_record_wave`` call carried
    recorded: set
    #: keys of the pods in some blocked-lane chunk
    blocked: set
    record_calls: int
    waves: int
    wall_s: float
    #: seconds in the record's evaluations and in its host ingest
    record_evaluate_s: float
    record_ingest_s: float
    annotation_bytes: int
    loop_errors: int
    record_errors: int
    scan_stats: Dict[str, Any]


@contextlib.contextmanager
def _lane_log():
    """For the engines running inside the block: the pods each record
    call carried and the pods of each blocked-lane chunk (the engine
    methods wrapped at class level, restored on exit)."""
    log = {"recorded": set(), "calls": 0, "blocked": set()}
    orig_record = DeviceScheduler._record_wave
    orig_chunk = DeviceScheduler._run_blocked_chunk

    def record(self, pods_, *args):
        log["calls"] += 1
        log["recorded"].update(p.metadata.key for p in pods_)
        return orig_record(self, pods_, *args)

    def chunk(self, part, *args):
        log["blocked"].update(q.pod.metadata.key for q in part
                              if q is not None)
        return orig_chunk(self, part, *args)

    DeviceScheduler._record_wave = record
    DeviceScheduler._run_blocked_chunk = chunk
    try:
        yield log
    finally:
        DeviceScheduler._record_wave = orig_record
        DeviceScheduler._run_blocked_chunk = orig_chunk


def _parsed_annotations(pod: Any) -> tuple:
    ann = pod.metadata.annotations
    return tuple(json.loads(ann[k]) if k in ann else None
                 for k in (annotation.FILTER_RESULT, annotation.SCORE_RESULT,
                           annotation.FINAL_SCORE_RESULT))


def run_mixed_recorded(n_nodes: int, n_pods: int, max_wave: int = 128,
                       device: Any = None, record: bool = True,
                       timeout_s: float = 900.0) -> RecordRun:
    """The mixed cluster through the serial engine with the full roster
    and (``record``) ``record_results``, to the end of its first drain:
    every pending pod bound or parked and, with ``record``, every bound
    pod's record flushed.  Pods carry explicit uids and the store's order
    fixes the waves, so two runs on two devices bind alike."""
    nodes, assigned, pods, pvcs, pvs = mk_mixed_cluster(n_nodes, n_pods)
    client = Client()
    for pvc in pvcs:
        client.store.create("PersistentVolumeClaim", pvc)
    for pv in pvs:
        client.store.create("PersistentVolume", pv)
    client.nodes().create_many(nodes, return_objects=False)
    for i, p in enumerate(assigned):
        p.metadata.uid = f"assigned-{i:08d}"
    for i, p in enumerate(pods):
        p.metadata.uid = f"pod-{i:08d}"
    client.pods().create_many(assigned + pods, return_objects=False)
    keys = {p.metadata.key for p in pods}
    svc = SchedulerService(client)
    metrics = CycleMetrics()
    with _lane_log() as log:
        t0 = time.monotonic()
        sched = svc.start_scheduler(
            default_full_roster_config(), record_results=record,
            device_mode=True, max_wave=max_wave, metrics=metrics,
            device=device, pipeline=False)
        sched.assume_ttl_s = QUIESCE_TTL_S

        def settled() -> bool:
            st = sched.queue.stats()
            mine = [p for p in client.pods().list()
                    if p.metadata.key in keys]
            bound = [p for p in mine if p.spec.node_name]
            flushed = not record or all(
                not svc.result_store.has_data(p.metadata.key)
                for p in bound)
            return (st["active"] == 0 and st["backoff"] == 0
                    and not sched._scan_backlog and flushed
                    and len(bound) + st["unschedulable"] == len(mine))

        try:
            wait_until(settled, timeout_s, f"{n_pods} pods settled", sched)
            wall_s = time.monotonic() - t0
            snap = metrics.snapshot()
        finally:
            svc.close()
    mine = [p for p in client.pods().list() if p.metadata.key in keys]
    ann_bytes = sum(len(p.metadata.annotations.get(k, ""))
                    for p in mine for k in (annotation.FILTER_RESULT,
                                            annotation.SCORE_RESULT,
                                            annotation.FINAL_SCORE_RESULT))
    return RecordRun(
        client, {p.metadata.name: p.spec.node_name for p in mine},
        {p.metadata.name: _parsed_annotations(p) for p in mine},
        log["recorded"], log["blocked"], log["calls"],
        int(snap.get("wave", {}).get("count", 0)), wall_s,
        snap.get("record_evaluate", {}).get("total_s", 0.0),
        snap.get("record_ingest", {}).get("total_s", 0.0), ann_bytes,
        sched.loop_errors, sched.record_errors, dict(sched.scan_stats))


def audit_records(run: RecordRun) -> Dict[str, int]:
    """Every bound pod carries a record exactly when some record call (a
    wave, an exact-scan chunk) carried it; a bound pod without one was in
    a blocked-lane chunk (the blocked lane records nothing, as in JAX).
    Returns the counts."""
    with_rec = without = 0
    for name, node in run.placements.items():
        if not node:
            continue
        key = f"default/{name}"
        has = run.annotations[name][0] is not None
        if has != (key in run.recorded):
            raise AssertionError(f"record audit: {key} record {has}, "
                                 f"recorded {key in run.recorded}")
        if not has and key not in run.blocked:
            raise AssertionError(f"record audit: {key} bound without a "
                                 f"record outside the blocked lane")
        with_rec += has
        without += not has
    return {"with_record": with_rec, "without_record": without}


# -- the standalone process, config 5 over HTTP -----------------------------


@dataclass
class HttpRun:
    n_plain: int  # the pods awaited: config 5's plain ones
    bound: int
    #: first create request to the last create's answer
    create_s: float
    #: first create request to the watch's last awaited bind
    bind_s: float
    setup_s: float  # ``__main__.start``: façade, PV controller, engine
    waves: int
    loop_errors: int
    #: the parsed ``/metrics`` scrape: (types, samples)
    metrics: tuple
    audit: Dict[str, int]
    threads_left: List[str]
    watch_events: int
    #: seconds: the engine's phases (``split``), the façade's handlers by
    #: verb and route shape (from ``/metrics``), the test watch's JSON
    #: decode on its own thread, and the audit's HTTP list
    split: Dict[str, float]
    handler_s: Dict[str, float]
    watch_decode_s: float
    list_s: float
    #: ``trace_pods`` created after config 5 bound: their names, and the
    #: spans ``GET /debug/trace`` answered once they were seen bound
    trace_pods: List[str]
    trace: List[Dict[str, Any]]
    #: the test watch's resumes after an eviction, and of them relists
    watch_reconnects: int = 0
    watch_relists: int = 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class PodWatch:
    """An HTTP watch on every pod, read on a thread: the names seen bound,
    the node each was first seen bound to, and the monotonic time of the
    last first-seen bind and of the first bind after the SYNC line's rv
    (a live one, not the snapshot replay's).

    A stream that ends while the server still answers (the store's queue
    bound or the stream loop's out-buffer bound evicted this slow reader)
    is resumed from the last rv seen, or on 410 relisted and resumed from
    the list's rv, as an informer would: ``reconnects`` and ``relists``
    count them.  ``error`` is set when the server no longer answers."""

    def __init__(self, base: str):
        self.base = base
        self.bound: set = set()
        self.nodes: Dict[str, str] = {}
        self.events = 0
        self.decode_s = 0.0
        self.last_bind_t = 0.0
        self.first_live_bind_t = 0.0
        #: the monotonic time each first-seen bind was seen, in order
        self.bind_times: List[float] = []
        self.reconnects = 0
        self.relists = 0
        self.error: Optional[BaseException] = None
        self._closing = False
        self.start_rv = self._open(None)
        self._thread = threading.Thread(target=self._read, daemon=True,
                                        name="http-pod-watch")
        self._thread.start()

    def _open(self, resume_rv: Optional[int]) -> int:
        """Open the stream (resuming after ``resume_rv``); the SYNC rv."""
        path = self.base + "/api/v1/namespaces/default/pods?watch=true"
        if resume_rv is not None:
            path += f"&resource_version={resume_rv}"
        self._resp = urllib.request.urlopen(path, timeout=600)
        first = json.loads(self._resp.readline())
        if first.get("type") != "SYNC":
            raise AssertionError(f"watch: first line {first}")
        self.rv = int(first.get("rv", 0))
        return self.rv

    def _seen(self, obj: Dict[str, Any], rv: int) -> None:
        if obj["spec"]["node_name"]:
            name = obj["metadata"]["name"]
            if name not in self.bound:
                self.nodes[name] = obj["spec"]["node_name"]
                self.bound.add(name)
                self.last_bind_t = time.monotonic()
                self.bind_times.append(self.last_bind_t)
                if not self.first_live_bind_t and rv > self.start_rv:
                    self.first_live_bind_t = self.last_bind_t

    def _read(self) -> None:
        while True:
            ended: Optional[BaseException] = None
            try:
                for line in self._resp:
                    if not line.strip():
                        continue  # keepalive
                    t0 = time.monotonic()
                    ev = json.loads(line)
                    self.decode_s += time.monotonic() - t0
                    self.events += 1
                    rv = int(ev.get("rv", 0))
                    self.rv = max(self.rv, rv)
                    self._seen(ev["object"], rv)
            except Exception as err:  # evicted, or the server died
                ended = err
            if self._closing:
                return
            try:
                try:
                    self._open(self.rv)
                except urllib.error.HTTPError as err:
                    if err.code != 410:
                        raise
                    with urllib.request.urlopen(
                            self.base + "/api/v1/namespaces/default/pods",
                            timeout=600) as r:
                        listed = json.loads(r.read())
                    for obj in listed["items"]:
                        self._seen(obj, 0)
                    self.relists += 1
                    self._open(int(listed["resource_version"]))
                self.reconnects += 1
            except Exception as err:  # the server no longer answers
                self.error = ended or err
                return

    def join(self) -> None:
        """Wait for the stream's end (the server's shutdown ends it)."""
        self._closing = True
        self._resp.close()
        self._thread.join(timeout=30)


def run_config5_http(n_nodes: int = 10_000, n_pods: int = 100_000,
                     device: Any = None, chunk: int = 10_000,
                     timeout_s: float = 900.0,
                     trace_pods: int = 0) -> HttpRun:
    """``__main__.start`` on a free port (the device engine, its defaults),
    an HTTP watch on the pods opened first, then config 5 created over
    HTTP in batch creates of ``chunk`` objects; done when the watch has
    seen every plain pod bound (the ``special*`` pods park: no node
    carries their label).  Then one HTTP list audited by
    ``audit_store``'s rules and one ``/metrics`` scrape.  The
    process-global counters and histograms are reset first.  With
    ``trace_pods``, that many more pods (``trace-*``) are created over
    HTTP once config 5 is bound, and when the watch has seen them bound
    the span ring is read off ``GET /debug/trace``: their whole chains
    fit in the ring, where config 5's enqueues were evicted long ago."""
    from minisched_tpu_torch.__main__ import start
    from minisched_tpu_torch.controlplane.httpserver import HTTPClient
    from minisched_tpu_torch.service.config import ProcessConfig

    nodes, pods = mk_c5_cluster(n_nodes, n_pods)
    n_plain = sum(not p.metadata.name.startswith("special") for p in pods)
    hist.reset()
    counters.reset()
    before = set(threading.enumerate())
    t0 = time.monotonic()
    _client, base, stop = start(ProcessConfig(port=free_port(),
                                              frontend_url="http://x"),
                                device_mode=True, device=device)
    setup_s = time.monotonic() - t0
    sched = stop.service.scheduler
    metrics = sched.metrics = CycleMetrics()  # the loop idles until pods come
    watch = None
    try:
        http = HTTPClient(base)
        watch = PodWatch(base)
        t_first = time.monotonic()
        for i in range(0, len(nodes), chunk):
            http.nodes().create_many(nodes[i:i + chunk],
                                     return_objects=False)
        for i in range(0, len(pods), chunk):
            http.pods().create_many(pods[i:i + chunk], return_objects=False)
        create_s = time.monotonic() - t_first
        wait_until(lambda: len(watch.bound) >= n_plain or watch.error,
                   timeout_s, f"{n_plain} pods seen bound over the watch",
                   sched)
        if watch.error is not None:
            raise AssertionError(f"the pod watch failed: {watch.error!r}")
        bind_s = watch.last_bind_t - t_first
        phases = split(metrics)
        waves = metrics.snapshot().get("wave", {}).get("count", 0)
        t1 = time.monotonic()
        audited = audit_store(http)
        list_s = time.monotonic() - t1
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            scraped = hist.parse_prometheus(r.read().decode())
        probes = [make_pod(f"trace-{i:04d}", requests={"cpu": "500m",
                                                      "memory": "256Mi"})
                  for i in range(trace_pods)]
        spans: List[Dict[str, Any]] = []
        if probes:
            http.pods().create_many(probes, return_objects=False)
            names = {p.metadata.name for p in probes}
            wait_until(lambda: names <= watch.bound or watch.error,
                       timeout_s, f"{trace_pods} trace pods seen bound",
                       sched)
            with urllib.request.urlopen(base + "/debug/trace",
                                        timeout=60) as r:
                spans = [json.loads(line)
                         for line in r.read().decode().splitlines()]
    finally:
        stop()
        if watch is not None:
            watch.join()
    left = sorted(t.name for t in set(threading.enumerate()) - before
                  if t.is_alive() and not t.daemon)
    handler_s: Dict[str, float] = defaultdict(float)
    for name, labels, val in scraped[1]:
        if name == "http_request_seconds_sum":
            handler_s[f"{labels['verb']} {labels['route']}"] += val
    seen = len(watch.bound - {p.metadata.name for p in probes})
    return HttpRun(n_plain, seen, create_s, bind_s, setup_s,
                   int(waves), sched.loop_errors, scraped, audited, left,
                   watch.events, phases, dict(handler_s), watch.decode_s,
                   list_s, [p.metadata.name for p in probes], spans,
                   watch.reconnects, watch.relists)


@dataclass
class DurableRun:
    n_plain: int
    #: (a): binds the test watch had seen at the SIGKILL (the kill waits
    #: for ``kill_binds`` of them and for every create's answer), the
    #: seconds from the first create to the kill, and the WAL then
    seen_at_kill: int
    kill_s: float
    create_s: float
    wal_bytes: int
    wal_records: int
    #: (b): the reopen's replay, ``__main__.start`` as a whole (replay,
    #: façade, engine), and from start's return to the last plain bind
    replay_s: float
    boot_s: float
    left_at_boot: int  # plain pods unbound when (b) booted
    bind_s: float
    waves: int
    loop_errors: int
    assumed_left: int
    waiting_left: int
    audit: Dict[str, int]
    #: the group-commit counters of (b): groups and records
    groups: int
    records: int
    compact_s: float
    ckpt_bytes: int
    #: the read-only reopen after stop(): its replay seconds; the objects
    #: and resource_version equal the listing's (else the run raised)
    reopen_s: float
    resource_version: int
    #: ``python -m minisched_tpu_torch fsck <wal>``: exit code, seconds,
    #: and the report's records (WAL) and objects (replayed state)
    fsck_rc: int
    fsck_s: float
    fsck_records: int
    fsck_objects: Dict[str, int]
    threads_left: List[str]
    #: the first life's test watch: resumes after an eviction
    watch_reconnects: int = 0


#: run_config5_durable: the share of the plain pods the recovered engine
#: must find unbound, or the kill did not land mid-run
MIN_LEFT_AT_BOOT = 0.1


def _bound_count(store: Any) -> int:
    """Pods bound in ``store``: the per-node aggregates' pod counts (a
    config-5 pod counts 1), read under the lock without a listing."""
    with store.locked():
        return sum(a[2] for a in store._pod_node_agg.values())


def _state_digest(store: Any) -> Tuple[str, int]:
    """(sha256 of the checkpoint document of every object, the store's
    resource_version), under one lock hold."""
    from minisched_tpu_torch.controlplane.checkpoint import build_snapshot_doc

    with store.locked():
        doc = build_snapshot_doc(store._objects, store.resource_version)
        body = json.dumps(doc, sort_keys=True).encode()
        return hashlib.sha256(body).hexdigest(), store.resource_version


def run_config5_durable(workdir: str, n_nodes: int = 10_000,
                        n_pods: int = 100_000, kill_binds: int = 2_000,
                        device: Any = None, chunk: int = 10_000,
                        timeout_s: float = 900.0,
                        child_env: Optional[Dict[str, str]] = None
                        ) -> DurableRun:
    """Config 5 over a ``file://`` WAL that survives a SIGKILL.

    (a) ``python3 -m minisched_tpu_torch`` as a child with
    ``MINISCHED_TPU_STORE_URL=file://<workdir>/c5.wal`` and its defaults
    otherwise (the device engine on the card, pipelined, waves of 1,024;
    the store with fsync off), plus ``child_env``; an HTTP watch on the
    pods opened first, then config 5 created over HTTP in batch creates
    of ``chunk``.  The child is SIGKILLed as soon as every create was
    answered and the watch has seen ``kill_binds`` binds; the run fails
    if the watch saw every plain pod bound by then, or if the recovered
    store holds fewer than ``MIN_LEFT_AT_BOOT`` of them unbound.

    (b) ``__main__.start(ProcessConfig(external_store_url=<same>))`` in
    this process (``device``: the engine's), which replays the WAL; every
    bind the watch saw must be on the same node; the recovered engine
    binds the rest.  Then: every created object exists, every plain pod
    is bound and no ``special*`` pod is, ``audit_store``'s rules, and the
    engine's assume and Permit ledgers drain.  The scheduler is stopped,
    the store compacted, and the whole state digested; after ``stop()``
    a ``readonly=True`` reopen must digest the same, with the same
    resource_version; ``python -m minisched_tpu_torch fsck`` must exit 0.
    The process-global counters and histograms are reset before (b)."""
    from minisched_tpu_torch.__main__ import start
    from minisched_tpu_torch.controlplane import walio
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore
    from minisched_tpu_torch.controlplane.httpserver import HTTPClient
    from minisched_tpu_torch.service.config import ProcessConfig

    nodes, pods = mk_c5_cluster(n_nodes, n_pods)
    plain = [p.metadata.name for p in pods
             if not p.metadata.name.startswith("special")]
    wal = os.path.join(workdir, "c5.wal")
    url = f"file://{wal}"
    # -- (a) the first life, in a child ------------------------------------
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PORT=str(port), FRONTEND_URL="http://x",
               MINISCHED_TPU_STORE_URL=url, **(child_env or {}))
    child = subprocess.Popen([sys.executable, "-m", "minisched_tpu_torch"],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    lines: List[str] = []
    up = threading.Event()

    def read_child() -> None:
        # read to the end, so the child never blocks on a full pipe
        for line in child.stdout:
            lines.append(line)
            up.set()
        up.set()

    reader = threading.Thread(target=read_child, daemon=True)
    reader.start()
    watch = None
    try:
        up.wait(300)
        if not lines or f"API on {base}" not in lines[0]:
            raise AssertionError(f"durable child: no API line "
                                 f"({lines[-20:]}, exit {child.poll()})")
        http = HTTPClient(base)
        watch = PodWatch(base)
        t_first = time.monotonic()
        for i in range(0, len(nodes), chunk):
            http.nodes().create_many(nodes[i:i + chunk],
                                     return_objects=False)
        for i in range(0, len(pods), chunk):
            http.pods().create_many(pods[i:i + chunk], return_objects=False)
        create_s = time.monotonic() - t_first
        deadline = time.monotonic() + timeout_s
        while (len(watch.nodes) < kill_binds and watch.error is None
               and child.poll() is None and time.monotonic() < deadline):
            time.sleep(0.01)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
        kill_s = time.monotonic() - t_first
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        reader.join(10)
        if watch is not None:
            watch.join()
    seen = dict(watch.nodes)
    if watch.error is not None and len(seen) < kill_binds:
        raise AssertionError(f"durable child: the watch failed after "
                             f"{len(seen)} binds: {watch.error!r}")
    if len(seen) < kill_binds:
        raise AssertionError(f"durable child: {len(seen)} binds seen, not "
                             f"{kill_binds} (exit {child.returncode}, "
                             f"{lines[-20:]})")
    if len(seen) >= len(plain):
        raise AssertionError("durable child: every plain pod was bound "
                             "before the kill")
    wal_bytes = os.path.getsize(wal)
    wal_records = walio.count_records(wal)
    # -- (b) the second life, in this process ------------------------------
    hist.reset()
    counters.reset()
    before = set(threading.enumerate())
    t0 = time.monotonic()
    client, _base, stop = start(ProcessConfig(
        port=free_port(), frontend_url="http://x", external_store_url=url),
        device_mode=True, device=device)
    t_boot = time.monotonic()
    boot_s = t_boot - t0
    store, service = stop.store, stop.service
    sched = service.scheduler
    # the last wave's assumptions drain at quiesce when their leases run out
    sched.assume_ttl_s = QUIESCE_TTL_S
    try:
        moved = []
        for name, node in seen.items():
            got = store.get("Pod", "default", name).spec.node_name
            if got != node:
                moved.append((name, node, got))
        if moved:
            raise AssertionError(f"recovery: {len(moved)} watched binds "
                                 f"lost or moved, first {moved[:3]}")
        # the store, not the watch (which trails the engine), says
        # whether the kill landed mid-run
        left_at_boot = len(plain) - _bound_count(store)
        if left_at_boot < len(plain) * MIN_LEFT_AT_BOOT:
            raise AssertionError(
                f"durable child: {left_at_boot} of {len(plain)} plain pods "
                f"left unbound at the kill, under "
                f"{MIN_LEFT_AT_BOOT:.0%}: the kill did not land mid-run")
        last_t, last_n = t_boot, -1
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            n = _bound_count(store)
            if n != last_n:
                last_t, last_n = time.monotonic(), n
            if n >= len(plain):
                break
            time.sleep(0.02)
        bind_s = last_t - t_boot
        wait_until(lambda: sched.assumed_count() == 0, QUIESCE_TTL_S * 20,
                   "the assume cache drained", sched)
        waves = int(sched.metrics.snapshot().get("wave", {}).get("count", 0))
        waiting_left = len(sched._waiting_pods)
        pod_list = client.pods().list()
        audit = audit_store(client, pods=pod_list)
        listed = {p.metadata.name: p.spec.node_name for p in pod_list}
        del pod_list
        missing = [p.metadata.name for p in pods
                   if p.metadata.name not in listed]
        unbound = [n for n in plain if not listed[n]]
        special_bound = [n for n, node in listed.items()
                         if n.startswith("special") and node]
        moved = [n for n, node in seen.items() if listed[n] != node]
        if (missing or unbound or special_bound or moved
                or audit["nodes"] != n_nodes or sched.loop_errors):
            raise AssertionError(
                f"recovered config 5: missing {missing[:3]} "
                f"({len(missing)}), unbound {unbound[:3]} ({len(unbound)}), "
                f"special bound {special_bound[:3]}, moved {moved[:3]}, "
                f"{audit['nodes']} nodes, {sched.loop_errors} loop errors")
        groups = counters.get("storage.group_commit.groups")
        records = counters.get("storage.group_commit.records")
        loop_errors, assumed_left = sched.loop_errors, sched.assumed_count()
        # nothing may write once the listing is taken: the scheduler (and
        # its event writer) stops first
        service.close()
        t1 = time.monotonic()
        store.compact()
        compact_s = time.monotonic() - t1
        ckpt_bytes = os.path.getsize(wal + ".ckpt")
        digest = _state_digest(store)
    finally:
        stop()
    left = sorted(t.name for t in set(threading.enumerate()) - before
                  if t.is_alive() and not t.daemon)
    # fsck (a process of its own) and the read-only reopen both only read
    # the files: they run side by side
    t_fsck = time.monotonic()
    fsck_proc = subprocess.Popen(
        [sys.executable, "-m", "minisched_tpu_torch", "fsck", wal],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t1 = time.monotonic()
        reopened = DurableObjectStore(wal, readonly=True)
        reopen_s = time.monotonic() - t1
        if _state_digest(reopened) != digest:
            raise AssertionError("the read-only reopen after compaction "
                                 "differs from the listing taken before "
                                 "stop()")
        reopened.close()
        del reopened
        out, err = fsck_proc.communicate(timeout=600)
    finally:
        if fsck_proc.poll() is None:
            fsck_proc.kill()
            fsck_proc.wait()
    fsck_s = time.monotonic() - t_fsck
    fsck = subprocess.CompletedProcess(fsck_proc.args, fsck_proc.returncode,
                                       out, err)
    if fsck.returncode != 0:
        raise AssertionError(f"fsck exit {fsck.returncode}: "
                             f"{fsck.stdout[-3000:]}{fsck.stderr[-2000:]}")
    report = json.loads(fsck.stdout)
    return DurableRun(
        len(plain), len(seen), kill_s, create_s, wal_bytes, wal_records,
        store.replay_s, boot_s, left_at_boot, bind_s, waves, loop_errors,
        assumed_left, waiting_left, audit, groups, records, compact_s,
        ckpt_bytes, reopen_s, digest[1], fsck.returncode, fsck_s,
        report["files"][os.path.basename(wal)]["records"],
        report["state"]["objects"], left, watch.reconnects)


def count_grpc_binds(address: str, n_binds: int, conn: Any,
                     batch: int = 1) -> None:
    """The body of an external gRPC watcher, run in its own process
    (``multiprocessing`` spawn): a ``Watch`` on Pods at ``address``
    (``send_initial=False``, up to ``batch`` events a message), its sync
    line sent on ``conn`` once the stream is registered, then every event
    read and decoded until ``n_binds`` pods were seen bound or the stream
    ends.  Sends on ``conn``: ``bound`` (pod name to node of every bind
    seen), ``events``, ``messages``, ``span_s`` (first to last event),
    ``rv_ordered`` (every event's resource_version above the one before)
    and ``error`` (the stream's status when it ended, None when
    ``n_binds`` were seen)."""
    import grpc

    from minisched_tpu_torch.controlplane.grpcserver import EvaluatorClient

    client = EvaluatorClient(address)
    stream = client.watch("Pod", send_initial=False, batch=batch)
    conn.send(next(stream))
    bound: Dict[str, str] = {}
    events, first_t, last_t, last_rv, ordered = 0, 0.0, 0.0, 0, True
    error = None
    try:
        for msg in stream:
            last_t = time.monotonic()
            first_t = first_t or last_t
            events += 1
            ordered = ordered and msg["resource_version"] > last_rv
            last_rv = msg["resource_version"]
            obj = msg["object"]
            if msg["type"] == "MODIFIED" and obj["spec"]["node_name"]:
                bound[obj["metadata"]["name"]] = obj["spec"]["node_name"]
                if len(bound) >= n_binds:
                    break
    except grpc.RpcError as err:
        error = f"{err.code().name}: {err.details()}"
    finally:
        stream.cancel()
        client.close()
    conn.send({"bound": bound, "events": events,
               "messages": stream.messages - 1, "span_s": last_t - first_t,
               "rv_ordered": ordered, "error": error})


def audit_trace(spans: List[Dict[str, Any]],
                pods: Sequence[str]) -> Dict[str, int]:
    """Each default-namespace pod's chain in the span ring: enqueue, then
    pop, bind and
    bind_ack in that order, its bind's wave id named by a ``wave_build``
    span (and by a ``wave_evaluate`` span when the wave was pipelined).
    Raises on the first pod whose chain is broken; returns counts."""
    built = {s["wave"] for s in spans if s["stage"] == "wave_build"}
    evaluated = {s["wave"] for s in spans if s["stage"] == "wave_evaluate"}
    serial = {s["wave"] for s in spans
              if s["stage"] == "wave_build" and s.get("serial")}
    at: Dict[str, Dict[str, int]] = defaultdict(dict)
    bind_wave: Dict[str, Any] = {}
    for i, s in enumerate(spans):
        pod = s.get("pod")
        if pod is None:
            continue
        at[pod].setdefault(s["stage"], i)
        if s["stage"] == "bind":
            bind_wave[pod] = s.get("wave")
    chain = ("enqueue", "pop", "bind", "bind_ack")
    for name in pods:
        key = f"default/{name}"
        idx = [at[key].get(stage) for stage in chain]
        if None in idx or idx != sorted(idx):
            raise AssertionError(f"trace: {key} chain {dict(at[key])}")
        wave = bind_wave[key]
        if wave not in built or (wave not in serial
                                 and wave not in evaluated):
            raise AssertionError(f"trace: {key} bound in wave {wave}, "
                                 "which no wave_build/wave_evaluate names")
    return {"spans": len(spans), "pods": len(pods),
            "waves": len({bind_wave[f"default/{n}"] for n in pods})}


# -- the scheduler over the wire, through a restart of its API server -------

@dataclass
class RemoteRun:
    n_plain: int
    create_s: float  # the creates over the wire, first to last answer
    sync_s: float  # start_scheduler: informer sync over the wire included
    #: binds the first watch had seen at the SIGKILL, and the seconds from
    #: the scheduler's start to the kill
    seen_at_kill: int
    kill_s: float
    #: the restarted child: the store's replay, spawn to ready, the plain
    #: pods it found unbound, and spawn to the next bind a watch saw
    replay_s: float
    boot_s: float
    left_at_boot: int
    next_bind_s: float
    #: from the restarted child's ready line to the last plain bind
    bind_s: float
    waves: int
    loop_errors: int
    assumed_left: int
    waiting_left: int
    audit: Dict[str, int]
    #: per kind: the informer's reconnects and resumes
    reconnects: Dict[str, Dict[str, int]]
    counters: Dict[str, int]
    #: seconds the scheduler's watch streams spent decoding, per kind, and
    #: the events they decoded
    decode_s: Dict[str, float]
    decoded: Dict[str, int]
    double_binds: int
    fsck_rc: int
    fsck_s: float
    split: Dict[str, float]
    threads_left: List[str]
    #: the test watches' resumes after an eviction (both lives)
    watch_reconnects: int = 0


#: the counters ``run_config5_remote`` reports
REMOTE_COUNTERS = (
    "informer.reconnect", "informer.resume", "informer.relist_on_410",
    "informer.open_retry", "informer.relist_jitter_s",
    "assume.revalidate_on_reconnect", "assume.lease_requeued",
    "assume.lease_confirmed", "assume.lease_expired",
    "assume.lease_renewed_bound",
    "remote.retry", "remote.bind_retry_dedup", "remote.bind_ack_replayed",
    "wire.pool_open", "wire.pool_reuse", "wire.pool_stale_retry",
    "watch.fanout.evicted_slow", "wire.evicted_outbuf")


#: the scheduler's ``RemoteStore`` retries in ``run_config5_remote``: JAX's
#: crash-restart flow's (``ha/proc.py:64``); the default 4 gives up in
#: about 0.75 s, sooner than a restart
REMOTE_RETRIES = 10
#: pods ``run_config5_remote`` creates once the API server is back
AFTER_RESTART_PODS = 64


def run_config5_remote(workdir: str, n_nodes: int = 10_000,
                       n_pods: int = 50_000, kill_binds: int = 10_000,
                       device: Any = None, chunk: int = 10_000,
                       timeout_s: float = 900.0,
                       max_wave: int = 1024) -> RemoteRun:
    """Config 5 scheduled over the wire through a SIGKILL and restart of
    the API server.

    The port's ``start_api_server`` runs in a ``faults.proc.
    ServerSupervisor`` child over ``<workdir>/remote.wal`` on a fixed
    port (the stream loop on, fsync off, no compaction).  A ``PodWatch``
    opens first; config 5's nodes and pods are created with
    ``RemoteClient(base)`` in batch creates of ``chunk``
    (``return_objects=False``).  Then
    ``SchedulerService(RemoteClient(base, retries=REMOTE_RETRIES))`` starts
    ``default_full_roster_config()`` with ``device_mode=True`` at its
    defaults (pipelined, waves of ``max_wave``, 1,024) on ``device``:
    every informer event and every bind crosses the child's REST
    façade.

    Once the watch has seen ``kill_binds`` binds the child is SIGKILLed
    and started again on the same port over the same WAL; nothing in
    this process is touched.  The scheduler rides through: the remote
    store retries, each informer resumes or relists, the engine's assume
    ledger is revalidated.  ``AFTER_RESTART_PODS`` more pods are created
    once the child is back (their uids must be new).  The run raises unless
    every plain pod ends bound and no ``special*`` pod, every bind the
    first watch saw is on the same node, the child found at least
    ``MIN_LEFT_AT_BOOT`` of the plain pods unbound, both informers
    reconnected, the WAL holds no double bind and ``python3 -m
    minisched_tpu_torch fsck`` exits 0.  Counters and histograms are
    reset first."""
    from minisched_tpu_torch.controlplane.fsck import wal_double_binds
    from minisched_tpu_torch.controlplane.remote import RemoteClient
    from minisched_tpu_torch.service.config import (
        default_full_roster_config,
    )

    from minisched_tpu_torch.faults.proc import ServerSupervisor

    nodes, pods = mk_c5_cluster(n_nodes, n_pods)
    plain = [p.metadata.name for p in pods
             if not p.metadata.name.startswith("special")]
    wal = os.path.join(workdir, "remote.wal")
    hist.reset()
    counters.reset()
    before = set(threading.enumerate())
    sup = ServerSupervisor(wal, archive_history=False, boot_timeout_s=300.0)
    base = sup.start()
    svc = watch = watch2 = None
    try:
        client = RemoteClient(base)
        watch = PodWatch(base)
        t0 = time.monotonic()
        for i in range(0, len(nodes), chunk):
            client.nodes().create_many(nodes[i:i + chunk],
                                       return_objects=False)
        for i in range(0, len(pods), chunk):
            client.pods().create_many(pods[i:i + chunk],
                                      return_objects=False)
        create_s = time.monotonic() - t0
        sched_client = RemoteClient(base, retries=REMOTE_RETRIES)
        svc = SchedulerService(sched_client)
        t0 = time.monotonic()
        sched = svc.start_scheduler(default_full_roster_config(),
                                    device_mode=True, max_wave=max_wave,
                                    device=device)
        t_loop = time.monotonic()
        sync_s = t_loop - t0
        metrics = sched.metrics = CycleMetrics()
        sched.assume_ttl_s = QUIESCE_TTL_S
        deadline = time.monotonic() + timeout_s
        while (len(watch.nodes) < kill_binds and watch.error is None
               and time.monotonic() < deadline):
            time.sleep(0.01)
        sup.kill()
        kill_s = time.monotonic() - t_loop
        seen = dict(watch.nodes)
        watch.join()
        if len(seen) < kill_binds:
            raise AssertionError(f"remote config 5: {len(seen)} binds seen "
                                 f"before the kill, not {kill_binds} "
                                 f"(watch {watch.error!r})")
        # -- the restart: same port, same WAL ---------------------------------
        sup.restart()
        t_ready = time.monotonic()
        boot = _metrics_counters(base, ("proc.boot_pending_pods",
                                        "proc.boot_replay_us"))
        # the special pods never bind: the rest of the pending are plain
        left_at_boot = (boot["proc.boot_pending_pods"]
                        - (len(pods) - len(plain)))
        if left_at_boot < len(plain) * MIN_LEFT_AT_BOOT:
            raise AssertionError(
                f"remote config 5: {left_at_boot} of {len(plain)} plain "
                f"pods unbound when the server came back, under "
                f"{MIN_LEFT_AT_BOOT:.0%}: the kill did not land mid-run")
        watch2 = PodWatch(base)
        extra = [make_pod(f"after-{i:04d}", requests={"cpu": "500m",
                                                      "memory": "256Mi"})
                 for i in range(AFTER_RESTART_PODS)]
        client.pods().create_many(extra, return_objects=False)
        want = set(plain) | {p.metadata.name for p in extra}
        wait_until(lambda: want <= watch2.bound or watch2.error is not None,
                   timeout_s, f"{len(want)} pods seen bound after the "
                   "restart", sched)
        if watch2.error is not None:
            raise AssertionError(f"the second pod watch failed: "
                                 f"{watch2.error!r}")
        bind_s = watch2.last_bind_t - t_ready
        next_bind_s = (watch2.first_live_bind_t - t_ready
                       + sup.boot_s if watch2.first_live_bind_t else -1.0)
        wait_until(lambda: sched.assumed_count() == 0, QUIESCE_TTL_S * 20,
                   "the assume cache drained", sched)
        waves = int(metrics.snapshot().get("wave", {}).get("count", 0))
        waiting_left = len(sched._waiting_pods)
        loop_errors, assumed_left = sched.loop_errors, sched.assumed_count()
        phases = split(metrics)
        informers = {kind: svc._factory.informer_for(kind)
                     for kind in ("Pod", "Node")}
        reconnects = {kind: {"reconnects": inf.reconnects,
                             "resumes": inf.resumes}
                      for kind, inf in informers.items()}
        svc.shutdown_scheduler()
        svc.recorder.close()
        svc = None
        pod_list = client.pods().list()
        audit = audit_store(client, pods=pod_list)
        listed = {p.metadata.name: p for p in pod_list}
        del pod_list
        missing = [n for n in want if n not in listed]
        unbound = [n for n in want if n in listed
                   and not listed[n].spec.node_name]
        special_bound = [n for n, p in listed.items()
                         if n.startswith("special") and p.spec.node_name]
        moved = [(n, node, listed[n].spec.node_name)
                 for n, node in seen.items()
                 if listed[n].spec.node_name != node]
        uids = [p.metadata.uid for p in listed.values()]
        reused = len(uids) - len(set(uids))
        no_reconnect = [k for k, v in reconnects.items()
                        if v["reconnects"] < 1]
        if (missing or unbound or special_bound or moved or reused
                or no_reconnect or loop_errors or assumed_left
                or waiting_left or audit["nodes"] != n_nodes):
            raise AssertionError(
                f"remote config 5: missing {missing[:3]} ({len(missing)}), "
                f"unbound {unbound[:3]} ({len(unbound)}), special bound "
                f"{special_bound[:3]}, moved {moved[:3]} ({len(moved)}), "
                f"{reused} reused uids, no reconnect for {no_reconnect}, "
                f"{loop_errors} loop errors, {assumed_left} assumed and "
                f"{waiting_left} waiting left, {audit['nodes']} nodes")
        client.store.close()
    finally:
        if svc is not None:
            svc.shutdown_scheduler()
        for w in (watch, watch2):
            if w is not None:
                w._closing = True
                w._resp.close()
        rc = sup.terminate() if sup.alive() else None
        sup.stop()
    if rc != 0:
        raise AssertionError(f"façade child exit {rc}: {sup.exit_stderr}")
    for w in (watch, watch2):
        w._thread.join(timeout=30)
    left = sorted(t.name for t in set(threading.enumerate()) - before
                  if t.is_alive() and not t.daemon)
    # fsck (a process of its own) and the double-bind audit both only
    # read the WAL: they run side by side
    t1 = time.monotonic()
    fsck_proc = subprocess.Popen(
        [sys.executable, "-m", "minisched_tpu_torch", "fsck", wal],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        double = wal_double_binds(wal)
        out, err = fsck_proc.communicate(timeout=600)
    finally:
        if fsck_proc.poll() is None:
            fsck_proc.kill()
            fsck_proc.wait()
    fsck_s = time.monotonic() - t1
    if double or fsck_proc.returncode != 0:
        raise AssertionError(f"remote config 5: {len(double)} double binds "
                             f"{double[:3]}, fsck exit "
                             f"{fsck_proc.returncode}: {out[-2000:]}"
                             f"{err[-2000:]}")
    decode_s = dict(sched_client.store.decode_s)
    decoded = dict(sched_client.store.decoded)
    snap = counters.snapshot()
    return RemoteRun(
        len(plain), create_s, sync_s, len(seen), kill_s,
        boot["proc.boot_replay_us"] / 1e6, sup.boot_s, left_at_boot,
        next_bind_s, bind_s, waves, loop_errors, assumed_left, waiting_left,
        audit, reconnects, {k: snap.get(k, 0) for k in REMOTE_COUNTERS},
        decode_s, decoded, len(double), fsck_proc.returncode, fsck_s,
        phases, left, watch.reconnects + watch2.reconnects)


@dataclass
class ReplicatedRun:
    n_plain: int
    old_leader: str
    new_leader: str
    create_s: float  # the creates over the wire, first to last answer
    sync_s: float  # start_scheduler: informer sync over the wire included
    #: binds the watch on ``r2`` had seen at the SIGKILL of the leader, and
    #: the seconds from the scheduler's start to the kill
    seen_at_kill: int
    kill_s: float
    #: seconds from the kill: to a new leader serving, to the first bind
    #: the watch saw after that, and to the last plain bind it saw
    promote_s: float
    next_bind_s: float
    after_s: float
    #: seconds from the old leader's restart to its façade answering (the
    #: replay of its own WAL and the imports), and to it serving as a
    #: fenced follower at the new leader's rv
    reboot_s: float
    catchup_s: float
    waves: int
    loop_errors: int
    assumed_left: int
    waiting_left: int
    audit: Dict[str, int]
    #: per kind: the informer's reconnects and resumes
    reconnects: Dict[str, Dict[str, int]]
    counters: Dict[str, int]
    #: ``storage.quorum_wait_s`` off each leader's ``/metrics`` ("before":
    #: the old leader just before the kill, "after": the new one at the
    #: end): groups and the p50 and p99 bucket bounds
    quorum_wait: Dict[str, Dict[str, Any]]
    #: per WAL (the killed leader's as the kill left it included): double
    #: binds
    double_binds: Dict[str, int]
    #: (replica, replica, "identical" or "prefix") for every pair of WALs
    wal_pairs: List[Tuple[str, str, str]]
    fsck_rc: int
    fsck_s: float
    #: pod name → node at the end, and the binds the watch saw before the
    #: kill
    placements: Dict[str, str]
    seen: Dict[str, str]
    split: Dict[str, float]
    threads_left: List[str]
    watch_reconnects: int = 0


#: the counters ``run_config5_replicated`` reports: the remote run's and
#: the endpoint routing's
REPLICATED_COUNTERS = REMOTE_COUNTERS + (
    "remote.read_failover", "remote.watch_failover",
    "remote.leader_discoveries", "remote.not_yet_observed",
    "storage.repl.not_leader_errors", "informer.resume_not_yet_observed")


#: one WAL's offline audit in a process of its own: its double binds and,
#: with "1", its frame digests (``fsck.wal_digests``), as one JSON line
WAL_AUDIT = """
import json, sys
from minisched_tpu_torch.controlplane.fsck import wal_digests
from minisched_tpu_torch.faults import wal_double_binds
out = {"double": len(wal_double_binds(sys.argv[1]))}
if sys.argv[2] == "1":
    out["digests"] = wal_digests(sys.argv[1])
print(json.dumps(out))
"""


def _audit_wals(wals: Dict[str, str], digested: set,
                fsck_wal: str, more_fsck: Sequence[str] = ()
                ) -> Dict[Any, Any]:
    """The offline audits of a replicated run, side by side (each is
    Python JSON over a whole WAL, about 100 µs a record): ``WAL_AUDIT``
    for every WAL (digests for those in ``digested``) and ``python3 -m
    minisched_tpu_torch fsck`` on ``fsck_wal`` (and on each of
    ``more_fsck``), each a process without the card.  Returns each WAL's
    answer, and under None fsck's (exit code, the end of its output),
    under ``("fsck", path)`` each of ``more_fsck``'s."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = {key: subprocess.Popen(
        [sys.executable, "-m", "minisched_tpu_torch", "fsck", path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
        for key, path in [(None, fsck_wal)]
        + [(("fsck", p), p) for p in more_fsck]}
    for name, path in wals.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", WAL_AUDIT, path,
             "1" if name in digested else "0"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    out: Dict[Any, Any] = {}
    try:
        for name, proc in procs.items():
            text, err = proc.communicate(timeout=900)
            if name is None or isinstance(name, tuple):
                out[name] = (proc.returncode, text[-2000:])
            elif proc.returncode != 0:
                raise AssertionError(f"the audit of {wals[name]} exited "
                                     f"{proc.returncode}: {err[-2000:]}")
            else:
                out[name] = json.loads(text)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _quorum_wait(base: str) -> Dict[str, Any]:
    """``storage.quorum_wait_s`` off one replica's ``/metrics``: groups
    and the p50 and p99 bucket upper bounds (seconds)."""
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        _types, samples = hist.parse_prometheus(r.read().decode())
    name = "storage_quorum_wait_seconds"
    p50 = hist.parsed_histogram_quantile(samples, name, 0.5)
    p99 = hist.parsed_histogram_quantile(samples, name, 0.99)
    return {"groups": int(sum(v for n, _l, v in samples
                              if n == name + "_count")),
            "p50_le_s": p50[1] if p50 else None,
            "p99_le_s": p99[1] if p99 else None}


def run_config5_replicated(workdir: str, n_nodes: int = 10_000,
                           n_pods: int = 25_000, kill_binds: int = 5_000,
                           device: Any = None, chunk: int = 10_000,
                           timeout_s: float = 900.0, max_wave: int = 1024,
                           ttl_s: Optional[float] = None,
                           pipeline: bool = True) -> ReplicatedRun:
    """Config 5 scheduled over the wire through a SIGKILL of the store
    leader of a three-replica plane.

    ``ReplicatedPlane(workdir, n=3, fsync=False, ttl_s=ttl_s)`` (JAX's
    TTL, 2 s, by default) starts three replica children (``r0``
    bootstraps as leader; each child is host code with no CUDA context).
    A ``PodWatch`` opens on follower ``r2``, the follower read plane,
    which is never killed.  Config 5's nodes and pods are created with
    ``RemoteClient(leader)`` in batch creates of ``chunk``; every group
    waits for a follower's ack.  Then ``SchedulerService(RemoteClient(
    leader, endpoints=[r1, r2], retries=REMOTE_RETRIES))`` starts
    ``default_full_roster_config()`` with ``device_mode=True`` (pipelined
    unless ``pipeline=False``, waves of ``max_wave``) on ``device``.

    Once the watch has seen ``kill_binds`` binds the leader child is
    SIGKILLed (its WAL copied aside as the kill left it) and a follower
    must win the arbiter majority.  The engine goes on without a
    restart: its writes find the new leader by discovery, its informers
    resume on a live replica.  When the watch has seen every plain pod
    bound, ``ReplicaSupervisor.restart()`` brings the old leader back; it
    must serve as a fenced follower at the new leader's rv.

    The run raises unless: a new leader within ``2·TTL + 1 s`` of the
    kill; every bind watched before the kill on the new leader on the
    same node; every plain pod bound and no ``special*`` pod;
    ``audit_store``'s rules; both informers reconnected; no loop error,
    the assume and Permit ledgers empty; every pair of the three WALs
    identical or a prefix (``fsck.wal_compare``); no double bind in any
    WAL, the killed leader's included; ``python3 -m minisched_tpu_torch
    fsck`` exit 0 on the new leader's WAL.  Counters and histograms of
    this process are reset first."""
    import shutil

    from minisched_tpu_torch.controlplane.fsck import compare_digests
    from minisched_tpu_torch.controlplane.remote import RemoteClient
    from minisched_tpu_torch.controlplane.replproc import (
        DEFAULT_TTL_S,
        ReplicatedPlane,
    )

    ttl_s = DEFAULT_TTL_S if ttl_s is None else float(ttl_s)
    nodes, pods = mk_c5_cluster(n_nodes, n_pods)
    plain = [p.metadata.name for p in pods
             if not p.metadata.name.startswith("special")]
    hist.reset()
    counters.reset()
    before = set(threading.enumerate())
    plane = ReplicatedPlane(workdir, n=3, fsync=False, ttl_s=ttl_s)
    svc = watch = sched_client = None
    try:
        leader_url = plane.start()
        r0, r1, r2 = plane.replicas
        if leader_url != r0.base_url:
            raise AssertionError(f"replicated config 5: {leader_url} leads "
                                 f"at boot, not r0")
        watch = PodWatch(r2.base_url)
        client = RemoteClient(leader_url)
        t0 = time.monotonic()
        for i in range(0, len(nodes), chunk):
            client.nodes().create_many(nodes[i:i + chunk],
                                       return_objects=False)
        for i in range(0, len(pods), chunk):
            client.pods().create_many(pods[i:i + chunk],
                                      return_objects=False)
        create_s = time.monotonic() - t0
        client.store.close()
        sched_client = RemoteClient(leader_url,
                                    endpoints=[r1.base_url, r2.base_url],
                                    retries=REMOTE_RETRIES)
        svc = SchedulerService(sched_client)
        t0 = time.monotonic()
        sched = svc.start_scheduler(default_full_roster_config(),
                                    device_mode=True, max_wave=max_wave,
                                    device=device, pipeline=pipeline)
        t_loop = time.monotonic()
        sync_s = t_loop - t0
        metrics = sched.metrics = CycleMetrics()
        sched.assume_ttl_s = QUIESCE_TTL_S
        deadline = time.monotonic() + timeout_s
        while (len(watch.nodes) < kill_binds and watch.error is None
               and time.monotonic() < deadline):
            time.sleep(0.01)
        quorum_before = _quorum_wait(r0.base_url)
        # -- the kill: the leader, no goodbye -----------------------------
        seen = dict(watch.nodes)
        t_kill = time.monotonic()
        r0.kill()
        kill_s = t_kill - t_loop
        if len(seen) < kill_binds or len(seen) >= len(plain):
            raise AssertionError(f"replicated config 5: {len(seen)} binds "
                                 f"seen at the kill, not from {kill_binds} "
                                 f"to under {len(plain)} (watch "
                                 f"{watch.error!r})")
        won = plane.wait_for_leader(timeout_s=10 * ttl_s,
                                    exclude=r0.replica_id)
        t_promoted = time.monotonic()
        promote_s = t_promoted - t_kill
        shutil.copy(r0.wal_path, r0.wal_path + ".killed")
        want = set(plain)
        wait_until(lambda: want <= watch.bound or watch.error is not None,
                   timeout_s, f"{len(want)} plain pods seen bound after "
                   "the failover", sched)
        if watch.error is not None:
            raise AssertionError(f"the pod watch on r2 failed: "
                                 f"{watch.error!r}")
        after_s = watch.last_bind_t - t_kill
        later = [t for t in list(watch.bind_times) if t >= t_promoted]
        next_bind_s = (later[0] - t_kill) if later else -1.0
        # -- the old leader back, as a fenced follower --------------------
        new = next(r for r in plane.replicas
                   if r.replica_id == won["id"])
        t_restart = time.monotonic()
        r0.restart()
        reboot_s = time.monotonic() - t_restart

        def caught_up() -> bool:
            # the leader's rv first: the recorder's Event writes keep it
            # moving, and the follower need only reach what it read
            lead = new.status()
            mine = r0.status()
            return (mine is not None and lead is not None
                    and mine.get("role") == "follower" and mine.get("fenced")
                    and int(mine.get("rv", 0)) >= int(lead.get("rv", 0)))

        wait_until(caught_up, timeout_s, "the restarted old leader to "
                   "catch up as a fenced follower", sched)
        catchup_s = time.monotonic() - t_restart
        wait_until(lambda: sched.assumed_count() == 0, QUIESCE_TTL_S * 20,
                   "the assume cache drained", sched)
        waves = int(metrics.snapshot().get("wave", {}).get("count", 0))
        waiting_left = len(sched._waiting_pods)
        loop_errors, assumed_left = sched.loop_errors, sched.assumed_count()
        phases = split(metrics)
        informers = {kind: svc._factory.informer_for(kind)
                     for kind in ("Pod", "Node")}
        reconnects = {kind: {"reconnects": inf.reconnects,
                             "resumes": inf.resumes}
                      for kind, inf in informers.items()}
        svc.shutdown_scheduler()
        svc.recorder.close()
        svc = None
        quorum_after = _quorum_wait(new.base_url)
        reader = RemoteClient(new.base_url)
        pod_list = reader.pods().list()
        audit = audit_store(reader, pods=pod_list)
        reader.store.close()
        listed = {p.metadata.name: p for p in pod_list}
        del pod_list
        placements = {n: p.spec.node_name for n, p in listed.items()}
        unbound = [n for n in plain if not placements.get(n)]
        special_bound = [n for n, node in placements.items()
                         if n.startswith("special") and node]
        moved = [(n, node, placements.get(n)) for n, node in seen.items()
                 if placements.get(n) != node]
        no_reconnect = [k for k, v in reconnects.items()
                        if v["reconnects"] < 1]
        if (unbound or special_bound or moved or no_reconnect or loop_errors
                or assumed_left or waiting_left or promote_s > 2 * ttl_s + 1
                or audit["nodes"] != n_nodes):
            raise AssertionError(
                f"replicated config 5: unbound {unbound[:3]} "
                f"({len(unbound)}), special bound {special_bound[:3]}, moved "
                f"{moved[:3]} ({len(moved)}), no reconnect for "
                f"{no_reconnect}, {loop_errors} loop errors, {assumed_left} "
                f"assumed and {waiting_left} waiting left, promotion "
                f"{promote_s:.3f}s (TTL {ttl_s}s), {audit['nodes']} nodes")
    finally:
        if svc is not None:
            svc.shutdown_scheduler()
        if watch is not None:
            watch._closing = True
            watch._resp.close()
        if sched_client is not None:
            sched_client.store.close()
        plane.stop()
    watch._thread.join(timeout=30)
    left = sorted(t.name for t in set(threading.enumerate()) - before
                  if t.is_alive() and not t.daemon)
    wals = {r.replica_id: r.wal_path for r in plane.replicas}
    audited = dict(wals, **{f"{r0.replica_id}-killed":
                            r0.wal_path + ".killed"})
    t1 = time.monotonic()
    offline = _audit_wals(audited, digested=set(wals),
                        fsck_wal=wals[won["id"]])
    fsck_s = time.monotonic() - t1
    fsck_rc, fsck_out = offline.pop(None)
    double = {k: v["double"] for k, v in offline.items()}
    pairs = []
    ids = sorted(wals)
    for i, a in enumerate(ids):
        for b in ids[i + 1:]:
            cmp = compare_digests(offline[a]["digests"],
                                  offline[b]["digests"])
            if not (cmp["identical"] or cmp["prefix"]):
                raise AssertionError(f"replicated config 5: the WALs of {a} "
                                     f"and {b} diverged: {cmp['diverged']}")
            pairs.append((a, b, "identical" if cmp["identical"]
                          else "prefix"))
    if any(double.values()) or fsck_rc != 0:
        raise AssertionError(f"replicated config 5: double binds {double}, "
                             f"fsck exit {fsck_rc}: {fsck_out}")
    snap = counters.snapshot()
    return ReplicatedRun(
        len(plain), r0.replica_id, won["id"], create_s, sync_s, len(seen),
        kill_s, promote_s, next_bind_s, after_s, reboot_s, catchup_s, waves,
        loop_errors, assumed_left, waiting_left, audit, reconnects,
        {k: snap.get(k, 0) for k in REPLICATED_COUNTERS},
        {"before": quorum_before, "after": quorum_after}, double, pairs,
        fsck_rc, fsck_s, placements, seen, phases, left, watch.reconnects)


@dataclass
class ShardedRun:
    n_plain: int
    #: tenant namespace → its group at the start; the split's namespace,
    #: its source and target group
    tenants: Dict[str, str]
    hot_ns: str
    source: str
    target: str
    create_s: float  # the creates through the router, first to last answer
    sync_s: float  # start_scheduler: informer sync through the router
    #: the home group's budget document: bytes, seconds to serve it over
    #: the wire (encode included) and to apply it to a ``BudgetMirror``
    budget_doc: Dict[str, float]
    #: binds the merged watch had seen at the split, the seconds from the
    #: scheduler's start to the split, and from the split to the last
    #: plain bind seen
    seen_at_split: int
    split_at_s: float
    after_s: float
    #: ``split_namespace``'s result: objects, epoch, freeze_s, handoff_s,
    #: seed_s
    split: Dict[str, Any]
    #: time to bind (seconds from the scheduler's start to the bind the
    #: watch saw): p50 and p99 of the pods of ``hot_ns`` bound after the
    #: split, and of the other tenants' pods bound after it
    ttb: Dict[str, Dict[str, float]]
    waves: int
    loop_errors: int
    assumed_left: int
    waiting_left: int
    audit: Dict[str, int]
    #: the merged watch: events, bind transitions, pods seen bound twice
    #: or on two nodes, plain pods seen deleted, reopens
    watch: Dict[str, int]
    #: router counters (this process) and the groups' (each façade's
    #: ``/metrics``), summed
    counters: Dict[str, int]
    #: per group: hot_ns objects on it at the end
    hot_left: Dict[str, int]
    double_binds: Dict[str, int]
    fsck_rc: Dict[str, int]
    fsck_s: float
    placements: Dict[str, str]
    seen: Dict[str, str]
    split_phases: Dict[str, float]
    threads_left: List[str]
    children_left: List[str]


#: the counters ``run_config5_sharded`` reports: the router's (this
#: process) and the façades' (summed off each group's ``/metrics``)
SHARDED_COUNTERS = (
    "shard.wrong_shard_chased", "shard.topology_refreshes",
    "shard.cross_bind_batches", "shard.cross_bind_entries",
    "shard.events_suppressed", "shard.watch.held", "shard.watch.moves",
    "shard.watch.aborts", "shard.splits", "remote.shard_frozen_retry",
    "remote.shard_frozen_timeout", "shard.budget.mirror_checks",
    "shard.budget.refused", "shard.budget.unknown_node",
    "shard.budget.mirror_syncs", "shard.budget.reports",
    "sched.bind_mirror_refusals", "storage.shard.wrong_shard_refused",
    "storage.shard.frozen_refused", "storage.shard.handoff_objects",
    "storage.shard.seed_objects", "storage.shard.purged_objects",
    "informer.reconnect")


class ShardPodWatch:
    """A ``ShardedWatch`` on every pod, read on a thread: per pod the node
    it was first seen bound to and when, the bind transitions seen
    (unbound or unseen to bound: exactly one a pod), pods seen on a
    second node, and plain pods seen deleted."""

    def __init__(self, sstore: Any):
        self.watch, _ = sstore.watch("Pod", send_initial=True)
        self.nodes: Dict[str, str] = {}
        self.bind_t: Dict[str, float] = {}
        self.transitions: Dict[str, int] = defaultdict(int)
        self.moved: List[str] = []
        self.deleted: List[str] = []
        self.events = 0
        self.last_bind_t = 0.0
        self._state: Dict[str, str] = {}
        self._mu = threading.Lock()
        self._closing = False
        self._thread = threading.Thread(target=self._read, daemon=True,
                                        name="shard-pod-watch")
        self._thread.start()

    def _read(self) -> None:
        while not self._closing:
            batch = self.watch.next_batch(timeout=0.25)
            if not batch:
                if self.watch.stopped:
                    return
                continue
            now = time.monotonic()
            with self._mu:
                for ev in batch:
                    self.events += 1
                    key = (f"{ev.obj.metadata.namespace}/"
                           f"{ev.obj.metadata.name}")
                    name = ev.obj.metadata.name
                    if ev.type.name == "DELETED":
                        self.deleted.append(key)
                        self._state.pop(key, None)
                        continue
                    node = ev.obj.spec.node_name
                    if node and not self._state.get(key):
                        self.transitions[name] += 1
                        if name not in self.nodes:
                            self.nodes[name] = node
                            self.bind_t[name] = now
                            self.last_bind_t = now
                    if node and self.nodes.get(name, node) != node:
                        self.moved.append(name)
                    self._state[key] = node

    def bound(self) -> int:
        with self._mu:
            return len(self.nodes)

    def pending_by_ns(self, pods: Sequence[Any]) -> Dict[str, int]:
        with self._mu:
            out: Dict[str, int] = defaultdict(int)
            for p in pods:
                if p.metadata.name not in self.nodes:
                    out[p.metadata.namespace] += 1
            return dict(out)

    def close(self) -> None:
        self._closing = True
        self.watch.stop()
        self._thread.join(timeout=30)


def _metrics_counters(base: str, names: Sequence[str]) -> Dict[str, int]:
    """``names`` off one façade's ``/metrics`` (0 when absent)."""
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        _types, samples = hist.parse_prometheus(r.read().decode())
    got = {n: v for n, _l, v in samples}
    return {name: int(got.get(name.replace(".", "_"), 0)) for name in names}


def shard_tenants(n: int = 8, groups: Sequence[str] = ("g0", "g1")
                  ) -> List[str]:
    """``n`` tenant namespaces, as many owned by each group, picked as
    ``bench.py`` ``bench_shard`` picks its writers' (``bench-ns-NNN`` in
    order through a probe topology: placement hashes only group ids)
    and interleaved group by group."""
    from minisched_tpu_torch.controlplane.shards import ShardTopology

    probe = ShardTopology({g: [f"http://{g}"] for g in groups})
    per: Dict[str, List[str]] = {g: [] for g in groups}
    i = 0
    while any(len(v) < n // len(groups) for v in per.values()):
        ns = f"bench-ns-{i:03d}"
        if len(per[probe.owner(ns)]) < n // len(groups):
            per[probe.owner(ns)].append(ns)
        i += 1
    return [per[g][j] for j in range(n // len(groups)) for g in groups]


def run_config5_sharded(workdir: str, n_nodes: int = 10_000,
                        n_pods: int = 12_500, split_binds: int = 2_500,
                        device: Any = None, chunk: int = 10_000,
                        timeout_s: float = 900.0, max_wave: int = 1024,
                        pipeline: bool = True, n_tenants: int = 8
                        ) -> ShardedRun:
    """Config 5 scheduled over two leader groups of a sharded write plane
    through a live split of its busiest home tenant.

    ``ShardedPlane(workdir, k=2, replicas_per_group=1, fsync=False)`` (one
    replica a group, as ``bench_shard``; each child host code with no CUDA
    context).  Config 5's nodes are cluster-scoped and land on the home
    group (the owner of ""); its pods are spread round-robin over
    ``n_tenants`` namespaces, half owned by each group
    (``shard_tenants``), and carry the uids an unsharded in-process store
    would mint for the same creates (``pod-{n_nodes + i + 1:08d}``): each
    group mints from its own sequence.  Everything is created through
    ``ShardedClient`` in batch creates of ``chunk``.  Then
    ``SchedulerService(ShardedClient(seeds, retries=REMOTE_RETRIES))``
    starts ``default_full_roster_config()`` with ``device_mode=True``
    (pipelined unless ``pipeline=False``, waves of ``max_wave``) on
    ``device``; a ``ShardPodWatch`` (the merged vector-cursor watch) reads
    every pod.  Once it has seen ``split_binds`` binds, ``plane.split``
    moves ``hot_ns``, the home group's tenant with the most pods pending,
    to the other group.  The engine goes on without a restart: its writes
    chase 421s and wait out the freeze, its informers ride the vector
    cursor.

    The run raises unless: every plain pod bound and no ``special*`` pod;
    0 loop errors, the assume and Permit ledgers empty; ``hot_ns``'s
    objects all on the target and none on the source; the freeze shorter
    than ``freeze_ttl_s()``; every bind watched before the split on the
    same node at the end; each plain pod's bind seen exactly once by the
    merged watch, none seen on a second node or deleted; no node over its
    allocatable counting both groups' bound pods (``audit_store`` over
    both listings); no double bind in either WAL; ``python3 -m
    minisched_tpu_torch fsck`` exit 0 on both; the children and this
    run's threads gone.  Counters and histograms of this process are
    reset first."""
    from minisched_tpu_torch.controlplane.remote import RemoteStore
    from minisched_tpu_torch.controlplane.shards import (
        BudgetMirror,
        ShardedClient,
        ShardedPlane,
        _raw_req,
        freeze_ttl_s,
    )

    tenants = shard_tenants(n_tenants)
    nodes, pods = mk_c5_cluster(n_nodes, n_pods, namespaces=tenants)
    for i, p in enumerate(pods):
        p.metadata.uid = f"pod-{n_nodes + i + 1:08d}"
    plain = [p.metadata.name for p in pods
             if not p.metadata.name.startswith("special")]
    hist.reset()
    counters.reset()
    before = set(threading.enumerate())
    plane = ShardedPlane(workdir, k=2, replicas_per_group=1, fsync=False)
    home = plane.topology.owner("")
    other = next(g for g in plane.topology.groups if g != home)
    owners = {ns: plane.topology.owner(ns) for ns in tenants}
    svc = watch = sched_client = client = None
    try:
        seeds = plane.start()
        client = ShardedClient(seeds, retries=REMOTE_RETRIES)
        t0 = time.monotonic()
        for i in range(0, len(nodes), chunk):
            client.nodes().create_many(nodes[i:i + chunk],
                                       return_objects=False)
        for i in range(0, len(pods), chunk):
            client.pods().create_many(pods[i:i + chunk],
                                      return_objects=False)
        create_s = time.monotonic() - t0
        # the budget document the other group pulls every sync interval
        home_url = plane.leader(home).base_url
        t1 = time.monotonic()
        status, doc = _raw_req(home_url, "GET", "/shards/budget",
                               timeout_s=120.0)
        serve_s = time.monotonic() - t1
        if status != 200 or len(doc.get("nodes") or {}) != n_nodes:
            raise AssertionError(f"sharded config 5: budget doc HTTP "
                                 f"{status}, {len(doc.get('nodes') or {})} "
                                 f"nodes")
        t1 = time.monotonic()
        BudgetMirror(other).update(doc)
        apply_s = time.monotonic() - t1
        budget_doc = {"bytes": float(len(json.dumps(doc))),
                      "serve_s": serve_s, "apply_s": apply_s}
        del doc
        watch = ShardPodWatch(client.store)
        sched_client = ShardedClient(seeds, retries=REMOTE_RETRIES)
        svc = SchedulerService(sched_client)
        t0 = time.monotonic()
        sched = svc.start_scheduler(default_full_roster_config(),
                                    device_mode=True, max_wave=max_wave,
                                    device=device, pipeline=pipeline)
        t_loop = time.monotonic()
        sync_s = t_loop - t0
        metrics = sched.metrics = CycleMetrics()
        sched.assume_ttl_s = QUIESCE_TTL_S
        wait_until(lambda: watch.bound() >= split_binds, timeout_s,
                   f"{split_binds} binds watched before the split", sched)
        # -- the split: the home group's busiest tenant moves -----------
        pending = watch.pending_by_ns(pods)
        hot_ns = max((ns for ns in tenants if owners[ns] == home),
                     key=lambda ns: (pending.get(ns, 0), ns))
        with watch._mu:
            seen = dict(watch.nodes)
        t_split = time.monotonic()
        result = plane.split(hot_ns, other)
        split_at_s = t_split - t_loop
        if len(seen) >= len(plain):
            raise AssertionError(f"sharded config 5: every plain pod bound "
                                 f"before the split ({len(seen)})")
        want = set(plain)
        wait_until(lambda: want <= set(watch.nodes), timeout_s,
                   f"{len(want)} plain pods seen bound after the split",
                   sched)
        after_s = watch.last_bind_t - t_split
        wait_until(lambda: sched.assumed_count() == 0, QUIESCE_TTL_S * 20,
                   "the assume cache drained", sched)
        waves = int(metrics.snapshot().get("wave", {}).get("count", 0))
        waiting_left = len(sched._waiting_pods)
        loop_errors, assumed_left = sched.loop_errors, sched.assumed_count()
        phases = split(metrics)
        svc.shutdown_scheduler()
        svc.recorder.close()
        svc = None
        watched, watch = watch, None
        watched.close()
        # -- the final state, each group read directly ------------------
        listings: Dict[str, List[Any]] = {}
        for gid in plane.groups:
            rs = RemoteStore(plane.leader(gid).base_url, retries=4)
            try:
                listings[gid] = rs.list("Pod")
            finally:
                rs.close()
        hot_left = {gid: sum(p.metadata.namespace == hot_ns for p in ps)
                    for gid, ps in listings.items()}
        owned = [p for gid, ps in listings.items() for p in ps
                 if plane.topology.owner(p.metadata.namespace) == gid]
        audit = audit_store(client, pods=owned)
        placements = {p.metadata.name: p.spec.node_name for p in owned}
        group_counters: Dict[str, int] = defaultdict(int)
        for gid in plane.groups:
            got = _metrics_counters(plane.leader(gid).base_url,
                                    SHARDED_COUNTERS)
            for k, v in got.items():
                group_counters[k] += v
    finally:
        if svc is not None:
            svc.shutdown_scheduler()
        if watch is not None:
            watch.close()
        for c in (client, sched_client):
            if c is not None:
                c.store.close()
        plane.stop()
    left = sorted(t.name for t in set(threading.enumerate()) - before
                  if t.is_alive() and not t.daemon)
    children_left = [r.replica_id for g in plane.groups.values()
                     for r in g.replicas if r.alive()]
    wals = {gid: g.replicas[0].wal_path for gid, g in plane.groups.items()}
    t1 = time.monotonic()
    gids = sorted(wals)
    offline = _audit_wals(wals, digested=set(), fsck_wal=wals[gids[0]],
                          more_fsck=[wals[g] for g in gids[1:]])
    fsck_rc = {gids[0]: offline[None][0]}
    fsck_rc.update({g: offline[("fsck", wals[g])][0] for g in gids[1:]})
    double = {g: offline[g]["double"] for g in gids}
    fsck_s = time.monotonic() - t1
    unbound = [n for n in plain if not placements.get(n)]
    special_bound = [n for n, node in placements.items()
                     if n.startswith("special") and node]
    moved = [(n, node, placements.get(n)) for n, node in seen.items()
             if placements.get(n) != node]
    twice = [n for n in plain if watched.transitions.get(n, 0) != 1]
    deleted = [k for k in watched.deleted
               if not k.rsplit("/", 1)[1].startswith("special")]
    ttl = freeze_ttl_s()
    problems = {
        "unbound": unbound[:3], "special bound": special_bound[:3],
        "moved": moved[:3], "binds not seen once": twice[:3],
        "seen on two nodes": watched.moved[:3], "plain pods deleted":
        deleted[:3], "hot_ns on the source": hot_left.get(home, 0),
        "hot_ns missing on the target":
        hot_left.get(other, 0) != sum(p.metadata.namespace == hot_ns
                                      for p in pods),
        "loop errors": loop_errors, "assumed left": assumed_left,
        "waiting left": waiting_left, "double binds": sum(double.values()),
        "fsck": {g: rc for g, rc in fsck_rc.items() if rc},
        "freeze over the TTL": result["freeze_s"] >= ttl,
        "nodes": audit["nodes"] != n_nodes, "threads left": left,
        "children left": children_left}
    bad = {k: v for k, v in problems.items() if v}
    if bad:
        raise AssertionError(f"sharded config 5 (split {result}): {bad}")
    hot_t = [watched.bind_t[n] - t_loop for n, p in
             ((p.metadata.name, p) for p in pods)
             if p.metadata.namespace == hot_ns and n in watched.bind_t
             and watched.bind_t[n] >= t_split]
    rest_t = [watched.bind_t[n] - t_loop for n, p in
              ((p.metadata.name, p) for p in pods)
              if p.metadata.namespace != hot_ns and n in watched.bind_t
              and watched.bind_t[n] >= t_split]
    from minisched_tpu_torch.bench import _pct

    ttb = {name: {"p50": _pct(sorted(ts), 0.5, 6) if ts else 0.0,
                  "p99": _pct(sorted(ts), 0.99, 6) if ts else 0.0,
                  "n": float(len(ts))}
           for name, ts in (("hot", hot_t), ("other", rest_t))}
    snap = counters.snapshot()
    all_counters = {k: snap.get(k, 0) + group_counters.get(k, 0)
                    for k in SHARDED_COUNTERS}
    return ShardedRun(
        len(plain), owners, hot_ns, home, other, create_s, sync_s,
        budget_doc, len(seen), split_at_s, after_s, result, ttb, waves,
        loop_errors, assumed_left, waiting_left, audit,
        {"events": watched.events,
         "binds": sum(watched.transitions.values()),
         "reopens": snap.get("shard.watch_reopen", 0)},
        all_counters, hot_left, double, fsck_rc, fsck_s, placements, seen,
        phases, left, children_left)


# -- config 5 by three HA engine children through a SIGKILL of one ---------

@dataclass
class HARun:
    n_plain: int
    #: the creates over the wire: the nodes and ``special*`` pods before
    #: the engines, the first four fifths of the plain pods once all were
    #: ready, and the last fifth after the kill
    create_s: Dict[str, float]
    #: per engine: spawn to its member lease live, and its child's start
    #: to a running engine (``ha.engine_ready_ms``); and the first spawn
    #: to every engine running
    boot_s: Dict[str, float]
    ready_s: Dict[str, float]
    start_s: float
    victim: str
    #: binds the watch had seen at the SIGKILL, and the seconds from the
    #: first plain create to the kill
    seen_at_kill: int
    kill_s: float
    #: seconds from the kill: to every survivor publishing an epoch past
    #: its pre-kill one with the victim gone from the live set, to the
    #: last survivor's resync having queued the orphaned pods (its
    #: ``ha.shard_adopt_unix_ms``), to the first bind the watch saw after
    #: it, and to the last plain bind
    adopt_s: float
    resync_s: float
    next_bind_s: float
    after_s: float
    #: per engine, off its child's ``/metrics`` just before the kill:
    #: binds (``engine.pods_bound``) and the ``ha.*`` counters
    binds_before: Dict[str, int]
    ha_before: Dict[str, Dict[str, int]]
    #: per engine, off its child's ``/metrics`` (the victim's just before
    #: the kill, the survivors' at the end): binds (``engine.pods_bound``),
    #: ``select_hosts`` launches,
    #: plain-twin calls, loop errors, peak device memory and ``ha.*``
    binds: Dict[str, int]
    launches: Dict[str, int]
    plain_calls: Dict[str, int]
    loop_errors: Dict[str, int]
    peak_bytes: Dict[str, int]
    ha_counters: Dict[str, Dict[str, int]]
    #: per engine: its renewals (``ha.heartbeat_s``), the gaps between
    #: their starts (``ha.renew_gap_s``, with the widest) and its view
    #: ticks (``ha.view_s``): count and the p50 and p99 bucket upper
    #: bounds (seconds)
    heartbeat: Dict[str, Dict[str, Any]]
    adopted: int
    audit: Dict[str, int]
    double_binds: int
    fsck_rc: int
    fsck_s: float
    children_left: List[str]
    threads_left: List[str]


#: the ``ha.*`` counters ``run_config5_ha`` reads off each engine child
HA_COUNTERS = ("ha.member_join", "ha.epoch_bump", "ha.member_lost",
               "ha.lease_expired", "ha.lease_renew", "ha.lease_lost",
               "ha.shard_adopt", "ha.shard_adopt_pods",
               "ha.expiry_unconfirmed", "assume.revalidate_on_reconnect")
#: HA engines of ``run_config5_ha``: JAX's ``bench_ha`` and
#: ``test_ha_engine_kill_smoke`` run three, and kill the middle one
HA_ENGINES = 3
HA_TTL_S = 2.0


def _ha_timings(metrics_url: str) -> Dict[str, Any]:
    """An engine child's renewals, renewal gaps and view ticks off its
    ``/metrics``: per histogram its count and the p50 and p99 bucket
    upper bounds (seconds; None when empty), and the widest gap."""
    with urllib.request.urlopen(metrics_url, timeout=60) as r:
        _types, samples = hist.parse_prometheus(r.read().decode())
    out: Dict[str, Any] = {}
    for key, name in (("renew", "ha_heartbeat_seconds"),
                      ("gap", "ha_renew_gap_seconds"),
                      ("view", "ha_view_seconds")):
        p50 = hist.parsed_histogram_quantile(samples, name, 0.5)
        p99 = hist.parsed_histogram_quantile(samples, name, 0.99)
        out[key] = {"n": int(sum(v for n, _l, v in samples
                                 if n == name + "_count")),
                    "p50_le_s": p50[1] if p50 else None,
                    "p99_le_s": p99[1] if p99 else None}
    out["gap_max_s"] = sum(v for n, _l, v in samples
                           if n == "ha_renew_gap_max_ms") / 1000.0
    return out


def _member_leases(base: str) -> Dict[str, Any]:
    """holder → member Lease, read off the façade."""
    from minisched_tpu_torch.controlplane.remote import RemoteStore
    from minisched_tpu_torch.ha.lease import HA_NAMESPACE
    from minisched_tpu_torch.ha.membership import MEMBER_PREFIX

    rs = RemoteStore(base, retries=2, timeout_s=10.0)
    try:
        return {l.spec.holder: l for l in rs.list("Lease")
                if l.metadata.namespace == HA_NAMESPACE
                and l.metadata.name.startswith(MEMBER_PREFIX)}
    finally:
        rs.close()


def run_config5_ha(workdir: str, n_nodes: int = 10_000,
                   n_pods: int = 12_500, kill_binds: int = 2_500,
                   device: str = "cuda", n_engines: int = HA_ENGINES,
                   ttl_s: float = HA_TTL_S, max_wave: int = 1024,
                   chunk: int = 10_000, timeout_s: float = 600.0,
                   boot_timeout_s: float = 300.0) -> HARun:
    """Config 5 scheduled by ``n_engines`` active-active HA device engines,
    each a child process, through a SIGKILL of one.

    The control plane is a ``faults.proc.ServerSupervisor`` child over
    ``<workdir>/ha.wal`` (``archive_history=True``, fsync off).  Config
    5's nodes and ``special*`` pods are created over the wire; then
    ``ha.proc.EngineSupervisor`` children ``engine-0..n-1`` start side by
    side, each ``ha.plane.start_ha_engine`` over a ``RemoteClient`` with
    the full roster, the device engine on ``device``, ``max_wave`` (JAX's
    ``start_scheduler`` default, 1,024; JAX's child default is 64) and
    lease TTL ``ttl_s``.  Once every engine runs, a ``PodWatch`` opens and
    the first four fifths of the plain pods are created in batch creates
    of ``chunk``; each engine admits its rendezvous shard.  When the watch
    has seen ``kill_binds`` binds and every engine has bound its share of
    them (a ``n_engines``-th, off its ``/metrics``), every engine's counts
    are read, the middle engine (``bench_ha``'s pick) is SIGKILLed with
    its lease abandoned, and the last
    fifth of the plain pods is created.  The survivors must drop it from
    their live set and publish a new epoch within ``ttl + ttl/3 + 1.5`` s
    (``test_ha_chaos.py:149-153``), adopt its shard and bind the rest.

    Raises unless adoption met that bound, both as the survivors' leases
    publish it and as their resyncs stamp it; no engine dropped a live
    peer (before the kill no ``ha.lease_expired`` or ``ha.member_lost``
    anywhere, at the end exactly one of each on every survivor); every
    engine bound its share of ``kill_binds`` before the kill (else the
    wait for it times out); every plain pod is bound, on
    the node the watch first saw, and no ``special*`` pod; the audit holds
    over every bind; the archived WAL holds no double bind and ``python3
    -m minisched_tpu_torch fsck`` exits 0; every engine launched
    ``select_hosts`` and called no plain twin and counted no loop error;
    and no child is left.  (On the CPU each engine must have called the
    plain twin instead.)"""
    from minisched_tpu_torch.controlplane.remote import RemoteClient
    from minisched_tpu_torch.faults.proc import ServerSupervisor
    from minisched_tpu_torch.ha.proc import EngineSupervisor

    nodes, pods = mk_c5_cluster(n_nodes, n_pods)
    plain_pods = [p for p in pods
                  if not p.metadata.name.startswith("special")]
    specials = [p for p in pods if p.metadata.name.startswith("special")]
    plain = [p.metadata.name for p in plain_pods]
    first = len(plain_pods) * 4 // 5
    wal = os.path.join(workdir, "ha.wal")
    before = set(threading.enumerate())
    sup = ServerSupervisor(wal, archive_history=True, boot_timeout_s=300.0)
    base = sup.start()
    engines = [EngineSupervisor(base, f"engine-{i}", ttl_s=ttl_s,
                                max_wave=max_wave, device=device,
                                metrics_port=0,
                                boot_timeout_s=boot_timeout_s)
               for i in range(n_engines)]
    victim = engines[len(engines) // 2]
    survivors = [e for e in engines if e is not victim]
    client = None
    watch = None
    create_s: Dict[str, float] = {}
    got: Dict[str, Dict[str, float]] = {}
    try:
        client = RemoteClient(base, retries=REMOTE_RETRIES)
        t0 = time.monotonic()
        for i in range(0, len(nodes), chunk):
            client.nodes().create_many(nodes[i:i + chunk],
                                       return_objects=False)
        client.pods().create_many(specials, return_objects=False)
        create_s["setup"] = time.monotonic() - t0
        # -- the engines, side by side ------------------------------------
        errors: List[BaseException] = []

        def boot(e: EngineSupervisor) -> None:
            try:
                e.start()
            except BaseException as err:  # re-raised below
                errors.append(err)

        t_spawn = time.monotonic()
        starters = [threading.Thread(target=boot, args=(e,))
                    for e in engines]
        for t in starters:
            t.start()
        for t in starters:
            t.join()
        if errors:
            raise errors[0]
        ready_s: Dict[str, float] = {}
        deadline = time.monotonic() + boot_timeout_s
        while len(ready_s) < len(engines):
            for e in engines:
                if e.engine_id not in ready_s:
                    ms = e.scrape().get("ha_engine_ready_ms")
                    if ms is not None:
                        ready_s[e.engine_id] = ms / 1000.0
            if time.monotonic() > deadline or not all(
                    e.alive() for e in engines):
                raise AssertionError(f"HA config 5: engines ready "
                                     f"{sorted(ready_s)} of {n_engines}")
            time.sleep(0.1)
        start_s = time.monotonic() - t_spawn
        # -- the pods, and the kill ----------------------------------------
        watch = PodWatch(base)
        t_create = time.monotonic()
        for i in range(0, first, chunk):
            client.pods().create_many(plain_pods[i:min(i + chunk, first)],
                                      return_objects=False)
        create_s["first"] = time.monotonic() - t_create

        def shares_bound() -> bool:
            # every engine has bound its share of the kill's binds, so the
            # kill fails over a shard that was being scheduled; on the CPU
            # the engine's waves call the plain twin instead of launching
            for e in engines:
                got = e.scrape()
                if (got.get("engine_pods_bound", 0) < kill_binds // n_engines
                        or got.get("kernel_launches_select_hosts", 0)
                        + got.get("kernel_plain_calls_select_hosts", 0) < 1):
                    return False
            return True

        deadline = time.monotonic() + timeout_s
        while not (len(watch.nodes) >= kill_binds and shares_bound()):
            if watch.error is not None or time.monotonic() > deadline:
                raise AssertionError(f"HA config 5: {len(watch.nodes)} "
                                     f"binds seen before the kill (watch "
                                     f"{watch.error!r})")
            time.sleep(0.05)
        pre_epochs = {h: l.spec.epoch
                      for h, l in _member_leases(base).items()}
        seen = dict(watch.nodes)
        before_kill = {e.engine_id: e.scrape() for e in survivors}
        beats = {victim.engine_id: _ha_timings(victim.metrics_url)}
        # the victim's counts as late as can be: a bind batch committed
        # between this read and the kill is not in them
        got[victim.engine_id] = before_kill[victim.engine_id] = (
            victim.scrape())
        t_kill = time.monotonic()
        kill_wall = time.time()
        victim.kill()
        kill_s = t_kill - t_create
        n_before_kill = len(watch.bind_times)
        t1 = time.monotonic()
        client.pods().create_many(plain_pods[first:], return_objects=False)
        create_s["after_kill"] = time.monotonic() - t1
        # -- adoption: the survivors' published view moves past the kill ---
        names = {e.engine_id for e in survivors}
        adopt_s = -1.0
        deadline = t_kill + 10 * ttl_s
        while time.monotonic() < deadline:
            try:
                leases = _member_leases(base)
            except Exception:
                time.sleep(0.05)
                continue
            now = time.time()
            live = {h for h, l in leases.items() if not l.expired(now)}
            if live == names and all(
                    leases[h].spec.epoch > pre_epochs.get(h, 0)
                    for h in names):
                adopt_s = time.monotonic() - t_kill
                break
            time.sleep(0.05)
        deadline = time.monotonic() + timeout_s
        want = set(plain)
        while not want <= set(watch.nodes):
            if watch.error is not None or time.monotonic() > deadline:
                raise AssertionError(
                    f"HA config 5: {len(want & set(watch.nodes))} of "
                    f"{len(want)} plain pods seen bound (watch "
                    f"{watch.error!r}, survivors alive "
                    f"{[e.alive() for e in survivors]})")
            time.sleep(0.05)
        after_s = watch.last_bind_t - t_kill
        later = watch.bind_times[n_before_kill:]
        next_bind_s = later[0] - t_kill if later else -1.0
        for e in survivors:
            got[e.engine_id] = e.scrape()
            beats[e.engine_id] = _ha_timings(e.metrics_url)
        pod_list = client.pods().list()
        audit = audit_store(client, pods=pod_list)
        final = {p.metadata.name: p.spec.node_name for p in pod_list}
        del pod_list
    finally:
        if watch is not None:
            watch._closing = True
            watch._resp.close()
        if client is not None:
            client.store.close()
        for e in engines:
            e.stop()
        sup.stop()
    if watch is not None:
        watch._thread.join(timeout=30)
    children_left = [e.engine_id for e in engines if e.alive()]
    if sup.alive():
        children_left.append("control plane")
    left = sorted(t.name for t in set(threading.enumerate()) - before
                  if t.is_alive() and not t.daemon)
    t1 = time.monotonic()
    offline = _audit_wals({"ha": wal}, digested=set(), fsck_wal=wal)
    fsck_rc, fsck_out = offline[None]
    double = offline["ha"]["double"]
    fsck_s = time.monotonic() - t1

    def each(metric: str) -> Dict[str, int]:
        return {k: int(v.get(metric, 0)) for k, v in got.items()}

    binds = each("engine_pods_bound")
    launches = each("kernel_launches_select_hosts")
    plain_calls = {k: int(v.get("kernel_plain_calls_select_hosts", 0)
                          + v.get("kernel_plain_calls_nodenumber_select_"
                                  "hosts", 0)) for k, v in got.items()}
    loop_errors = each("engine_loop_errors")
    ha_counters = {k: {c: int(v.get(c.replace(".", "_"), 0))
                       for c in HA_COUNTERS} for k, v in got.items()}
    ha_before = {k: {c: int(v.get(c.replace(".", "_"), 0))
                     for c in HA_COUNTERS} for k, v in before_kill.items()}
    binds_before = {k: int(v.get("engine_pods_bound", 0))
                    for k, v in before_kill.items()}
    stamps = [got.get(e.engine_id, {}).get("ha_shard_adopt_unix_ms", 0)
              / 1000.0 for e in survivors]
    resync_s = (max(stamps) - kill_wall if min(stamps) > kill_wall
                else -1.0)
    # a live peer dropped anywhere is a false expiry: before the kill no
    # engine lost a member; after it each survivor lost the victim once
    flaps = {k: (c["ha.lease_expired"], c["ha.member_lost"])
             for k, c in ha_before.items() if c["ha.lease_expired"]
             or c["ha.member_lost"]}
    flaps.update({e.engine_id: (ha_counters[e.engine_id]["ha.lease_expired"],
                                ha_counters[e.engine_id]["ha.member_lost"])
                  for e in survivors
                  if (ha_counters[e.engine_id]["ha.lease_expired"],
                      ha_counters[e.engine_id]["ha.member_lost"]) != (1, 1)})
    unbound = [n for n in plain if not final.get(n)]
    special_bound = [n for n, node in final.items()
                     if n.startswith("special") and node]
    moved = [(n, node, final.get(n)) for n, node in watch.nodes.items()
             if final.get(n) != node]
    gate = ttl_s + ttl_s / 3.0 + 1.5
    on_card = device.startswith("cuda")
    problems = {
        "adoption": adopt_s < 0 or adopt_s > gate,
        "resync adoption": resync_s < 0 or resync_s > gate,
        "false expiries": flaps,
        "pre-kill share": {k: n for k, n in binds_before.items()
                           if n < kill_binds // n_engines},
        "unbound": unbound[:3], "special bound": special_bound[:3],
        "moved": moved[:3], "double binds": double,
        "fsck": fsck_rc and fsck_out[-500:],
        "no launch": [k for k, n in (launches if on_card
                                     else plain_calls).items() if n < 1],
        "plain twin": on_card and {k: n for k, n in plain_calls.items()
                                   if n},
        "loop errors": {k: n for k, n in loop_errors.items() if n},
        "engines read": sorted(got) != sorted(e.engine_id for e in engines),
        "nodes": audit["nodes"] != n_nodes,
        "children left": children_left, "threads left": left}
    bad = {k: v for k, v in problems.items() if v}
    if bad:
        raise AssertionError(f"HA config 5 (adoption {adopt_s:.3f}s, "
                             f"resync {resync_s:.3f}s, gate {gate:.3f}s, "
                             f"binds before the kill {binds_before}): "
                             f"{bad}")
    return HARun(
        len(plain), create_s,
        {e.engine_id: e.boot_s for e in engines}, ready_s, start_s,
        victim.engine_id, len(seen), kill_s, adopt_s, resync_s, next_bind_s,
        after_s, binds_before, ha_before, binds, launches, plain_calls, loop_errors,
        each("cuda_peak_allocated_bytes"), ha_counters, beats,
        sum(ha_counters[e.engine_id]["ha.shard_adopt_pods"]
            for e in survivors),
        audit, double, fsck_rc, fsck_s, children_left, left)
