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

from minisched_tpu_torch.api.objects import gang_key, make_pod
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
            "wave_build.full", "wave_build.dirty_rows")
#: assume-lease TTL of the live runs: at quiesce the last wave's
#: assumptions drain when their leases run out (``bench.py`` ``bench_gang``
#: sets the same)
QUIESCE_TTL_S = 3.0
#: a preemptor of the burst: 4 CPU and 1 Gi at priority 100
BURST_CPU_M = 4_000
BURST_PRIORITY = 100


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
                     after_setup: Optional[Callable[[Client], None]] = None
                     ) -> LiveRun:
    """Config 5 (with ``n_crosspod`` spread pods) through the live engine,
    park and requeue included; ``pipeline=False`` runs the serial loop.
    ``preempt_burst`` preemptors follow once every pod is bound
    (``LiveRun.burst``); ``before_burst`` is called just before they are
    created (the run's other fields stop there).  ``after_setup`` is
    called with the client once the cluster is in the store, just before
    the engine starts (a watch opened there sees every bind)."""
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
                                pipeline=pipeline)
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
        phases = split(metrics)
        waves = metrics.snapshot().get("wave", {}).get("count", 0)
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

#: ``python3 -c`` body of the façade child: ``start_api_server`` over
#: ``store_from_url(argv[1])`` on port ``argv[2]``; prints one JSON line
#: (base URL, the store's replay seconds, the plain pods unbound at boot)
#: once ``/healthz`` answers, and stops cleanly on SIGTERM
FACADE_CHILD = """
import json, signal, sys, threading, time
from minisched_tpu_torch.controlplane.durable import store_from_url
from minisched_tpu_torch.controlplane.httpserver import start_api_server
store = store_from_url(sys.argv[1])
with store.locked():
    pods = list(store._objects.get("Pod", {}).values())
unbound = sum(1 for p in pods if not p.spec.node_name
              and not p.metadata.name.startswith("special"))
del pods
_server, base, stop = start_api_server(store, port=int(sys.argv[2]))
done = threading.Event()
signal.signal(signal.SIGTERM, lambda *_: done.set())
print(json.dumps({"base": base, "replay_s": store.replay_s,
                  "unbound": unbound}), flush=True)
done.wait()
stop()
store.close()
"""


class FacadeChild:
    """The port's REST façade in a child process over a ``file://`` WAL
    (``FACADE_CHILD``); ``info`` is its JSON line, ``boot_s`` the seconds
    from the spawn to that line."""

    def __init__(self, url: str, port: int, timeout_s: float = 300.0):
        t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", FACADE_CHILD, url, str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines: List[str] = []
        ready = threading.Event()
        self.info: Dict[str, Any] = {}

        def read() -> None:
            # read to the end, so the child never blocks on a full pipe
            for line in self.proc.stdout:
                self.lines.append(line)
                if not self.info and line.startswith('{"base"'):
                    self.info = json.loads(line)
                    ready.set()
            ready.set()

        self._reader = threading.Thread(target=read, daemon=True)
        self._reader.start()
        ready.wait(timeout_s)
        if not self.info:
            self.kill()
            raise AssertionError(f"façade child: no ready line "
                                 f"({self.lines[-20:]})")
        self.boot_s = time.monotonic() - t0

    def kill(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=60)
        self._reader.join(10)

    def stop(self) -> int:
        """SIGTERM, then the exit code (SIGKILL after 60 s)."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.kill()
            return self.proc.returncode
        finally:
            self._reader.join(10)


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

    The port's ``start_api_server`` runs in a child (``FacadeChild``) over
    ``store_from_url("file://<workdir>/remote.wal")`` on a ``free_port``
    (the stream loop on, fsync off).  A ``PodWatch`` opens first; config
    5's nodes and pods are created with ``RemoteClient(base)`` in batch
    creates of ``chunk`` (``return_objects=False``).  Then
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

    nodes, pods = mk_c5_cluster(n_nodes, n_pods)
    plain = [p.metadata.name for p in pods
             if not p.metadata.name.startswith("special")]
    wal = os.path.join(workdir, "remote.wal")
    url = f"file://{wal}"
    port = free_port()
    hist.reset()
    counters.reset()
    before = set(threading.enumerate())
    child = FacadeChild(url, port)
    base = child.info["base"]
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
        child.kill()
        kill_s = time.monotonic() - t_loop
        seen = dict(watch.nodes)
        watch.join()
        if len(seen) < kill_binds:
            raise AssertionError(f"remote config 5: {len(seen)} binds seen "
                                 f"before the kill, not {kill_binds} "
                                 f"(watch {watch.error!r})")
        # -- the restart: same port, same WAL ---------------------------------
        child = FacadeChild(url, port)
        t_ready = time.monotonic()
        left_at_boot = int(child.info["unbound"])
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
                       + child.boot_s if watch2.first_live_bind_t else -1.0)
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
        rc = child.stop() if child.proc.poll() is None else None
    if rc != 0:
        raise AssertionError(f"façade child exit {rc}: "
                             f"{''.join(child.lines[-20:])}")
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
        float(child.info["replay_s"]), child.boot_s, left_at_boot,
        next_bind_s, bind_s, waves, loop_errors, assumed_left, waiting_left,
        audit, reconnects, {k: snap.get(k, 0) for k in REMOTE_COUNTERS},
        decode_s, decoded, len(double), fsck_proc.returncode, fsck_s,
        phases, left, watch.reconnects + watch2.reconnects)
