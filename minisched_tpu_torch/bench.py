"""Bench roles of the port: one JSON record per role, on the card.

Run from the root of the repository on a machine with a CUDA card:

    python3 -m minisched_tpu_torch.bench [--only ROLE]

One role for each ``bench.py`` role the port can run (``ROLES``):

======================  ==================================================
``headline``            ``bench_headline`` (``bench.py:998``): 10,000
                        nodes x 100,000 pods, the fused route, every
                        placement against ``headline_oracle``
``c1``                  ``bench_config1`` (``:146``): the README scenario
                        through the live engine; ``node10`` must bind
``c2``                  ``bench_config2`` (``:160``): 1,000 x 1,000, one
                        NodeNumber wave
``c3``                  ``bench_config3`` (``:185``): the exact scan, every
                        placement against ``FullRosterScanOracle``
``c4``                  ``bench_config4`` (``:294``): the affinity and
                        spread wave
``c5``                  config 5 (``:469-640``) through the live engine
                        (``live.run_config5_live``, pipelined as the JAX
                        engine runs by default): first drain, the label
                        update that requeues the parked pods, requeue
                        tail, total, the engine's ``CycleMetrics`` split
                        and the audit from the store
``c5x_live``            config 5 with 5,000 spread pods through the live
                        engine (``BENCH_C5_CROSSPOD=5000``): the spread
                        pods deferred into the backlog and placed by the
                        scan lanes, with the spread audit
``c5_waves``            config 5 in full-roster repair waves through the
                        one-shot wave driver, with config 5's audit
``fullchain_parity``    ``bench_fullchain_parity`` (``:810``): the exact
                        scan over all 100,000 pods of config 5 against
                        ``fullchain_scan_oracle``
``c5x``                 config 5 with 5,000 spread pods
                        (``BENCH_C5_CROSSPOD``, ``_c5_cluster(n_crosspod=
                        5000)`` at ``:406-466``): repair waves, then the
                        blocked lane, with the spread audit
``gang_waves``          config 5 with 4,096 gangs
                        (``fullchain.mk_c5_gang_cluster``) in repair waves
                        with ``gang_roster_config``: the wave path only,
                        the share of gangs on one slice reported
``wave``                ``bench_wave_pipeline`` (``:1808``): two laps of
                        the pipelined live engine, gated on the stall
                        share (stall under build); skipped under
                        ``MINISCHED_PIPELINE=0``
``gang``                ``bench_gang`` (``:3159``): churn rounds of gangs
                        and singletons on a sliced cluster through the
                        live engine, then a deadlock probe; gated on no
                        stranded partial gang, empty assume and Permit
                        ledgers, no node over allocatable; locality
                        reported
``churn``               ``bench_churn`` (``:3468``): Poisson arrivals
                        and departures over tenants with a namespace
                        quota, preemption bursts with gangs, a quiet
                        tail; gated on p99 time to bind
                        (``BENCH_CHURN_P99_S``, 45 s) checked against
                        ``sched.time_to_bind_s``, no quota violation or
                        stalled hold, whole gangs, the idle-wave gate,
                        the shared watch encode and the audits
======================  ==================================================

The live roles read ``bench.py``'s environment knobs with its defaults
(``BENCH_WAVEROLE_*``, ``BENCH_GANG_*``, ``BENCH_CHURN_*``) and keep its
record keys.

Each record holds the role's metrics (times are host wall seconds closed
by a device synchronise; ``launches`` the role's kernel launches;
``device_ms_*`` come from the profiler or CUDA events; ``peak_mem_gib``
from ``torch.cuda.max_memory_allocated``),
``bench.py``'s key where it names the same quantity, and the card's name
and power limit (``nvidia-smi``).  Without a card a role prints
``{"skipped": reason}`` and exits 0: it never runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
import subprocess
import sys
import threading
import time
from collections import defaultdict
from types import SimpleNamespace
from typing import Any, Callable, Dict, List

import numpy as np
import torch

ROLES = ("headline", "c1", "c2", "c3", "c4", "c5", "c5_waves",
         "fullchain_parity", "c5x", "gang_waves", "c5x_live", "wave", "gang",
         "churn")

GIB = 2**30


class Skip(Exception):
    """A role this environment cannot run: its record is
    ``{"skipped": reason}`` (``bench.py``'s ``bench_skip``)."""


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _peak_reset() -> None:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / GIB


def _best_of(fn: Callable[[], Any], n: int = 3) -> float:
    """The least host wall seconds of ``n`` calls of ``fn``, each closed
    by a synchronise."""
    best = float("inf")
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.monotonic() - t0)
    return best


def _wave_record(run: Any, n_pods: int) -> Dict[str, Any]:
    return {
        "schedule_wall_s": run.schedule_s,
        "pods_per_sec": n_pods / run.schedule_s,
        "build_wall_s": run.build_s,
        "transfer_wall_s": run.h2d_s,
        "constraint_build_s": run.constraint_build_s,
        "compile_warmup_s": run.kernel_build_s + run.warmup_s,
        "waves": run.n_waves,
        "rounds": run.rounds,
        "placed": int((run.choices >= 0).sum()),
    }


def _scan_record(log: Any, wall: float, n_pods: int) -> Dict[str, Any]:
    steps = sum(s.steps for s in log.loops)
    timed = [s for s in log.loops if s.device_ms_per_step]
    ms = (sum(s.device_ms_per_step * s.steps for s in timed)
          / max(sum(s.steps for s in timed), 1))
    return {"scan_s": wall, "pods_per_sec": n_pods / wall, "steps": steps,
            "device_ms_per_step": ms,
            "capture_s": sum(s.capture_s for s in log.loops)}


def _device_ms_per_round(cfg: Any, nodes, pods, wave: int,
                         assigned=()) -> float:
    from minisched_tpu_torch.headline import make_step
    from minisched_tpu_torch.profile_repair import profile_repair

    waves = [pods[s:s + wave] for s in range(0, len(pods), wave)]
    return profile_repair(make_step("repair", cfg), nodes, waves,
                          torch.device("cuda"), reps=0,
                          assigned=assigned)["device_ms_per_round"]


def role_headline() -> Dict[str, Any]:
    from minisched_tpu_torch.engine.oracle import headline_oracle
    from minisched_tpu_torch.headline import WAVE, mk_cluster, schedule_waves

    nodes, pods = mk_cluster()
    _peak_reset()
    run = schedule_waves(nodes, pods, wave=WAVE, route="fused")
    peak = _peak_gib()
    bad = int((run.choices != headline_oracle(pods, nodes)).sum())
    if bad:
        raise AssertionError(f"headline: {bad} placements differ from "
                             "headline_oracle")
    return {"metric": "pods_scheduled_per_sec_10k_nodes_100k_pods",
            "value": len(pods) / run.schedule_s, "unit": "pods/s",
            **_wave_record(run, len(pods)), "parity_checked": len(pods),
            "peak_mem_gib": peak}


def role_c2() -> Dict[str, Any]:
    from minisched_tpu_torch.headline import mk_cluster
    from minisched_tpu_torch.models.tables import build_node_table, build_pod_table
    from minisched_tpu_torch.ops.fused import FusedEvaluator
    from minisched_tpu_torch.plugins.nodenumber import NodeNumber
    from minisched_tpu_torch.plugins.nodeunschedulable import NodeUnschedulable

    nodes, pods = mk_cluster(1000, 1000, seed=2)
    _peak_reset()
    t0 = time.monotonic()
    node_table, _ = build_node_table(nodes)
    pod_table, _ = build_pod_table(pods)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    nn = NodeNumber()
    ev = FusedEvaluator([NodeUnschedulable()], [nn], [nn])
    ev(pod_table, node_table)  # first launches
    best = _best_of(lambda: ev(pod_table, node_table).choice)
    return {"wave_ms": best * 1e3, "pods_per_sec": len(pods) / best,
            "host_build_s": build_s, "peak_mem_gib": _peak_gib()}


def role_c3() -> Dict[str, Any]:
    from minisched_tpu_torch.engine.oracle import FullRosterScanOracle
    from minisched_tpu_torch.fullchain import c3_roster_config, mk_c3_cluster
    from minisched_tpu_torch.models import tables
    from minisched_tpu_torch.ops.sequential import SequentialScheduler, StepLog
    from minisched_tpu_torch.plugins.registry import build_plugins

    nodes, pods = mk_c3_cluster()
    chains = build_plugins(c3_roster_config())
    sched = SequentialScheduler(chains.filter, chains.pre_score, chains.score)
    t0 = time.monotonic()
    node_table, _ = tables.build_node_table(nodes)
    pod_table, _ = tables.build_pod_table(pods)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    log = StepLog()
    _peak_reset()
    t0 = time.monotonic()
    _, choice, _ = sched(pod_table, node_table, log=log)
    choice = choice.cpu().numpy()[: len(pods)]
    wall = time.monotonic() - t0
    want = FullRosterScanOracle(
        nodes, tables.DEFAULT_NONZERO_CPU, tables.DEFAULT_NONZERO_MEM_MIB,
        with_balanced=False).place_all(pods)
    bad = int((choice != want).sum())
    if bad:
        raise AssertionError(f"c3: {bad} placements differ from the oracle")
    return {**_scan_record(log, wall, len(pods)), "host_build_s": build_s,
            "parity_checked": len(pods), "placed": int((choice >= 0).sum()),
            "peak_mem_gib": _peak_gib()}


def role_c4() -> Dict[str, Any]:
    from minisched_tpu_torch.fullchain import mk_c4_cluster
    from minisched_tpu_torch.headline import pods_by_node
    from minisched_tpu_torch.models.constraints import build_constraint_tables
    from minisched_tpu_torch.models.tables import build_node_table, build_pod_table
    from minisched_tpu_torch.ops.fused import FusedEvaluator
    from minisched_tpu_torch.plugins.interpodaffinity import InterPodAffinity
    from minisched_tpu_torch.plugins.nodeunschedulable import NodeUnschedulable
    from minisched_tpu_torch.plugins.podtopologyspread import PodTopologySpread

    nodes, assigned, pods = mk_c4_cluster()
    _peak_reset()
    t0 = time.monotonic()
    node_table, _ = build_node_table(nodes, pods_by_node(assigned))
    pod_table, _ = build_pod_table(pods)
    extra = build_constraint_tables(
        pods, nodes, assigned, pod_capacity=pod_table.capacity,
        node_capacity=node_table.capacity)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    ipa, ts = InterPodAffinity(), PodTopologySpread()
    ev = FusedEvaluator([NodeUnschedulable(), ipa, ts], [], [ipa, ts])
    res = ev(pod_table, node_table, extra)  # first launches
    best = _best_of(lambda: ev(pod_table, node_table, extra).choice)
    return {"wave_ms": best * 1e3, "pods_per_sec": len(pods) / best,
            "host_build_s": build_s,
            "placed": int((res.choice[: len(pods)] >= 0).sum()),
            "peak_mem_gib": _peak_gib()}


def _live_record(n_crosspod: int) -> Dict[str, Any]:
    """Config 5 with ``n_crosspod`` spread pods through the pipelined
    live engine: ``bench.py``'s ``config5_full_chain`` record."""
    from minisched_tpu_torch.headline import make_step
    from minisched_tpu_torch.live import (
        SPLIT,
        SPLIT_MORE,
        audit_spread,
        audit_store,
        run_config5_live,
    )
    from minisched_tpu_torch.profile_repair import profile_repair
    from minisched_tpu_torch.service.config import default_full_roster_config

    _peak_reset()
    run = run_config5_live(n_crosspod=n_crosspod)
    peak = _peak_gib()
    audited = audit_store(run.client, run.labelled)
    apps = audit_spread(run.client) if n_crosspod else 0
    if run.loop_errors or run.assumed_left:
        raise AssertionError(f"live config 5: {run.loop_errors} loop "
                             f"errors, {run.assumed_left} assumed left")
    n_pods = len(run.pods)
    wave = run.pods[:16_384]
    device_ms = profile_repair(make_step("repair", default_full_roster_config()),
                               run.nodes, [wave], torch.device("cuda"),
                               reps=0)["device_ms_per_round"]
    return {"pods_per_sec_e2e": n_pods / run.total_s, "waves": run.waves,
            "requeued": len(run.labelled), "crosspod_pods": n_crosspod,
            "pipelined": run.pipelined,
            "first_drain_s": run.first_drain_s,
            "requeue_tail_s": run.total_s - run.first_drain_s,
            "requeue_label_loop_s": run.label_loop_s,
            "requeue_bound_wait_s": run.bound_wait_s,
            "total_s": run.total_s, "setup_s": run.setup_s,
            "service_start_s": run.start_s,
            "split_s": {k: run.split[k] for k in SPLIT + SPLIT_MORE},
            "counters": run.counters,
            "scan_lanes": {k: vars(v) for k, v in run.scan_stats.items()},
            "time_to_bind_p50_le_s": run.ttb_p50_le_s,
            "time_to_bind_p99_le_s": run.ttb_p99_le_s,
            "bound": audited["bound"], "spread_apps_audited": apps,
            "device_ms_per_round": device_ms, "peak_mem_gib": peak}


def role_c5() -> Dict[str, Any]:
    return _live_record(0)


def role_c5x_live() -> Dict[str, Any]:
    return _live_record(5_000)


def role_c5_waves() -> Dict[str, Any]:
    from minisched_tpu_torch.audit import audit_config5
    from minisched_tpu_torch.fullchain import (
        WAVE,
        mk_c5_cluster,
        schedule_repair_waves,
    )
    from minisched_tpu_torch.service.config import default_full_roster_config

    nodes, pods = mk_c5_cluster()
    _peak_reset()
    run = schedule_repair_waves(nodes, pods, wave=WAVE)
    peak = _peak_gib()
    audit_config5(run, nodes, pods)
    return {**_wave_record(run, len(pods)), "peak_mem_gib": peak,
            "device_ms_per_round": _device_ms_per_round(
                default_full_roster_config(), nodes, pods, WAVE)}


def role_fullchain_parity() -> Dict[str, Any]:
    from minisched_tpu_torch.engine.oracle import fullchain_scan_oracle
    from minisched_tpu_torch.fullchain import mk_c5_cluster, schedule_scan
    from minisched_tpu_torch.ops.sequential import StepLog

    nodes, pods = mk_c5_cluster()
    log = StepLog()
    _peak_reset()
    run = schedule_scan(nodes, pods, log=log)
    peak = _peak_gib()
    t0 = time.monotonic()
    want = fullchain_scan_oracle(pods, nodes)
    oracle_s = time.monotonic() - t0
    bad = int((run.choices != want).sum())
    if bad:
        raise AssertionError(f"fullchain_parity: {bad} placements differ "
                             "from fullchain_scan_oracle")
    rec = _scan_record(log, run.schedule_s, len(pods))
    return {"scan_total_s": run.schedule_s,
            "scan_pods_per_sec": len(pods) / run.schedule_s,
            "parity_checked_fullchain": len(pods),
            "vec_oracle_pods_per_sec": len(pods) / oracle_s,
            "constraint_build_s": run.constraint_build_s,
            "chunks": run.chunks, "steps": rec["steps"],
            "device_ms_per_step": rec["device_ms_per_step"],
            "capture_s": rec["capture_s"],
            "placed": int((run.choices >= 0).sum()), "peak_mem_gib": peak}


def role_c5x() -> Dict[str, Any]:
    from minisched_tpu_torch.audit import audit_config5, spread_audit
    from minisched_tpu_torch.fullchain import (
        C5_MAX_SKEW,
        WAVE,
        mk_c5_cluster,
        schedule_crosspod,
        schedule_repair_waves,
    )
    from minisched_tpu_torch.headline import BoundPod
    from minisched_tpu_torch.ops.sequential import StepLog

    n_crosspod = 5_000
    nodes, pods = mk_c5_cluster(n_crosspod=n_crosspod)
    is_spread = np.array([p.metadata.name.startswith("spread") for p in pods])
    spread = [p for p, sp in zip(pods, is_spread) if sp]
    rest = [p for p, sp in zip(pods, is_spread) if not sp]
    _peak_reset()
    waves = schedule_repair_waves(nodes, rest, wave=WAVE)
    placed = [BoundPod(p, waves.node_names[c])
              for p, c in zip(rest, waves.choices) if c >= 0]
    log = StepLog()
    lane = schedule_crosspod(nodes, spread, waves.node_table, placed, log=log)
    peak = _peak_gib()
    choices = np.full(len(pods), -1, np.int64)
    choices[~is_spread] = waves.choices
    choices[is_spread] = lane.choices
    audit_config5(SimpleNamespace(node_table=lane.node_table,
                                  choices=choices), nodes, pods)
    apps = spread_audit(nodes, pods, choices, C5_MAX_SKEW)
    rec = _scan_record(log, lane.schedule_s, n_crosspod)
    return {"crosspod_pods": n_crosspod,
            "waves": _wave_record(waves, len(rest)),
            "lane_s": lane.schedule_s,
            "lane_pods_per_sec": n_crosspod / lane.schedule_s,
            "total_s": waves.schedule_s + lane.schedule_s,
            "pods_per_sec_e2e": len(pods) / (waves.schedule_s
                                             + lane.schedule_s),
            "grouping_s": lane.grouping_s,
            "lane_constraint_build_s": lane.constraint_build_s,
            "attempts": lane.attempts, "blocks": lane.blocks,
            "exact_pods": lane.exact_pods,
            "blocks_replayed": rec["steps"],
            "device_ms_per_block": rec["device_ms_per_step"],
            "spread_apps_audited": apps,
            "lane_placed": int((lane.choices >= 0).sum()),
            "peak_mem_gib": peak}


def role_gang_waves() -> Dict[str, Any]:
    from minisched_tpu_torch.audit import audit_config5, one_slice_share
    from minisched_tpu_torch.fullchain import (
        WAVE,
        mk_c5_gang_cluster,
        schedule_repair_waves,
    )
    from minisched_tpu_torch.service.config import gang_roster_config

    nodes, assigned, pods = mk_c5_gang_cluster()
    cfg = gang_roster_config()
    _peak_reset()
    run = schedule_repair_waves(nodes, pods, wave=WAVE, cfg=cfg,
                                assigned=assigned)
    peak = _peak_gib()
    audit_config5(run, nodes, pods, assigned)
    share = one_slice_share(nodes, assigned, pods, run.choices)
    return {**_wave_record(run, len(pods)), "gang_view_s": run.gang_view_s,
            "gangs": share["gangs"], "gangs_complete": share["complete"],
            "gangs_slice_local": share["one_slice"],
            "slice_local_share": share["share"], "peak_mem_gib": peak,
            "device_ms_per_round": _device_ms_per_round(
                cfg, nodes, pods, WAVE, assigned)}


# -- the live roles (bench.py's c1, wave, gang, churn) ----------------------


def _pct(samples, p: float, digits: int = 3) -> float:
    """Nearest-rank percentile over SORTED samples (``bench.py``'s):
    ceil(p·n)−1, so a small-sample p99 does not gate on the maximum."""
    idx = min(max(math.ceil(p * len(samples)) - 1, 0), len(samples) - 1)
    return round(samples[idx], digits)


def _crosscheck_live_p99(name: str, sampled_p99: float, role: str) -> dict:
    """The role's sampled p99 against the live histogram's p99 bucket:
    they must agree within one factor-2 bucket on each side."""
    from minisched_tpu_torch.observability import hist

    bounds = hist.quantile_bounds(name, 0.99)
    if bounds is None:
        raise AssertionError(
            f"[{role}] live histogram {name!r} is empty (sampled p99 "
            f"{sampled_p99}s exists)")
    lo, hi = bounds
    if not lo / 2.0 <= sampled_p99 <= hi * 2.0:
        raise AssertionError(
            f"[{role}] live and sampled p99 disagree beyond bucket "
            f"resolution for {name}: sampled {sampled_p99}s vs live "
            f"bucket ({lo}, {hi}]s")
    return {"lo_s": lo, "le_s": hi}


def _binds_counter():
    """(on_decision hook counting binds, read function)."""
    mu = threading.Lock()
    n = [0]

    def counting(pod, node_name, status):
        if node_name:
            with mu:
                n[0] += 1

    def read() -> int:
        with mu:
            return n[0]

    return counting, read


def _audit_capacity(client: Any, role: str) -> None:
    cpu: Dict[str, int] = defaultdict(int)
    cnt: Dict[str, int] = defaultdict(int)
    for p in client.pods().list():
        if p.spec.node_name:
            cpu[p.spec.node_name] += p.resource_requests().milli_cpu
            cnt[p.spec.node_name] += 1
    for node in client.nodes().list():
        alloc, name = node.status.allocatable, node.metadata.name
        if cpu[name] > alloc.milli_cpu or cnt[name] > alloc.pods:
            raise AssertionError(f"[{role}] node over allocatable: {name}")


def _gang_members(pods) -> Dict[str, List[Any]]:
    from minisched_tpu_torch.api.objects import gang_key

    members: Dict[str, List[Any]] = defaultdict(list)
    for p in pods:
        k = gang_key(p)
        if k is not None:
            members[k].append(p)
    return members


def _partial_gangs(members) -> Dict[str, int]:
    out = {}
    for k, v in members.items():
        n = sum(1 for p in v if p.spec.node_name)
        if n not in (0, len(v)):
            out[k] = n
    return out


def _wait_ledger_empty(sched: Any, timeout_s: float = 30.0) -> bool:
    """True when the assume ledger drained within ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with sched._assumed_lock:
            if not sched._assumed:
                return True
        time.sleep(0.1)
    return False


def role_c1(device: Any = None) -> Dict[str, Any]:
    """The README scenario through the live engine: ``node10`` binds."""
    from minisched_tpu_torch.scenario.runner import (
        ScenarioHarness,
        readme_scenario,
    )
    from minisched_tpu_torch.service.config import default_scheduler_config

    t0 = time.monotonic()
    with ScenarioHarness(default_scheduler_config(time_scale=0.01),
                         device=device) as h:
        bound = readme_scenario(h, log=lambda *_: None)
        loop_errors = h.service.scheduler.loop_errors
    if bound != "node10" or loop_errors:
        raise AssertionError(f"[c1] bound to {bound!r}, {loop_errors} loop "
                             "errors")
    return {"scenario_s": time.monotonic() - t0}


def role_wave(device: Any = None) -> Dict[str, Any]:
    """Laps of the pipelined live engine, full roster, gated on the
    pipeline overlapping: the engine's stall (the device idle waiting for
    a build) must stay under the total build time.  Then the
    exactly-once and capacity audits."""
    from minisched_tpu_torch.api.objects import make_node, make_pod
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.observability import counters
    from minisched_tpu_torch.observability.profiling import CycleMetrics
    from minisched_tpu_torch.service.config import default_full_roster_config
    from minisched_tpu_torch.service.service import SchedulerService

    if os.environ.get("MINISCHED_PIPELINE", "1") in ("", "0"):
        raise Skip("MINISCHED_PIPELINE=0: pipeline disabled by env")
    n_nodes = int(os.environ.get("BENCH_WAVEROLE_NODES", "512"))
    n_pods = int(os.environ.get("BENCH_WAVEROLE_PODS", "6144"))
    max_wave = int(os.environ.get("BENCH_WAVEROLE_WAVE", "1024"))
    laps = max(1, int(os.environ.get("BENCH_WAVEROLE_LAPS", "2")))

    client = Client()
    client.nodes().create_many(
        [make_node(f"node{i:04d}",
                   capacity={"cpu": "64", "memory": "128Gi", "pods": 256})
         for i in range(n_nodes)], return_objects=False)
    counting, bound = _binds_counter()
    counters.reset()
    metrics = CycleMetrics()
    svc = SchedulerService(client)
    sched = svc.start_scheduler(
        default_full_roster_config(), device_mode=True, max_wave=max_wave,
        on_decision=counting, metrics=metrics, device=device)
    t0 = time.monotonic()
    try:
        target = 0
        for lap in range(laps):
            client.pods().create_many(
                [make_pod(f"wp{lap}-{i:05d}",
                          requests={"cpu": "100m", "memory": "64Mi"})
                 for i in range(n_pods)], return_objects=False)
            target += n_pods
            deadline = time.monotonic() + 600
            while bound() < target and time.monotonic() < deadline:
                time.sleep(0.05)
            if bound() < target:
                raise AssertionError(
                    f"[wave] lap {lap + 1}: only {bound()}/{target} bound")
        elapsed = time.monotonic() - t0
        snap = metrics.snapshot()
        loop_errors = sched.loop_errors
    finally:
        svc.shutdown_scheduler()

    for p in client.pods().list():
        if not p.spec.node_name:
            raise AssertionError(f"[wave] pod {p.metadata.name} left unbound")
    _audit_capacity(client, "wave")

    def phase(name: str) -> float:
        return round(snap.get(name, {}).get("total_s", 0.0), 3)

    stall_s = phase("wave_pipeline_stall")
    build_s = phase("wave_pipeline_build")
    waves = counters.get("wave_pipeline.waves")
    if waves == 0:
        raise AssertionError("[wave] pipeline never engaged (0 pipelined "
                             "waves)")
    if build_s > 0 and stall_s >= build_s:
        raise AssertionError(
            f"[wave] pipeline regressed to serial: stall {stall_s}s >= "
            f"build {build_s}s over {waves} waves")
    if loop_errors:
        raise AssertionError(f"[wave] {loop_errors} loop errors")
    return {
        "pods": laps * n_pods, "nodes": n_nodes, "laps": laps,
        "total_s": round(elapsed, 1),
        "pods_per_sec_e2e": round(laps * n_pods / elapsed, 1),
        "pipelined_waves": waves, "build_total_s": build_s,
        "stall_total_s": stall_s,
        "overlap_ratio": (round(1.0 - stall_s / build_s, 3)
                          if build_s > 0 else 0.0),
        "rearb_requeued": counters.get("wave_pipeline.rearb_requeued"),
        "build_fallbacks": counters.get("wave_pipeline.build_fallback"),
        "dirty_rows": counters.get("wave_build.dirty_rows"),
    }


def role_gang(device: Any = None) -> Dict[str, Any]:
    """Rounds of gangs (all or nothing, slice-local preference) with
    singletons over a sliced torus cluster through the live engine, then
    a deadlock probe: two gangs that cannot both fit, resolved by freeing
    filler pods.  Gates: no stranded partial gang, the assume and Permit
    ledgers empty at quiesce, no node over allocatable; the share of
    gangs on one slice is reported."""
    from minisched_tpu_torch.api.objects import make_gang_pods, make_node, \
        make_pod
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.observability import counters
    from minisched_tpu_torch.service.config import gang_roster_config
    from minisched_tpu_torch.service.service import SchedulerService

    n_slices = int(os.environ.get("BENCH_GANG_SLICES", "4"))
    hosts = int(os.environ.get("BENCH_GANG_HOSTS", "8"))
    rounds = int(os.environ.get("BENCH_GANG_ROUNDS", "4"))
    gang_size = int(os.environ.get("BENCH_GANG_SIZE", "8"))
    singles_per_round = int(os.environ.get("BENCH_GANG_SINGLES", "24"))
    ttl_s = float(os.environ.get("BENCH_GANG_TTL_S", "5.0"))
    deadline_s = float(os.environ.get("BENCH_GANG_DEADLINE_S", "420"))

    client = Client()
    nodes = [make_node(f"slice{s:02d}-host{h:02d}",
                       capacity={"cpu": "8", "memory": "32Gi", "pods": 64},
                       slice_id=f"slice{s:02d}", torus=(h % 4, h // 4, 0),
                       host_index=h)
             for s in range(n_slices) for h in range(hosts)]
    client.nodes().create_many(nodes, return_objects=False)
    counting, bound = _binds_counter()
    counters.reset()
    svc = SchedulerService(client)
    sched = svc.start_scheduler(
        gang_roster_config(), device_mode=True,
        max_wave=int(os.environ.get("BENCH_GANG_WAVE", "256")), on_decision=counting,
        device=device)
    cosched = next(p for p in sched.permit_plugins
                   if p.name() == "Coscheduling")
    # the quiesce audit waits for the ledger to drain through the idle
    # path's lease confirm
    sched.assume_ttl_s = 3.0
    t0 = time.monotonic()
    deadline = t0 + deadline_s

    def wait_bound(target: int, what: str) -> None:
        while time.monotonic() < deadline:
            if bound() >= target:
                return
            time.sleep(0.1)
        raise AssertionError(
            f"[gang] deadlock or timeout waiting for {what}: {bound()}/"
            f"{target} bound; queue={sched.queue.stats()} "
            f"pending_gangs={cosched.pending_gangs()}")

    try:
        target, gang_names = 0, []
        for r in range(rounds):
            name = f"train-{r}"
            gang_names.append(name)
            batch = make_gang_pods(
                name, gang_size, ttl_s=ttl_s,
                requests={"cpu": "500m", "memory": "256Mi"}) + [
                make_pod(f"single-{r}-{i:03d}",
                         requests={"cpu": "250m", "memory": "64Mi"})
                for i in range(singles_per_round)]
            client.pods().create_many(batch, return_objects=False)
            target += len(batch)
            wait_bound(target, f"churn round {r + 1}/{rounds}")
        churn_s = time.monotonic() - t0

        # the deadlock probe: fill until free cpu holds about 1.5 gangs
        # of 2-cpu members, then two gangs that cannot both fit
        used: Dict[str, int] = defaultdict(int)
        for p in client.pods().list():
            used[p.spec.node_name] += p.resource_requests().milli_cpu
        free_slots = sum(
            max(n.status.allocatable.milli_cpu - used[n.metadata.name], 0)
            // 2000 for n in nodes)
        filler = [make_pod(f"filler-{i:04d}",
                           requests={"cpu": "2", "memory": "64Mi"})
                  for i in range(max(free_slots - int(1.5 * gang_size), 0))]
        client.pods().create_many(filler, return_objects=False)
        target += len(filler)
        wait_bound(target, "deadlock-probe filler")
        probe = (make_gang_pods("probe-a", gang_size, ttl_s=ttl_s,
                                requests={"cpu": "2"})
                 + make_gang_pods("probe-b", gang_size, ttl_s=ttl_s,
                                  requests={"cpu": "2"}))
        client.pods().create_many(probe, return_objects=False)
        gang_names += ["probe-a", "probe-b"]
        t_probe = time.monotonic()
        wait_bound(target + gang_size, "first probe gang vs competitor")
        ttl_during_probe = counters.get("gang.ttl_expired")
        for p in filler:
            client.pods().delete(p.metadata.name, p.metadata.namespace)
        target += 2 * gang_size
        wait_bound(target, "second probe gang after capacity freed")
        probe_s = time.monotonic() - t_probe
        elapsed = time.monotonic() - t0
        drained = _wait_ledger_empty(sched)
        pending = cosched.pending_gangs()
        loop_errors = sched.loop_errors
    finally:
        svc.shutdown_scheduler()
    if not drained:
        raise AssertionError("[gang] assumed-capacity leak at quiesce")
    if pending:
        raise AssertionError(f"[gang] stranded partial gangs at Permit: "
                             f"{pending}")
    if loop_errors:
        raise AssertionError(f"[gang] {loop_errors} loop errors")
    members = _gang_members(client.pods().list())
    partial = _partial_gangs(members)
    if partial:
        raise AssertionError(f"[gang] partial gangs bound: {partial}")
    unbound = [k for k, v in members.items()
               if not all(p.spec.node_name for p in v)]
    if unbound:
        raise AssertionError(f"[gang] gangs never placed: {unbound}")
    _audit_capacity(client, "gang")
    slice_of = {n.metadata.name: n.spec.slice_id for n in nodes}
    one_slice = sum(1 for v in members.values()
                    if len({slice_of.get(p.spec.node_name) for p in v}) == 1)
    return {
        "pods": target, "nodes": len(nodes), "gangs": len(members),
        "gang_size": gang_size, "rounds": rounds,
        "total_s": round(elapsed, 1), "churn_s": round(churn_s, 1),
        "deadlock_probe_s": round(probe_s, 1),
        "ttl_releases_during_probe": ttl_during_probe,
        "gangs_slice_local": one_slice,
        "counters": {k: v for k, v in counters.snapshot().items()
                     if k.startswith("gang.")},
        "stranded_partial_gangs": 0, "leak": False,
    }


def _fanout_microbench() -> Dict[str, Any]:
    """Shared-payload watch fan-out: N watcher streams serializing one
    mutation pay ONE encode (``event_wire_chunk`` memoizes the framed
    chunk on the event the store fans out).  Fails when the encode count
    scales with the watchers or a delivery is lost."""
    from minisched_tpu_torch.api.objects import make_pod
    from minisched_tpu_torch.controlplane.httpserver import event_wire_chunk
    from minisched_tpu_torch.controlplane.store import ObjectStore
    from minisched_tpu_torch.observability import counters

    n_events = int(os.environ.get("BENCH_CHURN_FANOUT_EVENTS", "300"))
    big_w = max(int(os.environ.get("BENCH_CHURN_FANOUT_WATCHERS", "120")), 100)
    out: Dict[str, Any] = {}
    for n_w in (1, big_w):
        store = ObjectStore()
        pods = [make_pod(f"f{i:05d}", requests={"cpu": "100m"})
                for i in range(n_events)]
        for p in pods:
            store.create("Pod", p)
        watchers = [store.watch("Pod", send_initial=False)[0]
                    for _ in range(n_w)]
        enc0 = counters.get("watch.fanout.encoded")
        t0 = time.perf_counter()
        for p in pods:
            store.mutate("Pod", p.metadata.namespace, p.metadata.name,
                         lambda o: o)
        delivered = 0
        for w in watchers:
            got = 0
            while got < n_events:
                batch = w.next_batch(timeout=2.0)
                if not batch:
                    break
                for ev in batch:
                    event_wire_chunk(ev)
                got += len(batch)
            delivered += got
        wall = time.perf_counter() - t0
        encoded = counters.get("watch.fanout.encoded") - enc0
        for w in watchers:
            w.stop()
        if delivered != n_w * n_events:
            raise AssertionError(
                f"[churn] fan-out lost events: {delivered}/"
                f"{n_w * n_events} delivered at {n_w} watchers")
        out[f"w{n_w}"] = {"watchers": n_w, "events": n_events,
                          "encoded": encoded, "wall_s": round(wall, 3),
                          "encode_per_event": round(encoded / n_events, 3)}
    if out[f"w{big_w}"]["encoded"] > n_events * 1.25:
        raise AssertionError(
            f"[churn] fan-out encode not shared: "
            f"{out[f'w{big_w}']['encoded']} encodes for {n_events} events "
            f"at {big_w} watchers")
    return out


def role_churn(device: Any = None) -> Dict[str, Any]:
    """Sustained churn: Poisson arrivals and departures over tenant
    namespaces with a per-namespace queue quota, priority-preemption
    bursts with gangs over a cluster filled to ``BENCH_CHURN_FILL``, and
    a quiet tail.  The headline is p99 time to bind (arrival to bind
    decision), checked against the live ``sched.time_to_bind_s``
    histogram.  Gates: p99 within ``BENCH_CHURN_P99_S``; no quota
    violation and no hold left at drain; every gang whole (the resident
    gang survives the bursts); the idle-wave gate fires on the quiet
    tail; the shared watch encode; no double bind, no node over
    allocatable, no assume leak."""
    from minisched_tpu_torch.api.objects import make_gang_pods, make_node, \
        make_pod
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.observability import counters, hist
    from minisched_tpu_torch.observability.profiling import CycleMetrics
    from minisched_tpu_torch.service.config import gang_roster_config
    from minisched_tpu_torch.service.service import SchedulerService

    n_nodes = int(os.environ.get("BENCH_CHURN_NODES", "48"))
    window_s = float(os.environ.get("BENCH_CHURN_WINDOW_S", "12"))
    rate = float(os.environ.get("BENCH_CHURN_ARRIVALS_PER_S", "30"))
    lifetime_s = float(os.environ.get("BENCH_CHURN_LIFETIME_S", "6"))
    tenants = int(os.environ.get("BENCH_CHURN_TENANTS", "3"))
    quota = int(os.environ.get("BENCH_CHURN_QUOTA", "4"))
    bursts = int(os.environ.get("BENCH_CHURN_BURSTS", "2"))
    burst_pods = int(os.environ.get("BENCH_CHURN_BURST_PODS", "16"))
    gang_size = int(os.environ.get("BENCH_CHURN_GANG_SIZE", "4"))
    max_wave = int(os.environ.get("BENCH_CHURN_WAVE", "256"))
    p99_gate_s = float(os.environ.get("BENCH_CHURN_P99_S", "45"))
    seed = int(os.environ.get("BENCH_CHURN_SEED", "1234"))
    n_watchers = int(os.environ.get("BENCH_CHURN_WATCHERS", "16"))
    quiet_s = float(os.environ.get("BENCH_CHURN_QUIET_S", "4"))
    drain_s = float(os.environ.get("BENCH_CHURN_DRAIN_S", "120"))
    fill_frac = float(os.environ.get("BENCH_CHURN_FILL", "0.8"))

    rng = random.Random(seed)
    fanout = _fanout_microbench()
    client = Client()
    client.nodes().create_many(
        [make_node(f"node{i:03d}",
                   capacity={"cpu": "8", "memory": "32Gi", "pods": 64})
         for i in range(n_nodes)], return_objects=False)

    mu = threading.Lock()
    arrival_ts: Dict[str, float] = {}
    bind_ts: Dict[str, float] = {}
    bind_counts: Dict[str, int] = defaultdict(int)
    bound_churn: Dict[str, str] = {}

    def counting(pod, node_name, status):
        t = time.monotonic()
        name = pod.metadata.name
        if not node_name:
            return
        with mu:
            bind_counts[name] += 1
            if name in arrival_ts and name not in bind_ts:
                bind_ts[name] = t
            if name.startswith("churn-"):
                bound_churn[name] = pod.metadata.namespace

    # roles share this process: the live histogram the p99 is checked
    # against must hold this run's binds only
    counters.reset()
    hist.reset()
    metrics = CycleMetrics()
    cfg = gang_roster_config()
    tenant_ns = [f"ten-{i}" for i in range(tenants)]
    cfg.queue_opts["namespace_quota"] = {ns: quota for ns in tenant_ns}
    svc = SchedulerService(client)
    sched = svc.start_scheduler(
        cfg, device_mode=True, max_wave=max_wave, on_decision=counting,
        metrics=metrics, device=device, prewarm_scan=False)
    sched.assume_ttl_s = 3.0

    # staleness watchers: live Pod streams consumed concurrently; the
    # sampler reads how far the slowest lags the store's rv
    watcher_rv = [0] * n_watchers
    watcher_stop = threading.Event()
    watchers = [client.store.watch("Pod", send_initial=False)[0]
                for _ in range(n_watchers)]

    def consume(i: int) -> None:
        while not watcher_stop.is_set():
            for ev in watchers[i].next_batch(timeout=0.2):
                watcher_rv[i] = max(watcher_rv[i], ev.rv)
            if watchers[i].stopped:
                return

    threads = [threading.Thread(target=consume, args=(i,), daemon=True)
               for i in range(n_watchers)]
    for t in threads:
        t.start()

    t0 = time.monotonic()
    try:
        # prefill to about fill_frac of the cpu so the bursts must preempt
        n_fill = max(int(n_nodes * 8000 * fill_frac) // 2000 - gang_size, 0)
        filler = [make_pod(f"fill-{i:04d}", namespace="resident",
                           requests={"cpu": "2", "memory": "64Mi"})
                  for i in range(n_fill)]
        resident_gang = make_gang_pods(
            "resident-gang", gang_size, namespace="resident", ttl_s=10.0,
            requests={"cpu": "2", "memory": "64Mi"}, priority=0)
        client.pods().create_many(filler + resident_gang,
                                  return_objects=False)
        prefill_target = len(filler) + len(resident_gang)
        deadline = time.monotonic() + drain_s
        done = 0
        while time.monotonic() < deadline:
            with mu:
                done = sum(1 for n in bind_counts
                           if not n.startswith("churn-"))
            if done >= prefill_target:
                break
            time.sleep(0.1)
        else:
            raise AssertionError(f"[churn] prefill never bound ({done}/"
                                 f"{prefill_target})")

        tick = 0.1
        burst_at = [window_s * (k + 1) / (bursts + 1) for k in range(bursts)]
        fired = [False] * bursts
        seq = 0
        max_staleness_rv = 0
        quota_peak: Dict[str, int] = defaultdict(int)
        t_window = time.monotonic()
        while (elapsed := time.monotonic() - t_window) < window_s:
            n_arr = sum(1 for _ in range(int(rate * tick * 4))
                        if rng.random() < 0.25)
            if n_arr:
                batch = []
                now = time.monotonic()
                for _ in range(n_arr):
                    ns = tenant_ns[rng.randrange(tenants)]
                    name = f"churn-{seq:06d}"
                    seq += 1
                    batch.append(make_pod(
                        name, namespace=ns,
                        requests={"cpu": "250m", "memory": "32Mi"}))
                    arrival_ts[name] = now
                client.pods().create_many(batch, return_objects=False)
            with mu:
                bound_now = list(bound_churn.items())
            for name, ns in bound_now:
                if rng.random() < tick / lifetime_s:
                    try:
                        client.pods().delete(name, ns)
                    except KeyError:
                        pass
                    with mu:
                        bound_churn.pop(name, None)
            for k, at in enumerate(burst_at):
                if not fired[k] and elapsed >= at:
                    fired[k] = True
                    now = time.monotonic()
                    burst = [make_pod(f"burst{k}-{i:03d}", namespace="burst",
                                      requests={"cpu": "2", "memory": "64Mi"},
                                      priority=100)
                             for i in range(burst_pods)] + make_gang_pods(
                        f"burst{k}-gang", gang_size, namespace="burst",
                        ttl_s=10.0, requests={"cpu": "2", "memory": "64Mi"},
                        priority=100)
                    for p in burst:
                        arrival_ts[p.metadata.name] = now
                    client.pods().create_many(burst, return_objects=False)
            rv = client.store.resource_version
            lag = rv - min(watcher_rv)
            if lag > max_staleness_rv and min(watcher_rv) > 0:
                max_staleness_rv = lag
            # peaks only: admitted past the cap is the contract for
            # requeues and gang members; the hard gates are the queue's
            # tripwire counter and the drain requiring every hold to clear
            for ns, st in sched.queue.quota_stats().items():
                quota_peak[ns] = max(quota_peak[ns], st["admitted"])
            time.sleep(tick)
        arrivals = seq

        burst_names = {n for n in arrival_ts if n.startswith("burst")}
        deadline = time.monotonic() + drain_s
        while time.monotonic() < deadline:
            with mu:
                missing = [n for n in burst_names if n not in bind_ts]
            qstats = sched.queue.stats()
            if (not missing and qstats["active"] == 0
                    and qstats["backoff"] == 0
                    and qstats.get("quota_held", 0) == 0):
                break
            time.sleep(0.2)
        qstats = sched.queue.stats()
        if qstats.get("quota_held", 0):
            raise AssertionError(f"[churn] quota hold stalled at drain: "
                                 f"{qstats} with arrivals stopped")
        with mu:
            missing = [n for n in burst_names if n not in bind_ts]
        if missing:
            raise AssertionError(
                f"[churn] preemption burst never landed: {len(missing)} "
                f"high-priority pods unbound after {drain_s}s (e.g. "
                f"{sorted(missing)[:4]}); queue={qstats}")

        # the quiet tail: rounds of infeasible probes; nothing moves, so
        # from the second round on the builder reuses its tables
        skipped_before = counters.get("wave_build.skipped")
        tail_rounds = max(int(quiet_s / 0.5), 3)
        for r in range(tail_rounds):
            client.pods().create_many(
                [make_pod(f"probe-{r}-{i}", namespace="probe",
                          requests={"cpu": "64"}) for i in range(8)],
                return_objects=False)
            time.sleep(0.5)
        zero_build_tail = counters.get("wave_build.skipped") - skipped_before
        if zero_build_tail == 0:
            raise AssertionError(
                f"[churn] idle-wave gate never fired on the quiet tail "
                f"(wave_build.skipped stayed {skipped_before} over "
                f"{tail_rounds} probe rounds)")
        elapsed = time.monotonic() - t0
        drained = _wait_ledger_empty(sched)
        snap = metrics.snapshot()
        loop_errors = sched.loop_errors
    finally:
        watcher_stop.set()
        for w in watchers:
            w.stop()
        svc.shutdown_scheduler()

    if not drained:
        raise AssertionError("[churn] assumed-capacity leak at quiesce")
    if counters.get("queue.quota_violation"):
        raise AssertionError(
            f"[churn] namespace quota violated: "
            f"{counters.get('queue.quota_violation')} non-gang arrivals "
            "admitted past their cap")
    if loop_errors:
        raise AssertionError(f"[churn] {loop_errors} loop errors")
    doubles = {n: c for n, c in bind_counts.items() if c > 1}
    if doubles:
        raise AssertionError(f"[churn] double binds: {doubles}")
    _audit_capacity(client, "churn")
    members = _gang_members(client.pods().list())
    partial = _partial_gangs(members)
    if partial:
        raise AssertionError(f"[churn] partial gangs bound: {partial}")
    res = members.get("resident/resident-gang", [])
    if len(res) != gang_size or not all(p.spec.node_name for p in res):
        raise AssertionError(
            f"[churn] resident gang stranded by preemption: "
            f"{sum(1 for p in res if p.spec.node_name)}/{gang_size} bound")

    ttbs = sorted(bind_ts[n] - arrival_ts[n] for n in bind_ts
                  if n in arrival_ts)
    if not ttbs:
        raise AssertionError("[churn] no time-to-bind samples recorded")
    p50, p95, p99 = _pct(ttbs, 0.50), _pct(ttbs, 0.95), _pct(ttbs, 0.99)
    if p99 > p99_gate_s:
        raise AssertionError(
            f"[churn] p99 time to bind {p99}s > gate {p99_gate_s}s (p50 "
            f"{p50}s, {len(ttbs)} samples)")
    live_p99 = _crosscheck_live_p99("sched.time_to_bind_s", p99, "churn")
    waves = counters.get("wave_pipeline.waves") or 1
    csnap = counters.snapshot()
    return {
        "nodes": n_nodes, "window_s": window_s, "arrivals": arrivals,
        "bound": len(ttbs), "total_s": round(elapsed, 1),
        "ttb_p50_s": p50, "ttb_p95_s": p95, "ttb_p99_s": p99,
        "ttb_p99_live_bucket_s": live_p99, "ttb_gate_s": p99_gate_s,
        "metrics_snapshot": hist.snapshot(),
        "zero_build_waves": counters.get("wave_build.skipped"),
        "zero_build_tail": zero_build_tail,
        "zero_build_ratio": round(
            counters.get("wave_build.skipped") / waves, 3),
        "pipelined_waves": counters.get("wave_pipeline.waves"),
        "max_watcher_staleness_rv": max_staleness_rv,
        "watch_evictions": csnap.get("watch.fanout.evicted_slow", 0),
        "fanout_encoded": csnap.get("watch.fanout.encoded", 0),
        "fanout_shared": csnap.get("watch.fanout.shared", 0),
        "preempt_shielded": csnap.get("gang.preempt_shielded", 0),
        "quota_peaks": dict(quota_peak),
        "quota_held_total": csnap.get("queue.quota_held", 0),
        "quota_admitted": csnap.get("queue.quota_admitted", 0),
        "gang_counters": {k: v for k, v in csnap.items()
                          if k.startswith("gang.")},
        "fanout_microbench": fanout,
        "stall_total_s": round(
            snap.get("wave_pipeline_stall", {}).get("total_s", 0.0), 3),
        "build_total_s": round(
            snap.get("wave_pipeline_build", {}).get("total_s", 0.0), 3),
    }


def run_role(role: str) -> Dict[str, Any]:
    """One role's record; ``{"skipped": reason}`` without a card."""
    if not torch.cuda.is_available():
        return {"role": role, "skipped": "no CUDA device is available"}
    from minisched_tpu_torch.utils import build

    build.load_library()
    from minisched_tpu_torch.ops import kernels

    card = card_line()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    try:
        rec = globals()[f"role_{role}"]()
    except Skip as skip:
        return {"role": role, "skipped": str(skip)}
    return {"role": role, **rec, "role_wall_s": time.monotonic() - t0,
            "launches": dict(kernels.launch_counts),
            "card": card, "device": torch.cuda.get_device_name(0)}


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=ROLES, action="append",
                    help="a role to run (repeatable); default: every role")
    args = ap.parse_args(argv)
    for role in args.only or ROLES:
        print(json.dumps(run_role(role)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
