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
``wire``                ``bench_wire`` (``:1209``): 1,000 nodes and 10,000
                        pods through the device engine behind
                        ``RemoteClient`` and the REST façade, every
                        informer event and bind over the wire; gated on
                        every pod bound
``wire_fanout``         ``bench_wire_fanout`` (``:1463``), host only: 1,000
                        HTTP watch streams on the selector loop, 10 of
                        them wedged; gated on the thread count, the shared
                        encode, evictions resumed exactly once, every
                        event delivered and p99 delivery latency
                        (``BENCH_WIRE_P99_S``, 5 s)
``relist``              ``bench_relist`` (``:3943``), host only: 220
                        watchers relisting at once after a 410 and at a
                        cold boot; gated on encode-once, the list p99
                        (``BENCH_RELIST_P99_S``, 1 s), no write stall and
                        byte-equal bodies with ``MINISCHED_COW_READS`` at
                        1 and 0
``wal``                 ``bench_wal`` (``:2520``), host only: 12
                        ``RemoteClient`` writers over a ``file://`` WAL
                        with ``fsync=True`` and a 50 ms fsync floor,
                        group commit against ``MINISCHED_GROUP_COMMIT=0``;
                        gated on coalescing, a 3x speedup, fsck clean and
                        a full replay
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
The host-only roles (``wire_fanout``, ``relist``, ``wal``) touch no
card but keep that rule; their functions (``role_relist()``, ...) run
anywhere.
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
         "churn", "wire", "wire_fanout", "relist", "wal")

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


# -- the remote control plane's roles (bench.py's wire, wire_fanout, wal,
#    relist) -----------------------------------------------------------------


def role_wire(device: Any = None) -> Dict[str, Any]:
    """The scheduler over HTTP: the device wave engine at moderate scale
    with every informer event and every bind crossing the REST boundary
    (``controlplane/remote.py``, the reference's client-go against the
    httptest server, scheduler.go:54,72-73), on ``device``.  Gated on
    every pod bound (and, with ``BENCH_WIRE_CROSSPOD``, the spread
    audit); reports pods/s end to end and the wire counters."""
    import threading

    from minisched_tpu_torch.api.objects import make_node, make_pod
    from minisched_tpu_torch.controlplane.httpserver import start_api_server
    from minisched_tpu_torch.controlplane.remote import RemoteClient
    from minisched_tpu_torch.service.config import default_full_roster_config
    from minisched_tpu_torch.service.service import SchedulerService
    from minisched_tpu_torch.api.objects import (
        LabelSelector,
        TopologySpreadConstraint,
    )
    from minisched_tpu_torch.fullchain import C5_MAX_SKEW

    n_nodes = int(os.environ.get("BENCH_WIRE_NODES", 1_000))
    n_pods = int(os.environ.get("BENCH_WIRE_PODS", 10_000))
    # ≥0 topology-spread-constrained pods: they cross the wire into the
    # deferral + blocked-scan lane, so the scan-backlog flush re-validation
    # (deleted/recreated pods) runs behind the watch boundary the
    # reference exercises on every event
    # clamped: the wait loop and skew audit assume n_crosspod ≤ n_pods
    n_crosspod = min(
        int(os.environ.get("BENCH_WIRE_CROSSPOD", "0")), n_pods
    )
    _server, base, shutdown = start_api_server()
    try:
        client = RemoteClient(base)
        rng = random.Random(55)
        t0 = time.monotonic()
        # collection POSTs in chunks: one request per object ran ~380
        # obj/s (29s of setup around a 1.7s measurement); the chunk size
        # bounds request bodies to a few MB
        CHUNK = 2000
        nodes = [
            make_node(
                f"node{i:05d}",
                unschedulable=rng.random() < 0.2,
                capacity={"cpu": "8", "memory": "16Gi", "pods": 110},
                labels={"zone": f"z{i % 16}"},
            )
            for i in range(n_nodes)
        ]
        for start in range(0, len(nodes), CHUNK):
            # return_objects=False: the server batch-creates in ONE store
            # transaction and answers {} per item — the seed path was
            # paying a full encode+transfer+decode per created object
            # that this loop immediately dropped
            client.nodes().create_many(
                nodes[start : start + CHUNK], return_objects=False
            )
        pods = [
            make_pod(
                f"pod{i:06d}",
                requests={"cpu": "500m", "memory": "256Mi"},
            )
            for i in range(n_pods - n_crosspod)
        ]
        for i in range(n_crosspod):
            app = f"app{i % 32}"
            pod = make_pod(
                f"spread{i:05d}",
                requests={"cpu": "500m", "memory": "256Mi"},
                labels={"app": app},
            )
            pod.spec.topology_spread_constraints = [
                TopologySpreadConstraint(
                    max_skew=C5_MAX_SKEW,
                    topology_key="zone",
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=LabelSelector(match_labels={"app": app}),
                )
            ]
            pods.append(pod)
        for start in range(0, len(pods), CHUNK):
            client.pods().create_many(
                pods[start : start + CHUNK], return_objects=False
            )
        setup_dt = time.monotonic() - t0

        bound_n = 0
        mu = threading.Lock()

        def counting(pod, node_name, status):
            nonlocal bound_n
            if node_name:
                with mu:
                    bound_n += 1

        svc = SchedulerService(client)
        t_warm = time.monotonic()
        sched = svc.start_scheduler(
            default_full_roster_config(), device_mode=True, max_wave=4096,
            on_decision=counting, device=device,
            # scan-lane warms only when the workload actually rides the
            # scan (they were most of the ~4min wall for the plain run)
            prewarm_scan=n_crosspod > 0,
        )
        t0 = time.monotonic()
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            with mu:
                if bound_n >= n_pods:
                    break
            time.sleep(0.2)
        elapsed = time.monotonic() - t0
        svc.shutdown_scheduler()
        if bound_n < n_pods:
            raise AssertionError(f"[wire] only {bound_n}/{n_pods} bound")
        loop_errors = sched.loop_errors
        if n_crosspod:
            # the same hard max-skew audit the in-process c5x run ends
            # with — over the wire, reading back through the REST API
            zone_of = {}
            eligible_zones = set()
            for n in client.nodes().list():
                zone_of[n.metadata.name] = n.metadata.labels.get("zone")
                if not n.spec.unschedulable and n.metadata.labels.get("zone"):
                    eligible_zones.add(n.metadata.labels["zone"])
            per_app: dict = {}
            for p in client.pods().list():
                if not p.metadata.name.startswith("spread"):
                    continue
                app = p.metadata.labels.get("app")
                zone = zone_of.get(p.spec.node_name)
                per_app.setdefault(app, {}).setdefault(zone, 0)
                per_app[app][zone] += 1
            all_zones = sorted(eligible_zones)
            for app, zones in per_app.items():
                counts = [zones.get(z, 0) for z in all_zones]
                if max(counts) - min(counts) > C5_MAX_SKEW:
                    raise AssertionError(
                        f"[wire] SPREAD SKEW VIOLATED: {app}: {counts}"
                    )
        from minisched_tpu_torch.observability import counters as _counters

        csnap = _counters.snapshot()
        return {
            "pods_per_sec_e2e": round(n_pods / elapsed, 1),
            "total_s": round(elapsed, 1),
            "nodes": n_nodes,
            "pods": n_pods,
            "crosspod_pods": n_crosspod,
            "setup_s": round(setup_dt, 1),
            "engine_start_s": t0 - t_warm,
            "loop_errors": loop_errors,
            # the pooled transport: reuses dwarf opens once the pool is
            # warm, and stale reopens stay incidental
            "wire_counters": {
                k: v for k, v in csnap.items()
                if k.startswith("wire.") or k == "watch.disconnects"
            },
        }
    finally:
        shutdown()



class _WireWatcher:
    """Client half of one raw HTTP watch stream for the wire-fanout
    bench: incremental header + chunked-transfer + JSON-line parsing
    with an O(1) rv extractor (full json.loads per delivery would make
    the CLIENT the bottleneck at 1k watchers on one core)."""

    __slots__ = (
        "sock", "idx", "slow", "buf", "payload", "headers_done", "synced",
        "start_rv", "rvs", "eof", "reading", "resumed_from",
    )

    def __init__(self, sock, idx: int, slow: bool, resumed_from=None):
        self.sock = sock
        self.idx = idx
        self.slow = slow
        self.buf = bytearray()
        self.payload = bytearray()
        self.headers_done = False
        self.synced = False
        self.start_rv = 0
        self.rvs: list = []
        self.eof = False
        self.reading = True
        #: rv this stream resumed from (None = original stream)
        self.resumed_from = resumed_from

    @staticmethod
    def _line_rv(line: bytes) -> int:
        # every event line ends ... "rv": N}\n — "rv" is the last key by
        # construction (httpserver SYNC + event_wire_chunk)
        return int(line[line.rfind(b":") + 1:line.rfind(b"}")])

    def feed(self, data: bytes, now: float, on_event) -> None:
        self.buf += data
        if not self.headers_done:
            end = self.buf.find(b"\r\n\r\n")
            if end < 0:
                return
            head = bytes(self.buf[:end])
            status = head.split(b"\r\n", 1)[0]
            if b"200" not in status:
                # surfaced by the establishment/drain gates (a raise here
                # would only kill the reader thread silently)
                self.eof = True
                return
            del self.buf[: end + 4]
            self.headers_done = True
        # de-chunk
        while True:
            nl = self.buf.find(b"\r\n")
            if nl < 0:
                break
            size = int(bytes(self.buf[:nl]), 16)
            if size == 0:
                self.eof = True
                break
            if len(self.buf) < nl + 2 + size + 2:
                break
            self.payload += self.buf[nl + 2 : nl + 2 + size]
            del self.buf[: nl + 2 + size + 2]
        # JSON lines (keepalive = blank)
        while True:
            nl = self.payload.find(b"\n")
            if nl < 0:
                break
            line = bytes(self.payload[:nl]).strip()
            del self.payload[: nl + 1]
            if not line:
                continue
            if not self.synced:
                # first line is the SYNC marker: its rv is the resume
                # cursor should we be evicted before any event lands
                self.synced = True
                self.start_rv = self._line_rv(line)
                continue
            self.rvs.append(self._line_rv(line))
            on_event(self, now)

    def last_rv(self) -> int:
        return self.rvs[-1] if self.rvs else self.start_rv



def role_wire_fanout() -> Dict[str, Any]:
    """The 1k-watcher wire regime, host only: ≥1000 concurrent real HTTP
    watch streams served
    by the selector stream loop while the store mutates behind them, with
    deliberately-wedged slow watchers driving the wire-level eviction +
    resume path.  Headline: **p99 event-delivery latency** (store commit
    → parsed on a live client stream).  FAILS on:

    * server thread count above ``watchers × BENCH_WIRE_THREAD_FRAC``
      (thread-per-watcher would be ~1000; the loop keeps it ~flat);
    * per-watcher encoding (``watch.fanout.encoded`` not ≪ ``shared``);
    * ZERO evictions (the laggard path never exercised), or an evicted
      watcher that misses or duplicates an event across its
      resume/410→relist reconnect;
    * any live watcher missing any event at drain;
    * p99 delivery latency beyond ``BENCH_WIRE_P99_S``.
    """
    import selectors
    import socket
    import threading

    from minisched_tpu_torch.api.objects import make_pod
    from minisched_tpu_torch.controlplane.httpserver import start_api_server
    from minisched_tpu_torch.controlplane.store import ObjectStore
    from minisched_tpu_torch.observability import counters

    if os.environ.get("MINISCHED_STREAMLOOP", "1") == "0":
        raise Skip("MINISCHED_STREAMLOOP=0: stream loop disabled by env")

    n_watchers = int(os.environ.get("BENCH_WIRE_WATCHERS", "1000"))
    n_slow = min(int(os.environ.get("BENCH_WIRE_SLOW", "10")), n_watchers)
    rate = float(os.environ.get("BENCH_WIRE_EVENTS_PER_S", "25"))
    window_s = float(os.environ.get("BENCH_WIRE_WINDOW_S", "8"))
    pad_bytes = int(os.environ.get("BENCH_WIRE_PAD", "1024"))
    outbuf = int(os.environ.get("BENCH_WIRE_OUTBUF", str(64 * 1024)))
    sndbuf = int(os.environ.get("BENCH_WIRE_SNDBUF", str(32 * 1024)))
    p99_gate_s = float(os.environ.get("BENCH_WIRE_P99_S", "5.0"))
    thread_frac = float(os.environ.get("BENCH_WIRE_THREAD_FRAC", "0.1"))
    drain_s = float(os.environ.get("BENCH_WIRE_DRAIN_S", "120"))
    slow_read_events = 3  # a slow watcher parses this many, then wedges

    counters.reset()
    store = ObjectStore()
    server, base, shutdown = start_api_server(
        store, stream_buffer_bytes=outbuf, stream_sndbuf_bytes=sndbuf
    )
    host, port = base.split("//")[1].split(":")
    port = int(port)

    sel = selectors.DefaultSelector()
    stop = threading.Event()
    t_send: dict = {}  # rv → pre-commit stamp (see the window loop)
    # raw (rv, parse stamp) pairs from LIVE original consumers — slow/
    # resumed streams would pollute p99 with their own wedge time.
    # Latencies resolve AFTER the run: a delivery can beat the bench
    # thread's own return from store.create, so a live t_send lookup
    # here would silently drop exactly the fastest samples.
    recv_log: list = []
    watchers: list = []
    drain_mode = threading.Event()

    def on_event(w: _WireWatcher, now: float) -> None:
        if not w.slow and w.resumed_from is None:
            recv_log.append((w.rvs[-1], now))
        if (
            w.slow
            and not drain_mode.is_set()
            and len(w.rvs) >= slow_read_events
            and w.reading
        ):
            # wedge: stop consuming entirely — the server's out-buffer
            # bound must eventually evict us
            w.reading = False
            sel.unregister(w.sock)

    def connect_watcher(
        idx: int, slow: bool, resume_rv=None
    ) -> _WireWatcher:
        s = None
        for attempt in range(20):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            if slow:
                # tiny receive window: the kernel can't absorb the
                # backlog for us, so the server-side out-buffer fills
                # honestly
                s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
            try:
                s.connect((host, port))
                break
            except OSError:
                s.close()
                s = None
                time.sleep(0.05)  # accept backlog burst: retry
        if s is None:
            raise AssertionError(f"[wirefan] watcher {idx} could not connect")
        path = "/api/v1/pods?watch=true"
        if resume_rv is not None:
            path += f"&resource_version={resume_rv}"
        s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        s.setblocking(False)
        w = _WireWatcher(s, idx, slow, resumed_from=resume_rv)
        sel.register(s, selectors.EVENT_READ, w)
        return w

    def client_loop() -> None:
        while not stop.is_set():
            for key, _mask in sel.select(0.2):
                w: _WireWatcher = key.data
                try:
                    data = w.sock.recv(262144)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    data = b""
                if not data:
                    w.eof = True
                    try:
                        sel.unregister(w.sock)
                    except (KeyError, ValueError):
                        pass
                    continue
                w.feed(data, time.monotonic(), on_event)

    reader = threading.Thread(target=client_loop, daemon=True)
    reader.start()
    t0 = time.monotonic()
    try:
        # -- establish the fleet -------------------------------------------
        for i in range(n_watchers):
            watchers.append(connect_watcher(i, slow=i < n_slow))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if all(w.synced for w in watchers):
                break
            time.sleep(0.05)
        unsynced = sum(1 for w in watchers if not w.synced)
        if unsynced:
            raise AssertionError(
                f"[wirefan] {unsynced}/{n_watchers} streams never SYNCed"
            )
        setup_s = time.monotonic() - t0
        base_threads = threading.active_count()

        # -- mutation window ------------------------------------------------
        pad = "w" * pad_bytes
        all_rvs: list = []
        enc0 = counters.get("watch.fanout.encoded")
        shr0 = counters.get("watch.fanout.shared")
        thread_peak = 0
        tick = 1.0 / rate
        t_window = time.monotonic()
        i = 0
        while time.monotonic() - t_window < window_s:
            p = make_pod(f"ev{i:06d}", labels={"pad": pad})
            # stamp BEFORE the commit: fanout runs inside store.create,
            # so a post-return stamp would measure from after the
            # earliest possible delivery and bias the headline low
            t0_ev = time.monotonic()
            created = store.create("Pod", p)
            rv = created.metadata.resource_version
            t_send[rv] = t0_ev
            all_rvs.append(rv)
            i += 1
            thread_peak = max(thread_peak, threading.active_count())
            time.sleep(tick)
        n_events = len(all_rvs)

        # -- thread-count gate ---------------------------------------------
        thread_gate = max(int(n_watchers * thread_frac), 8)
        if thread_peak > thread_gate:
            raise AssertionError(
                f"[wirefan] SERVER THREAD COUNT UNBOUNDED: {thread_peak} "
                f"threads at {n_watchers} watchers (gate {thread_gate} — "
                f"thread-per-watcher is back?)"
            )

        # -- drain: every live watcher must see every event ----------------
        drain_mode.set()
        deadline = time.monotonic() + drain_s
        pending = [w for w in watchers if not w.slow]
        while time.monotonic() < deadline:
            if all(len(w.rvs) >= n_events for w in pending):
                break
            if any(w.eof for w in pending):
                break
            time.sleep(0.1)
        incomplete = [
            w.idx for w in pending if len(w.rvs) != n_events or w.eof
        ]
        if incomplete:
            raise AssertionError(
                f"[wirefan] {len(incomplete)} live watchers missed events "
                f"(e.g. #{incomplete[:4]}: "
                f"{[len(watchers[j].rvs) for j in incomplete[:4]]}/"
                f"{n_events})"
            )
        # exactness (not just count): FIFO order, no gaps, no dups
        for w in pending[:: max(len(pending) // 50, 1)]:
            if w.rvs != all_rvs:
                raise AssertionError(
                    f"[wirefan] watcher {w.idx} event sequence DIVERGED"
                )

        # -- eviction + resume parity --------------------------------------
        # wedged watchers: wait for the server to evict them (socket
        # death), then resume each from its last parsed rv and require
        # exactly-once across the seam
        for w in watchers[:n_slow]:
            if not w.reading:
                sel.register(w.sock, selectors.EVENT_READ, w)
                w.reading = True
        deadline = time.monotonic() + drain_s
        while time.monotonic() < deadline:
            slows = watchers[:n_slow]
            if all(w.eof or len(w.rvs) >= n_events for w in slows):
                break
            time.sleep(0.1)
        evictions = counters.get("wire.evicted_outbuf") + counters.get(
            "watch.fanout.evicted_slow"
        )
        if evictions == 0:
            raise AssertionError(
                "[wirefan] NO EVICTION: the slow-watcher path was never "
                "exercised (grow BENCH_WIRE_PAD / shrink BENCH_WIRE_OUTBUF)"
            )
        resumed_ok = 0
        for w in watchers[:n_slow]:
            if not w.eof and len(w.rvs) >= n_events:
                if w.rvs != all_rvs:
                    raise AssertionError(
                        f"[wirefan] surviving slow watcher {w.idx} "
                        f"sequence diverged"
                    )
                continue  # laggard survived (buffers absorbed it)
            last = w.last_rv()
            prefix = [rv for rv in all_rvs if rv <= last]
            if w.rvs != prefix:
                raise AssertionError(
                    f"[wirefan] evicted watcher {w.idx} pre-eviction "
                    f"sequence not a clean prefix"
                )
            w2 = connect_watcher(10_000 + w.idx, slow=False, resume_rv=last)
            watchers.append(w2)  # cleanup in finally
            expect = [rv for rv in all_rvs if rv > last]
            deadline2 = time.monotonic() + drain_s
            while (
                len(w2.rvs) < len(expect)
                and not w2.eof
                and time.monotonic() < deadline2
            ):
                time.sleep(0.05)
            if w2.rvs != expect:
                raise AssertionError(
                    f"[wirefan] RESUME PARITY BROKEN for watcher {w.idx}: "
                    f"{len(w2.rvs)}/{len(expect)} after resume from "
                    f"rv {last} (missed or duplicated events)"
                )
            resumed_ok += 1

        # -- encode-once gate ----------------------------------------------
        encoded = counters.get("watch.fanout.encoded") - enc0
        shared = counters.get("watch.fanout.shared") - shr0
        if encoded * 10 > shared:
            raise AssertionError(
                f"[wirefan] ENCODE-ONCE REGRESSED: {encoded} encodes vs "
                f"{shared} shared reuses at {n_watchers} watchers"
            )

        # -- headline: p99 delivery latency --------------------------------
        samples = sorted(
            t_recv - t_send[rv]
            for rv, t_recv in recv_log
            if rv in t_send
        )
        if not samples:
            raise AssertionError("[wirefan] no delivery-latency samples")
        p50 = _pct(samples, 0.50, 4)
        p95 = _pct(samples, 0.95, 4)
        p99 = _pct(samples, 0.99, 4)
        if p99 > p99_gate_s:
            raise AssertionError(
                f"[wirefan] P99 DELIVERY LATENCY REGRESSED: {p99}s > "
                f"gate {p99_gate_s}s (p50 {p50}s, {len(samples)} samples)"
            )
        from minisched_tpu_torch.observability import hist

        live_p99 = _crosscheck_live_p99(
            "watch.delivery_lag_s", p99, "wirefan"
        )
        csnap = counters.snapshot()
        return {
            "watchers": n_watchers,
            "slow_watchers": n_slow,
            "events": n_events,
            "window_s": window_s,
            "setup_s": round(setup_s, 1),
            "delivery_p50_s": p50,
            "delivery_p95_s": p95,
            "delivery_p99_s": p99,
            "delivery_p99_live_bucket_s": live_p99,
            "delivery_gate_s": p99_gate_s,
            "metrics_snapshot": hist.snapshot(),
            "delivery_samples": len(samples),
            "thread_peak": thread_peak,
            "thread_gate": thread_gate,
            "fanout_encoded": encoded,
            "fanout_shared": shared,
            "evictions": evictions,
            "resumed_exactly_once": resumed_ok,
            "total_s": round(time.monotonic() - t0, 1),
            "wire_counters": {
                k: v for k, v in csnap.items()
                if k.startswith("wire.") or k.startswith("watch.")
            },
        }
    finally:
        stop.set()
        reader.join(timeout=5.0)
        for w in watchers:
            try:
                w.sock.close()
            except OSError:
                pass
        try:
            sel.close()
        except Exception:
            pass
        shutdown()



def role_wal() -> Dict[str, Any]:
    """Group-commit WAL, host only: N concurrent HTTP writers, each a
    ``RemoteClient``, over a
    ``file://`` WAL with fsync=True, run twice on the same box — once
    with the MINISCHED_GROUP_COMMIT=0 kill-switch (today's per-mutation
    fsync) and once with the pipeline — gating (a) fsyncs ≪ mutations
    (coalescing ratio recorded), (b) throughput ≥3× the kill-switch
    baseline, (c) post-run fsck clean (which includes rv monotonicity)
    and full replay.  Both phases arm the same MINISCHED_FSYNC_FLOOR_US
    durability-barrier floor (default 50ms, a rotational/cloud disk's
    flush): tmpfs/virtio fsyncs are near-free, which would hide the
    coalescing win this role exists to measure — the floor is recorded
    in the result, and BENCH_WAL_FSYNC_FLOOR_US=0 measures the raw
    device instead."""
    import tempfile
    import threading

    from minisched_tpu_torch.api.objects import make_pod
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore
    from minisched_tpu_torch.controlplane.fsck import fsck
    from minisched_tpu_torch.controlplane.httpserver import start_api_server
    from minisched_tpu_torch.controlplane.remote import RemoteClient
    from minisched_tpu_torch.observability import counters, hist

    n_writers = int(os.environ.get("BENCH_WAL_WRITERS", "12"))
    per_writer = int(os.environ.get("BENCH_WAL_PODS_PER_WRITER", "15"))
    floor_us = int(os.environ.get("BENCH_WAL_FSYNC_FLOOR_US", "50000"))
    n_muts = n_writers * per_writer

    def phase(group_on: bool) -> dict:
        wal = os.path.join(tempfile.mkdtemp(prefix="minisched-wal-"), "w.wal")
        saved = {
            k: os.environ.get(k)
            for k in ("MINISCHED_GROUP_COMMIT", "MINISCHED_FSYNC_FLOOR_US")
        }
        os.environ["MINISCHED_GROUP_COMMIT"] = "1" if group_on else "0"
        os.environ["MINISCHED_FSYNC_FLOOR_US"] = str(floor_us)
        try:  # both knobs are read once, at store construction
            store = DurableObjectStore(wal, fsync=True)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        server, base, shutdown = start_api_server(store, port=0)
        counters.reset()
        errs: list = []

        def writer(w: int) -> None:
            client = RemoteClient(base)
            try:
                for i in range(per_writer):
                    client.pods().create(
                        make_pod(
                            f"wp{w:02d}-{i:04d}",
                            requests={"cpu": "100m", "memory": "64Mi"},
                        )
                    )
            except Exception as e:
                errs.append(f"writer {w}: {e!r}")

        threads = [
            threading.Thread(target=writer, args=(w,), name=f"wal-writer-{w}")
            for w in range(n_writers)
        ]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.monotonic() - t0
        shutdown()
        store.close()
        if errs:
            raise AssertionError(f"[wal] WRITER FAILED (group={group_on}): {errs[:3]}")
        records = counters.get("storage.group_commit.records")
        saved_fsyncs = counters.get("storage.group_commit.fsyncs_saved")
        groups = counters.get("storage.group_commit.groups")
        # fsync=True: the kill-switch path fsyncs once per append, the
        # pipeline once per fsync-armed group == records - fsyncs_saved
        fsyncs = (records - saved_fsyncs) if group_on else n_muts
        re = DurableObjectStore(wal)
        replayed = sum(1 for _ in re.list("Pod"))
        max_rv = re.resource_version
        re.close()
        report = fsck(wal)
        if report["errors"]:
            raise AssertionError(
                f"[wal] FSCK DIRTY (group={group_on}): {report['errors'][:5]}"
            )
        if replayed != n_muts or max_rv != n_muts:
            raise AssertionError(
                f"[wal] REPLAY LOST ACKED MUTATIONS (group={group_on}): "
                f"{replayed}/{n_muts} pods, max rv {max_rv}"
            )
        return {
            "throughput_per_s": round(n_muts / elapsed, 1),
            "total_s": round(elapsed, 2),
            "fsyncs": fsyncs,
            "groups": groups,
            "records": records,
            "group_wait_p99_s": (
                hist.quantile_bounds("storage.group_wait_s", 0.99) or
                (None, None)
            )[1],
        }

    baseline = phase(False)
    grouped = phase(True)
    ratio = grouped["throughput_per_s"] / max(
        baseline["throughput_per_s"], 1e-9
    )
    coalesce = grouped["records"] / max(grouped["fsyncs"], 1)
    if grouped["fsyncs"] * 2 > n_muts:
        raise AssertionError(
            f"[wal] NO COALESCING: {grouped['fsyncs']} fsyncs for "
            f"{n_muts} mutations under {n_writers} writers"
        )
    if ratio < 3.0:
        raise AssertionError(
            f"[wal] GROUP COMMIT NOT ≥3× KILL-SWITCH: "
            f"{grouped['throughput_per_s']}/s vs "
            f"{baseline['throughput_per_s']}/s ({ratio:.2f}x) at "
            f"fsync floor {floor_us}µs"
        )
    return {
        "writers": n_writers,
        "mutations": n_muts,
        "fsync_floor_us": floor_us,
        "baseline": baseline,
        "group_commit": grouped,
        "speedup": round(ratio, 2),
        "coalescing_records_per_fsync": round(coalesce, 2),
        "fsck_clean": True,
    }



def role_relist() -> Dict[str, Any]:
    """The relist-storm regime, host only: the
    COW read plane serving a thundering herd of full state reads.  Two
    storms over a REAL HTTP façade plus a byte-parity audit:

    * **410 storm** — W clients hold a resume cursor the history ring
      has compacted away, every watch-open answers 410 Gone at once
      (SIGKILL-free eviction: ring compaction, not process death), and
      all W relist simultaneously while a writer keeps mutating.
      Gates: p99 list latency, and ZERO write-path stalls (storm write
      p99 within a factor of the quiet baseline — reads never hold the
      write lock).
    * **cold-boot storm** — W informer-boot lists at one quiet rv.
      Gate: encode-once (`store.list_cache.encodes` delta ≤ a few
      benign double-encode races, the rest `hits` streaming shared
      bytes).
    * **kill-switch parity** — identical seeded stores under
      MINISCHED_COW_READS=1 and =0 answer byte-identical list bodies,
      full and namespace-filtered.

    FAILS on: encodes NOT ≪ requests, sampled p99 over the gate, the
    live ``http.list_s`` histogram disagreeing with the sampled p99
    beyond bucket resolution, write-path stalls during the storm, or
    any parity break."""
    import threading
    import urllib.error
    import urllib.request

    from minisched_tpu_torch.api.objects import make_pod
    from minisched_tpu_torch.controlplane.httpserver import start_api_server
    from minisched_tpu_torch.controlplane.store import ObjectStore
    from minisched_tpu_torch.observability import counters

    W = int(os.environ.get("BENCH_RELIST_WATCHERS", "220"))
    n_obj = int(os.environ.get("BENCH_RELIST_OBJECTS", "300"))
    p99_gate_s = float(os.environ.get("BENCH_RELIST_P99_S", "1.0"))
    stall_factor = float(os.environ.get("BENCH_RELIST_STALL_FACTOR", "30"))
    stall_floor_s = float(os.environ.get("BENCH_RELIST_STALL_FLOOR_S", "0.25"))

    counters.reset()
    store = ObjectStore(history_events=64)
    if store.read_plane() is None:
        raise Skip("MINISCHED_COW_READS=0: the relist role benches the COW plane")
    server, base, shutdown = start_api_server(store)

    def get_raw(path: str) -> bytes:
        with urllib.request.urlopen(f"{base}{path}") as r:
            return r.read()

    list_lat: list = []
    lat_mu = threading.Lock()

    def timed_list() -> bytes:
        t0 = time.monotonic()
        body = get_raw("/api/v1/pods")
        dt = time.monotonic() - t0
        with lat_mu:
            list_lat.append(dt)
        return body

    try:
        seeds = [make_pod(f"seed-{i:04d}") for i in range(n_obj)]
        for p in seeds:
            store.create("Pod", p)
        stale_rv = store.resource_version

        def touch(i: int) -> None:
            # rv churn WITHOUT set growth (an update, not a create): the
            # list body stays n_obj pods, so the storm measures serving,
            # not an ever-fatter payload
            p = store.get("Pod", "default", seeds[i % n_obj].metadata.name)
            p.metadata.labels["touched"] = str(i)
            store.update("Pod", p)

        # quiet write baseline: per-mutation latency with no storm around
        quiet_w: list = []
        for i in range(200):
            t0 = time.monotonic()
            touch(i)
            quiet_w.append(time.monotonic() - t0)
        quiet_w.sort()
        quiet_write_p99 = _pct(quiet_w, 0.99, 6)

        # churn past the 64-event history ring so the stale cursor is
        # compacted: every resume below answers 410 (the SIGKILL-free
        # mass eviction)
        for i in range(120):
            touch(i)

        storm_gate = threading.Barrier(W + 1)
        got_410 = [0]
        errs: list = []

        def storm_client(idx: int) -> None:
            try:
                try:
                    with urllib.request.urlopen(
                        f"{base}/api/v1/pods?watch=true"
                        f"&resource_version={stale_rv}"
                    ) as r:
                        r.read(1)
                    raise AssertionError("stale resume was not evicted")
                except urllib.error.HTTPError as e:
                    assert e.code == 410, f"expected 410, got {e.code}"
                    e.read()
                with lat_mu:
                    got_410[0] += 1
                storm_gate.wait()  # ... and everyone relists AT ONCE
                timed_list()
            except BaseException as e:  # surfaced by the gate below
                errs.append(e)
                try:
                    storm_gate.abort()
                except BaseException:
                    pass

        writer_stop = threading.Event()
        storm_w: list = []

        def storm_writer() -> None:
            # ~30 writes/s: every write swaps the snapshot (invalidating
            # the list cache wholesale), so the write cadence bounds how
            # many distinct payloads the storm can possibly encode.  A
            # writer whose period is at or below the single-encode cost
            # (~4ms for a few hundred pods under the GIL) would force
            # EVERY list onto a fresh snapshot — a treadmill no cache
            # can win — without resembling any real plane, where relist
            # bursts are orders of magnitude denser than mutations.
            i = 0
            while not writer_stop.is_set():
                t0 = time.monotonic()
                touch(i)
                storm_w.append(time.monotonic() - t0)
                i += 1
                time.sleep(0.03)

        threads = [
            threading.Thread(target=storm_client, args=(i,)) for i in range(W)
        ]
        wt = threading.Thread(target=storm_writer)
        for t in threads:
            t.start()
        wt.start()
        try:
            storm_gate.wait()
        except threading.BrokenBarrierError:
            pass  # a client failed pre-barrier; surfaced via errs below
        t_storm0 = time.monotonic()
        for t in threads:
            t.join(timeout=60)
        storm_s = time.monotonic() - t_storm0
        writer_stop.set()
        wt.join(timeout=10)
        if errs:
            raise AssertionError(f"[relist] STORM CLIENT FAILED: {errs[0]!r}")
        if got_410[0] != W:
            raise AssertionError(
                f"[relist] EVICTION INCOMPLETE: {got_410[0]}/{W} saw 410"
            )
        storm_w.sort()
        storm_write_p99 = _pct(storm_w, 0.99, 6) if storm_w else 0.0
        write_stall_gate_s = max(stall_floor_s, quiet_write_p99 * stall_factor)
        if storm_w and storm_write_p99 > write_stall_gate_s:
            raise AssertionError(
                f"[relist] WRITE PATH STALLED DURING STORM: p99 "
                f"{storm_write_p99}s vs quiet {quiet_write_p99}s "
                f"(gate {write_stall_gate_s:.4f}s) — reads are holding "
                f"the write lock"
            )

        # cold-boot storm: W informer-boot lists at ONE quiet rv —
        # the encode-once regime the cache exists for
        enc_before = counters.get("store.list_cache.encodes")
        boot_gate = threading.Barrier(W)
        bodies: dict = {}

        def boot_client(idx: int) -> None:
            try:
                boot_gate.wait()
                bodies[idx] = timed_list()
            except BaseException as e:
                errs.append(e)

        threads = [
            threading.Thread(target=boot_client, args=(i,)) for i in range(W)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        if errs:
            raise AssertionError(f"[relist] BOOT CLIENT FAILED: {errs[0]!r}")
        if len({bodies[i] for i in bodies}) != 1:
            raise AssertionError(
                "[relist] COLD-BOOT BODIES DIVERGED at one rv"
            )
        boot_encodes = counters.get("store.list_cache.encodes") - enc_before
        if boot_encodes > 1:  # misses serialize: one build per (ns, rv)
            raise AssertionError(
                f"[relist] ENCODE-ONCE BROKEN: {boot_encodes} encodes "
                f"for {W} cold-boot lists at one rv"
            )

        encodes = counters.get("store.list_cache.encodes")
        hits = counters.get("store.list_cache.hits")
        requests = counters.get("wire.relist_requests")
        if encodes > 0.25 * requests:
            raise AssertionError(
                f"[relist] ENCODES NOT ≪ REQUESTS: {encodes} encodes "
                f"for {requests} list requests"
            )
        list_lat.sort()
        sampled_p99 = _pct(list_lat, 0.99, 4)
        if sampled_p99 > p99_gate_s:
            raise AssertionError(
                f"[relist] LIST P99 {sampled_p99}s OVER GATE {p99_gate_s}s"
            )
        # live/sampled crosscheck on a QUIET sequential probe: the storm
        # samples above are client end-to-end and include the 220-thread
        # client's own GIL queuing, which the server-side ``http.list_s``
        # observation can never contain — comparing those two windows
        # would gate on the bench client, not the plane.  A single probe
        # client makes the windows coincide.  Unlike ``bench.py``'s
        # ``urlopen`` a request, the probe is one kept-alive raw socket
        # read to the terminal chunk: a connect, a handler thread's start
        # and urllib's own Python per request are outside the server's
        # window, and on a shared 8-core host they alone put the client's
        # p99 two buckets above it
        import socket

        from minisched_tpu_torch.observability import hist as _hist

        host, port = base.split("//")[1].split(":")
        probe_sock = socket.create_connection((host, int(port)), timeout=30)
        request = b"GET /api/v1/pods HTTP/1.1\r\nHost: x\r\n\r\n"
        _hist.reset()
        probe: list = []
        try:
            for _ in range(80):
                t0 = time.monotonic()
                probe_sock.sendall(request)
                got = bytearray()
                while not got.endswith(b"\r\n0\r\n\r\n"):
                    data = probe_sock.recv(1 << 20)
                    if not data:
                        raise AssertionError("[relist] probe: connection "
                                             "closed mid-list")
                    got += data
                probe.append(time.monotonic() - t0)
                if not got.startswith(b"HTTP/1.1 200"):
                    raise AssertionError(f"[relist] probe: {bytes(got[:60])}")
        finally:
            probe_sock.close()
        probe.sort()
        probe_p99 = _pct(probe, 0.99, 4)
        live = _crosscheck_live_p99("http.list_s", probe_p99, "relist")
    finally:
        shutdown()

    # kill-switch byte parity: the COW cached/chunked path and the
    # locked re-encode path must answer the SAME bytes — uid and
    # creation_timestamp pinned so both stores hold identical content
    def seeded(cow: str):
        os.environ["MINISCHED_COW_READS"] = cow
        try:
            st = ObjectStore()
        finally:
            os.environ.pop("MINISCHED_COW_READS", None)
        for i in range(40):
            p = make_pod(
                f"par-{i:03d}",
                namespace="default" if i % 4 else "kube-system",
            )
            p.metadata.uid = f"uid-{i:03d}"
            p.metadata.creation_timestamp = 1700000000.0 + i
            st.create("Pod", p)
        return st

    parity: dict = {}
    for cow in ("1", "0"):
        st = seeded(cow)
        srv, b2, shut2 = start_api_server(st)
        try:
            with urllib.request.urlopen(f"{b2}/api/v1/pods") as r:
                full = r.read()
            with urllib.request.urlopen(
                f"{b2}/api/v1/namespaces/kube-system/pods"
            ) as r:
                ns = r.read()
            parity[cow] = (full, ns)
        finally:
            shut2()
    if parity["1"] != parity["0"]:
        raise AssertionError(
            "[relist] KILL-SWITCH PARITY BROKEN: MINISCHED_COW_READS=0 "
            "and =1 answered different list bytes"
        )

    return {
        "watchers": W,
        "objects": n_obj,
        "storm_410_s": round(storm_s, 3),
        "list_requests": requests,
        "list_cache_encodes": encodes,
        "list_cache_hits": hits,
        "cold_boot_encodes": boot_encodes,
        "relist_bytes_shared": counters.get("wire.relist_bytes_shared"),
        "list_p50_s": _pct(list_lat, 0.50, 4),
        "list_p99_s": sampled_p99,
        "probe_list_p99_s": probe_p99,
        "live_list_p99_bucket": live,
        "quiet_write_p99_s": quiet_write_p99,
        "storm_write_p99_s": storm_write_p99,
        "write_stall_gate_s": round(write_stall_gate_s, 4),
        "parity_bytes": len(parity["1"][0]) + len(parity["1"][1]),
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
