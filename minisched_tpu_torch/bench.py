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
``repl``                ``bench_repl`` (``:2664``), host only, opt-in
                        (``BENCH_REPL=1``): 8 writers against a leader
                        whose groups wait for one of two followers' acks,
                        against the single store; then a fresh follower
                        bootstrapping from shipped checkpoint generations
                        under load; gated on no acked write lost, the
                        followers' WALs identical, no quorum timeout,
                        bootstrap within ``BENCH_REPL_BOOTSTRAP_S`` (20
                        s) without an offset-0 re-tail, and the leader's
                        WAL bounded by its compactions
``readscale``           ``bench_readscale`` (``:4242``), host only,
                        opt-in (``BENCH_READSCALE=1``): list storms on
                        one replica and on three (gate 1.7x on 4 cores or
                        more), reads across a leader SIGKILL (no error,
                        no rv regression, no gap over 2 s) and encode-once
                        on every serving replica
``shard``               ``bench_shard`` (``:4636``), host only, opt-in
                        (``BENCH_SHARD=1``): W (at least 6) writer
                        processes through the shard router against one
                        leader group and then two (gate: 1.5x on 4 cores
                        or more, ``BENCH_SHARD_GATE``); single-group
                        against two-group bind batches; a skewed load
                        the autosplit watcher must split within
                        ``BENCH_AUTOSPLIT_DEADLINE_S`` (60 s), the source
                        group's windowed group-wait p99 recovering after
``chaos``               ``bench_chaos`` (``:2219``): the device engine
                        over a WAL store while the fault fabric (seed
                        ``BENCH_CHAOS_SEED``, 1234) fails store updates
                        and gets, drops watches, refuses WAL appends and
                        fails whole bind batches (``engine.bind``); gated
                        on every pod bound, no assumed capacity left at
                        quiesce, informer staleness within
                        ``BENCH_CHAOS_MAX_STALENESS_S`` (30 s) and no
                        double bind in the WAL
``disk``                ``bench_disk`` (``:2361``): the device engine over
                        an archived WAL store under compaction and scrub
                        while the disk fabric refuses appends, runs an
                        ENOSPC episode, flips a bit and rots a
                        checkpoint; gated on convergence, no leak, no
                        double bind, the episode fired and every flipped
                        bit convicted by ``fsck``
``ha``                  ``bench_ha`` (``:3042``): ``BENCH_HA_ENGINES`` (3)
                        active-active device engines
                        (``ha.start_ha_engine``) in this process over one
                        WAL store, the middle one killed with its lease
                        abandoned after the first two thirds of the pods
                        bound; gated on convergence, the survivors
                        dropping it within ``ttl + ttl/3 + 1.5`` s and no
                        double bind
``mesh``                ``bench_mesh`` (``:1984``): the pipelined device
                        engine single-device and over a mesh of every
                        card (``make_mesh``) on the same uid-pinned
                        workload; gated on parity, no fallback and at
                        least one sharded wave, the exactly-once and
                        capacity audits, the build-and-warm budget
                        (``BENCH_MESH_COMPILE_BUDGET_S``, 300 s) and, over
                        distinct cards, the mesh's device total strictly
                        below single-device; it skips below two cards
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
The host-only roles (``wire_fanout``, ``relist``, ``wal``, ``repl``,
``readscale``, ``shard``) touch no card but keep that rule; their functions (``role_relist()``, ...) run
anywhere.  ``role_chaos``, ``role_disk`` and ``role_ha`` take
``device`` (the tests run them small with ``"cpu"``); ``role_mesh``
takes ``device`` and ``mesh`` (a virtual mesh: its correctness gates run,
the device-time gate is not armed).
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
         "churn", "wire", "wire_fanout", "relist", "wal", "repl",
         "readscale", "shard", "chaos", "disk", "ha", "mesh")

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



def role_repl() -> Dict[str, Any]:
    """Replicated control plane (DESIGN.md §27): one leader
    plus two followers tailing the WAL stream over real HTTP, quorum
    (1 follower ack) armed at the group-commit barrier, versus the same
    writer load with ``MINISCHED_REPL=0`` semantics (no hub — today's
    single-store plane).  The record carries the replication tax (mutate
    p50/p99 + ``storage.quorum_wait_s``) and the correctness evidence:
    every acked mutation on BOTH followers and follower WALs
    byte-identical to the leader's (``fsck.wal_compare``).  Phase 3
    (DESIGN.md §28) is bootstrap-under-load: writers hammer a
    leader whose background compaction ships checkpoint generations; a
    FRESH follower attaches mid-load and must catch up to the leader's
    rv within ``BENCH_REPL_BOOTSTRAP_S`` by seeding from the shipped
    checkpoint — zero offset-0 re-tails — while the leader's WAL stays
    bounded by the compaction interval, not by history.  Opt-in via
    ``BENCH_REPL=1`` — the role boots four HTTP servers and three
    fsync-armed stores, which is chaos-tier cost, not headline-tier."""
    import tempfile
    import threading

    from minisched_tpu_torch.api.objects import make_pod
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore
    from minisched_tpu_torch.controlplane.fsck import wal_compare
    from minisched_tpu_torch.controlplane.httpserver import start_api_server
    from minisched_tpu_torch.controlplane.remote import RemoteClient
    from minisched_tpu_torch.controlplane.repl import ReplRuntime, WalFollower
    from minisched_tpu_torch.observability import counters, hist

    if os.environ.get("BENCH_REPL", "0") == "0":
        raise Skip("BENCH_REPL unset: replicated-plane role is opt-in")

    n_writers = int(os.environ.get("BENCH_REPL_WRITERS", "8"))
    per_writer = int(os.environ.get("BENCH_REPL_PODS_PER_WRITER", "25"))
    n_muts = n_writers * per_writer

    def run_writers(base: str) -> list:
        lat: list = []
        errs: list = []
        mu = threading.Lock()

        def writer(w: int) -> None:
            client = RemoteClient(base)
            mine = []
            try:
                for i in range(per_writer):
                    t0 = time.monotonic()
                    client.pods().create(
                        make_pod(
                            f"rp{w:02d}-{i:04d}",
                            requests={"cpu": "100m", "memory": "64Mi"},
                        )
                    )
                    mine.append(time.monotonic() - t0)
            except Exception as e:
                errs.append(f"writer {w}: {e!r}")
            with mu:
                lat.extend(mine)

        threads = [
            threading.Thread(target=writer, args=(w,), name=f"repl-w{w}")
            for w in range(n_writers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise AssertionError(f"[repl] WRITER FAILED: {errs[:3]}")
        return sorted(lat)

    # -- phase 1: kill-switch baseline (no hub, single store) ---------------
    base_dir = tempfile.mkdtemp(prefix="minisched-repl-")
    base_wal = os.path.join(base_dir, "baseline.wal")
    store_b = DurableObjectStore(base_wal, fsync=True)
    server_b, url_b, shutdown_b = start_api_server(store_b, port=0)
    t0 = time.monotonic()
    lat_b = run_writers(url_b)
    elapsed_b = time.monotonic() - t0
    shutdown_b()
    store_b.close()

    # -- phase 2: 3-replica plane, quorum armed -----------------------------
    counters.reset()
    leader_wal = os.path.join(base_dir, "leader.wal")
    leader = DurableObjectStore(leader_wal, fsync=True)
    runtime = ReplRuntime(
        leader, "r0", peers=[], cluster_size=3, ack_timeout_s=15.0
    )
    runtime.promote()
    server_l, url_l, shutdown_l = start_api_server(
        leader, port=0, repl=runtime
    )
    followers = []
    for fid in ("r1", "r2"):
        fstore = DurableObjectStore(
            os.path.join(base_dir, f"{fid}.wal"), fsync=True
        )
        fstore.fence("r0")
        tail = WalFollower(fstore, url_l, fid)
        tail.start()
        followers.append((fid, fstore, tail))
    t0 = time.monotonic()
    lat_r = run_writers(url_l)
    elapsed_r = time.monotonic() - t0
    # quorum means ONE follower proved durability per group; wait for
    # both to finish catching up before auditing the full copies
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and any(
        f[1].resource_version < leader.resource_version for f in followers
    ):
        time.sleep(0.05)
    qp = hist.quantile_bounds("storage.quorum_wait_s", 0.99) or (None, None)
    shutdown_l()
    for _fid, fstore, tail in followers:
        tail.stop()
        fstore.close()
    leader.close()
    runtime.close()

    # -- audits -------------------------------------------------------------
    lost = []
    for fid, fstore, _tail in followers:
        replayed = DurableObjectStore(fstore._path)
        n = sum(1 for _ in replayed.list("Pod"))
        replayed.close()
        if n != n_muts:
            lost.append(f"{fid}: {n}/{n_muts} pods")
        cmp = wal_compare(leader_wal, fstore._path)
        if not (cmp.get("identical") or cmp.get("prefix")):
            lost.append(f"{fid}: WAL diverged {cmp.get('diverged')}")
    if lost:
        raise AssertionError(f"[repl] ACKED WRITES MISSING ON FOLLOWERS: {lost}")
    if counters.get("storage.repl.quorum_timeouts"):
        raise AssertionError("[repl] QUORUM TIMEOUTS on a healthy local plane")

    # -- phase 3: fresh-follower bootstrap under load (DESIGN.md §28) -------
    compact_every_s = float(
        os.environ.get("BENCH_REPL_COMPACT_EVERY_S", "0.5")
    )
    bootstrap_budget_s = float(
        os.environ.get("BENCH_REPL_BOOTSTRAP_S", "20.0")
    )
    boot_writers = int(os.environ.get("BENCH_REPL_BOOT_WRITERS", "6"))
    counters.reset()
    wal3 = os.path.join(base_dir, "leader3.wal")
    leader3 = DurableObjectStore(wal3, fsync=True)
    runtime3 = ReplRuntime(
        leader3, "r0", peers=[], cluster_size=3, ack_timeout_s=15.0
    )
    runtime3.promote()
    server3, url3, shutdown3 = start_api_server(
        leader3, port=0, repl=runtime3
    )
    standing = DurableObjectStore(
        os.path.join(base_dir, "standing.wal"), fsync=True
    )
    standing.fence("r0")
    standing_tail = WalFollower(standing, url3, "r1", leader_id="r0")
    standing_tail.start()

    stop = threading.Event()
    errs3: list = []

    def boot_writer(w: int) -> None:
        client = RemoteClient(url3, timeout_s=30.0)
        i = 0
        try:
            while not stop.is_set():
                client.pods().create(
                    make_pod(
                        f"bl{w:02d}-{i:05d}",
                        requests={"cpu": "100m", "memory": "64Mi"},
                    )
                )
                i += 1
        except Exception as e:
            errs3.append(f"boot writer {w}: {e!r}")

    def compactor() -> None:
        while not stop.is_set():
            stop.wait(compact_every_s)
            if stop.is_set():
                return
            try:
                leader3.compact()
            except Exception as e:  # pragma: no cover - audit below
                errs3.append(f"compactor: {e!r}")
                return

    wal_samples: list = []
    total_growth = [0]

    def sampler() -> None:
        prev = 0
        while not stop.is_set():
            cur = leader3.wal_end()
            wal_samples.append(cur)
            if cur > prev:
                total_growth[0] += cur - prev
            prev = cur
            stop.wait(0.05)

    threads3 = [
        threading.Thread(target=boot_writer, args=(w,), name=f"boot-w{w}")
        for w in range(boot_writers)
    ]
    threads3 += [
        threading.Thread(target=compactor, name="boot-compactor"),
        threading.Thread(target=sampler, name="boot-sampler"),
    ]
    for t in threads3:
        t.start()
    # wait for ≥2 shipped generations so the fresh follower's seed is a
    # MID-STREAM checkpoint, not the boot state
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline and (
        counters.get("storage.repl.ckpt_published") < 2 and not errs3
    ):
        time.sleep(0.05)
    if errs3 or counters.get("storage.repl.ckpt_published") < 2:
        stop.set()
        raise AssertionError(
            f"[repl] PHASE-3 WARMUP FAILED: {errs3[:3] or 'no generations'}"
        )
    bstore = DurableObjectStore(
        os.path.join(base_dir, "boot.wal"), fsync=True
    )
    bstore.fence("r0")
    target_rv = leader3.resource_version
    t_attach = time.monotonic()
    boot_tail = WalFollower(bstore, url3, "boot", leader_id="r0")
    boot_tail.start()
    deadline = time.monotonic() + bootstrap_budget_s
    while time.monotonic() < deadline and (
        bstore.resource_version < target_rv and not errs3
    ):
        time.sleep(0.02)
    bootstrap_s = time.monotonic() - t_attach
    caught_up = bstore.resource_version >= target_rv
    stop.set()
    for t in threads3:
        t.join(timeout=30.0)
    # let the tails drain the last groups before auditing convergence
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and (
        bstore.resource_version < leader3.resource_version
        or standing.resource_version < leader3.resource_version
    ):
        time.sleep(0.05)
    bq = hist.quantile_bounds("storage.repl.bootstrap_s", 0.99) or (
        None, None,
    )
    # stop the tails BEFORE the server so their stream sockets close
    # client-side (no reset noise from the handler threads)
    for tail in (standing_tail, boot_tail):
        tail.stop()
        tail.join(timeout=5.0)
    shutdown3()
    runtime3.close()

    if errs3:
        raise AssertionError(f"[repl] PHASE-3 WRITERS FAILED: {errs3[:3]}")
    if not caught_up:
        raise AssertionError(
            f"[repl] BOOTSTRAP BLEW THE BUDGET: follower at rv "
            f"{bstore.resource_version} < {target_rv} after "
            f"{bootstrap_budget_s}s"
        )
    if counters.get("storage.repl.full_retails"):
        raise AssertionError(
            "[repl] OFFSET-0 RE-TAIL: a follower replayed history "
            "instead of seeding from the shipped checkpoint"
        )
    if counters.get("storage.repl.ckpt_seeds") < 2 or not (
        bstore.checkpoint_rv > 0
    ):
        raise AssertionError(
            "[repl] fresh follower did not seed from a shipped checkpoint"
        )
    if counters.get("storage.repl.compact_deferred"):
        raise AssertionError(
            "[repl] COMPACTION DEFERRED under a hub — the WAL is unbounded"
        )
    # WAL boundedness: the peak never reaches the full appended history
    # and stays within ~2 compaction intervals of growth
    drops, seg, max_seg = 0, 0, 0
    prev = 0
    for cur in wal_samples:
        if cur < prev:
            drops += 1
            max_seg = max(max_seg, seg)
            seg = cur
        else:
            seg += cur - prev
        prev = cur
    max_seg = max(max_seg, seg)
    peak = max(wal_samples) if wal_samples else 0
    if drops < 2:
        raise AssertionError(
            f"[repl] WAL NEVER TRUNCATED under load ({drops} drops)"
        )
    if peak > 2 * max_seg + 65536 or peak >= total_growth[0]:
        raise AssertionError(
            f"[repl] WAL UNBOUNDED: peak {peak}B vs per-interval growth "
            f"{max_seg}B (total appended {total_growth[0]}B)"
        )
    if bstore.resource_version != leader3.resource_version or (
        standing.resource_version != leader3.resource_version
    ):
        raise AssertionError("[repl] PHASE-3 REPLICAS NEVER CONVERGED")
    boot_pods = {p.metadata.name for p in bstore.list("Pod")}
    lead_pods = {p.metadata.name for p in leader3.list("Pod")}
    if boot_pods != lead_pods:
        raise AssertionError(
            f"[repl] BOOTSTRAPPED STATE DIVERGED: "
            f"{len(lead_pods ^ boot_pods)} names differ"
        )
    n_boot = len(lead_pods)
    leader3.close()
    standing.close()
    bstore.close()
    _log(
        f"[repl] bootstrap-under-load: fresh follower caught "
        f"{n_boot} pods / rv {target_rv} in {bootstrap_s:.2f}s "
        f"(budget {bootstrap_budget_s}s) off generation "
        f"{counters.get('storage.repl.ckpt_published')} ships; WAL peak "
        f"{peak}B ≤ 2× interval growth {max_seg}B across {drops} "
        f"truncations; zero offset-0 re-tails"
    )

    def _p(lat: list, q: float) -> float:
        return round(lat[min(len(lat) - 1, int(q * len(lat)))], 4)

    tax = _p(lat_r, 0.50) - _p(lat_b, 0.50)
    _log(
        f"[repl] {n_writers} writers × {per_writer} pods: quorum plane "
        f"{n_muts / elapsed_r:.0f}/s (p50 {_p(lat_r, 0.50)}s, p99 "
        f"{_p(lat_r, 0.99)}s) vs kill-switch {n_muts / elapsed_b:.0f}/s "
        f"(p50 {_p(lat_b, 0.50)}s); quorum-wait p99 ≤ {qp[1]}s; both "
        f"followers byte-identical, zero acked writes lost"
    )
    return {
        "writers": n_writers,
        "mutations": n_muts,
        "baseline": {
            "throughput_per_s": round(n_muts / elapsed_b, 1),
            "mutate_p50_s": _p(lat_b, 0.50),
            "mutate_p99_s": _p(lat_b, 0.99),
        },
        "replicated": {
            "throughput_per_s": round(n_muts / elapsed_r, 1),
            "mutate_p50_s": _p(lat_r, 0.50),
            "mutate_p99_s": _p(lat_r, 0.99),
            "quorum_wait_p99_bucket_s": qp[1],
            "groups": counters.get("storage.repl.groups"),
            "acks": counters.get("storage.repl.acks"),
            "resyncs": counters.get("storage.repl.resyncs"),
        },
        "replication_tax_p50_s": round(tax, 4),
        "followers_identical": True,
        "acked_writes_lost": 0,
        "bootstrap": {
            "budget_s": bootstrap_budget_s,
            "bootstrap_s": round(bootstrap_s, 3),
            "bootstrap_p99_bucket_s": bq[1],
            "target_rv": target_rv,
            "generations_shipped": counters.get(
                "storage.repl.ckpt_published"
            ),
            "ckpt_seeds": counters.get("storage.repl.ckpt_seeds"),
            "full_retails": 0,
            "wal_peak_bytes": peak,
            "wal_interval_growth_bytes": max_seg,
            "wal_truncations": drops,
        },
    }


def role_readscale() -> Dict[str, Any]:
    """The read-scaling role (DESIGN.md §29): the
    follower-serving read plane must BUY capacity, not just redundancy.
    Opt-in via ``BENCH_READSCALE=1`` — the role boots a 3-replica
    process plane twice over plus an in-process triple.  Three phases:

    * **scaling storm** — the process plane seeded with
      BENCH_READSCALE_OBJECTS pods; W keep-alive clients run the same
      fixed list window twice: every client on the leader alone, then
      spread across all three replica façades.  Gate: spread rate ≥
      BENCH_READSCALE_GATE × the single-replica rate (default 1.7×).
    * **encode-once everywhere** — an IN-PROCESS leader + two served
      followers (counters are process-global there, so the deltas are
      visible) absorb a quiet list storm spread across all three
      façades at one rv.  Gate: every serving replica answered from
      its own memoized COW payload — ``store.list_cache.encodes``
      delta between 1 and 2 per replica for hundreds of requests.
    * **read availability across leader kill** — endpoint-aware
      readers (min_rv-bounded, session-monotonic rv) list continuously
      for BENCH_READ_FAILOVER_S while the leader is SIGKILLed
      mid-window and a writer keeps advancing rv through the failover.
      Gates: zero read errors, zero rv regressions, and the longest
      gap between successive successful reads ≤ BENCH_READSCALE_GAP_S
      (reads must ride the surviving followers THROUGH the election,
      not wait it out).
    """
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    from minisched_tpu_torch.api.objects import make_pod
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore
    from minisched_tpu_torch.controlplane.httpserver import start_api_server
    from minisched_tpu_torch.controlplane.remote import RemoteClient, RemoteStore
    from minisched_tpu_torch.controlplane.repl import ReplRuntime, WalFollower
    from minisched_tpu_torch.controlplane.replproc import ReplicatedPlane
    from minisched_tpu_torch.observability import counters

    if os.environ.get("BENCH_READSCALE", "0") == "0":
        raise Skip("BENCH_READSCALE unset: read-scaling role is opt-in")

    P = int(os.environ.get("BENCH_READSCALE_PROCS", "4"))
    W = int(os.environ.get("BENCH_READSCALE_CLIENTS", "8"))  # per proc
    n_obj = int(os.environ.get("BENCH_READSCALE_OBJECTS", "300"))
    window_s = float(os.environ.get("BENCH_READSCALE_WINDOW_S", "2.0"))
    gate = float(os.environ.get("BENCH_READSCALE_GATE", "1.7"))
    fail_s = float(os.environ.get("BENCH_READ_FAILOVER_S", "6.0"))
    gap_gate_s = float(os.environ.get("BENCH_READSCALE_GAP_S", "2.0"))
    ttl_s = 1.0

    counters.reset()

    # ---- phase 1+3 topology: the real process plane -------------------
    tmp = tempfile.mkdtemp(prefix="bench-readscale-")

    # the storm drives from SEPARATE client processes: the replicas are
    # each their own process, so a single GIL-bound bench client would
    # measure its own ceiling, not the plane's serving capacity
    helper = os.path.join(tmp, "_list_storm.py")
    with open(helper, "w") as f:
        f.write(
            "import http.client, sys, threading, time, urllib.parse\n"
            "urls = sys.argv[1].split(',')\n"
            "window_s, W, off = float(sys.argv[2]), int(sys.argv[3]), "
            "int(sys.argv[4])\n"
            "counts = [0] * W\n"
            "stop = threading.Event()\n"
            "errs = []\n"
            "def client(i):\n"
            "    u = urllib.parse.urlparse(urls[(off + i) % len(urls)])\n"
            "    conn = http.client.HTTPConnection(u.hostname, u.port,"
            " timeout=10)\n"
            "    try:\n"
            "        while not stop.is_set():\n"
            "            conn.request('GET', '/api/v1/pods')\n"
            "            r = conn.getresponse()\n"
            "            body = r.read()\n"
            "            if r.status != 200:\n"
            "                errs.append('HTTP %d: %r' % (r.status,"
            " body[:80]))\n"
            "                return\n"
            "            counts[i] += 1\n"
            "    except Exception as e:\n"
            "        if not stop.is_set():\n"
            "            errs.append(repr(e))\n"
            "    finally:\n"
            "        conn.close()\n"
            "threads = [threading.Thread(target=client, args=(i,))"
            " for i in range(W)]\n"
            "for t in threads:\n"
            "    t.start()\n"
            "time.sleep(window_s)\n"
            "stop.set()\n"
            "for t in threads:\n"
            "    t.join(timeout=30)\n"
            "if errs:\n"
            "    print(errs[0], file=sys.stderr)\n"
            "    sys.exit(1)\n"
            "print(sum(counts))\n"
        )

    def storm(urls: list, label: str) -> float:
        """Fixed-window keep-alive list storm: P client processes × W
        connections each, round-robin across façades; returns lists/s."""
        procs = [
            subprocess.Popen(
                [
                    sys.executable, helper, ",".join(urls),
                    str(window_s), str(W), str(k),
                ],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            )
            for k in range(P)
        ]
        total = 0
        for p in procs:
            out, err = p.communicate(timeout=window_s + 60)
            if p.returncode != 0:
                raise AssertionError(
                    f"[readscale] {label} CLIENT FAILED: "
                    f"{err.decode(errors='replace')[-200:]}"
                )
            total += int(out.strip())
        rate = total / window_s
        _log(
            f"[readscale] {label}: {rate:.0f} lists/s "
            f"({P}x{W} client connections)"
        )
        return rate

    plane = ReplicatedPlane(tmp, n=3, fsync=False, ttl_s=ttl_s)
    try:
        url = plane.start()
        client = RemoteClient(url, timeout_s=10.0)
        for i in range(n_obj):
            client.pods().create(make_pod(f"seed-{i:04d}"))
        seed_rv = int(client.store.list_with_rv("Pod")[1])
        bases = [r.base_url for r in plane.replicas]
        # every replica must have applied the seed before the storm —
        # the bounded read IS the convergence probe
        for b in bases:
            deadline = time.monotonic() + 15.0
            while True:
                try:
                    with urllib.request.urlopen(
                        f"{b}/api/v1/pods?min_rv={seed_rv}"
                    ) as r:
                        r.read()
                    break
                except urllib.error.HTTPError as e:
                    e.read()
                    if e.code != 504 or time.monotonic() > deadline:
                        raise AssertionError(
                            f"[readscale] {b} never applied rv {seed_rv} "
                            f"(HTTP {e.code})"
                        )
                    time.sleep(0.05)

        leader = plane.leader()
        leader_base = leader.base_url
        rate_1 = storm([leader_base], "1-replica storm")
        rate_3 = storm(bases, "3-replica storm")
        scaling = rate_3 / rate_1 if rate_1 else 0.0
        # the scaling gate needs hardware that can EXPRESS scaling: three
        # server processes plus the client fleet on fewer than 4 cores
        # all share the same silicon, so wall-clock throughput is pinned
        # at ~1x no matter how good the read plane is.  Same philosophy
        # as the TPU-gap skips: a capability gap is not a regression.
        cores = os.cpu_count() or 1
        scaling_gated = cores >= 4
        if scaling_gated and scaling < gate:
            raise AssertionError(
                f"[readscale] SCALING UNDER GATE: {rate_3:.0f}/s across 3 "
                f"replicas vs {rate_1:.0f}/s on 1 = {scaling:.2f}x < "
                f"{gate}x — followers are not buying read capacity"
            )
        if not scaling_gated:
            _log(
                f"[readscale] scaling gate SKIPPED: {cores} CPU core(s) "
                f"— replicas share the silicon, wall-clock scaling is "
                f"bounded at ~1x (measured {scaling:.2f}x, recorded "
                f"informationally; gate re-arms on >=4 cores)"
            )
        else:
            _log(f"[readscale] read scaling 1->3 replicas: {scaling:.2f}x")

        # ---- phase 3: availability across a leader SIGKILL ------------
        R = int(os.environ.get("BENCH_READSCALE_READERS", "6"))
        stop_all = threading.Event()
        rerrs: list = []
        werrs: list = []
        done_ts: list = []
        lats: list = []
        mu = threading.Lock()

        def reader(i: int) -> None:
            home = bases[i % len(bases)]
            rs = RemoteStore(
                home, endpoints=[b for b in bases if b != home],
                timeout_s=10.0,
            )
            last_rv = 0
            try:
                while not stop_all.is_set():
                    t0 = time.monotonic()
                    try:
                        _pods, rv = rs.list_with_rv("Pod")
                    except Exception as e:
                        rerrs.append(f"reader {i}: {e!r}")
                        return
                    now = time.monotonic()
                    if rv < last_rv:
                        rerrs.append(
                            f"reader {i}: rv regressed {last_rv}->{rv}"
                        )
                        return
                    last_rv = rv
                    with mu:
                        done_ts.append(now)
                        lats.append(now - t0)
            finally:
                rs.close()

        def writer() -> None:
            rs = RemoteStore(bases[1], endpoints=bases, timeout_s=10.0)
            i = 0
            acked = 0
            try:
                while not stop_all.is_set():
                    try:
                        rs.create("Pod", make_pod(f"fo-{i:05d}"))
                        acked += 1
                    except Exception:
                        time.sleep(0.2)  # mid-election: retry fresh
                    i += 1
                    time.sleep(0.02)
            finally:
                rs.close()
            if acked == 0:
                werrs.append("failover writer never acked a write")

        threads = [
            threading.Thread(target=reader, args=(i,)) for i in range(R)
        ]
        wt = threading.Thread(target=writer)
        _log(
            f"[readscale] failover window: {R} bounded readers, leader "
            f"SIGKILL at t+{fail_s / 3:.1f}s of {fail_s:.1f}s"
        )
        for t in threads:
            t.start()
        wt.start()
        time.sleep(fail_s / 3)
        victim = plane.leader()
        t_kill = time.monotonic()
        victim.kill()
        plane.wait_for_leader(
            timeout_s=10 * ttl_s, exclude=victim.replica_id
        )
        time.sleep(max(0.0, fail_s - (time.monotonic() - t_kill)))
        stop_all.set()
        for t in threads:
            t.join(timeout=30)
        wt.join(timeout=30)
        if rerrs or werrs:
            raise AssertionError(
                f"[readscale] FAILOVER WINDOW FAILED: {(rerrs + werrs)[0]}"
            )
        done_ts.sort()
        gaps = [
            b - a for a, b in zip(done_ts, done_ts[1:])
            if b >= t_kill  # only gaps that could span the kill matter
        ]
        max_gap_s = max(gaps) if gaps else 0.0
        if max_gap_s > gap_gate_s:
            raise AssertionError(
                f"[readscale] READ GAP {max_gap_s:.2f}s ACROSS THE KILL "
                f"> {gap_gate_s}s — reads waited out the election "
                f"instead of riding the followers"
            )
        lats.sort()
        read_p99_s = _pct(lats, 0.99, 4)
        _log(
            f"[readscale] {len(done_ts)} reads through the kill, max "
            f"gap {max_gap_s:.3f}s, p99 {read_p99_s}s"
        )
    finally:
        plane.stop()

    # ---- phase 2: encode-once on EVERY serving replica (in-process,
    # where the counters of all three stores share one registry) -------
    tmp2 = tempfile.mkdtemp(prefix="bench-readscale-inproc-")
    leader = DurableObjectStore(os.path.join(tmp2, "l.wal"), fsync=False)
    if leader.read_plane() is None:
        leader.close()
        raise Skip(
            "MINISCHED_COW_READS=0: readscale benches the COW read plane"
        )
    runtime = ReplRuntime(leader, "r0", peers=[], cluster_size=3)
    runtime.promote()
    _srv, lurl, lshutdown = start_api_server(leader, port=0, repl=runtime)
    followers = []
    for i in range(2):
        fid = f"r{i + 1}"
        fstore = DurableObjectStore(
            os.path.join(tmp2, f"{fid}.wal"), fsync=False
        )
        fstore.fence("r0")
        tail = WalFollower(fstore, lurl, fid)
        tail.start()
        _fs, furl, fshutdown = start_api_server(fstore, port=0)
        followers.append((fstore, tail, furl, fshutdown))
    try:
        for i in range(n_obj):
            leader.create("Pod", make_pod(f"enc-{i:04d}"))
        want = leader.resource_version
        deadline = time.monotonic() + 15.0
        while any(f[0].resource_version < want for f in followers):
            if time.monotonic() > deadline:
                raise AssertionError(
                    "[readscale] in-process followers never converged"
                )
            time.sleep(0.02)
        urls = [lurl] + [f[2] for f in followers]
        enc0 = counters.get("store.list_cache.encodes")
        req0 = counters.get("wire.relist_requests")
        per_url = 60

        def lister(u: str) -> None:
            for _ in range(per_url):
                with urllib.request.urlopen(f"{u}/api/v1/pods") as r:
                    r.read()

        lthreads = [
            threading.Thread(target=lister, args=(u,))
            for u in urls for _ in range(3)
        ]
        for t in lthreads:
            t.start()
        for t in lthreads:
            t.join(timeout=60)
        encodes = counters.get("store.list_cache.encodes") - enc0
        requests = counters.get("wire.relist_requests") - req0
        if requests < 3 * 3 * per_url:
            raise AssertionError(
                f"[readscale] encode-once storm too quiet: {requests} "
                f"list requests"
            )
        if not (3 <= encodes <= 6):
            raise AssertionError(
                f"[readscale] ENCODE-ONCE BROKEN ON A REPLICA: {encodes} "
                f"encodes for {requests} quiet lists across 3 façades "
                f"(want one per replica, ≤2 with benign races)"
            )
        _log(
            f"[readscale] encode-once everywhere: {encodes} encodes for "
            f"{requests} lists across 3 serving replicas"
        )
    finally:
        for _fs, _tail, _furl, fshutdown in followers:
            fshutdown()
        lshutdown()
        for fstore, tail, _furl, _sd in followers:
            tail.stop()
        for fstore, tail, _furl, _sd in followers:
            tail.join(timeout=5.0)
            fstore.close()
        runtime.close()
        leader.close()

    return {
        "clients": W,
        "objects": n_obj,
        "window_s": window_s,
        "rate_1_replica_s": round(rate_1, 1),
        "rate_3_replicas_s": round(rate_3, 1),
        "read_scaling_x": round(scaling, 2),
        "scaling_gate_x": gate,
        "scaling_gated": scaling_gated,
        "cpu_cores": cores,
        "failover_reads": len(done_ts),
        "failover_read_p99_s": read_p99_s,
        "failover_max_gap_s": round(max_gap_s, 3),
        "gap_gate_s": gap_gate_s,
        "read_failovers": counters.get("remote.read_failover"),
        "not_yet_observed": counters.get("remote.not_yet_observed"),
        "leader_discoveries": counters.get("remote.leader_discoveries"),
        "encode_once_encodes": encodes,
        "encode_once_requests": requests,
    }


def _log(msg: str) -> None:
    """A role's progress line, on standard error (``bench.py``'s ``log``):
    standard output carries one JSON record a role."""
    print(msg, file=sys.stderr, flush=True)


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

    from minisched_tpu_torch.observability import hist as _hist

    counters.reset()
    # the lists this role's server observes in ``http.list_s`` count from
    # here (the histogram is process-wide)
    lists0 = _hist.GLOBAL.merged("http.list_s")[3]
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

        # the server observes a list after its body's last write, so the
        # storms' last observations can land after their clients return:
        # wait for every list served so far before the probe resets the
        # histogram, or they land in the probe's window
        served = counters.get("wire.relist_requests")
        deadline = time.monotonic() + 30.0
        while (_hist.GLOBAL.merged("http.list_s")[3] - lists0 < served
               and time.monotonic() < deadline):
            time.sleep(0.01)
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


def role_shard() -> Dict[str, Any]:
    """The sharded write plane must buy write throughput, not just
    partition it (``bench.py`` ``bench_shard``, DESIGN.md §30-31).
    Opt-in via ``BENCH_SHARD=1``.  Three phases:

    * **1-vs-2-group write storm** — the same W (at least 6) writer
      processes, each creating pods in its own namespace through the
      shard router, against a K=1 plane and then a K=2 plane (one
      replica a group, fsync on with a ``BENCH_SHARD_FSYNC_FLOOR_US``
      floor, 2,000 µs).  The namespaces are picked through a probe
      topology so half land on each K=2 group.  Gate: the K=2 rate at
      least ``BENCH_SHARD_GATE`` (1.5) times the K=1 rate, armed on 4
      cores or more, always recorded.
    * **cross-shard batch tax** — on the K=2 plane, p50/p99 of bind
      batches within one group against batches spanning both (two round
      trips and two barriers in parallel).  Recorded, not gated.
    * **skewed-load autosplit** — every writer hammers one g0 namespace
      on a fresh K=2 plane with the load watcher armed
      (``BENCH_AUTOSPLIT_P99_S``).  Gates: the watcher splits the hot
      namespace to g1 within ``BENCH_AUTOSPLIT_DEADLINE_S`` (60 s) with
      ``shard.autosplit.triggered`` counted, and the source group's
      windowed ``storage.group_wait_s`` p99 (from ``/metrics`` bucket
      deltas) recovers after the flip (armed on 4 cores or more)."""
    import tempfile
    import urllib.request

    from minisched_tpu_torch.api.objects import Binding, make_node, make_pod
    from minisched_tpu_torch.controlplane.shards import (
        ShardedPlane,
        ShardTopology,
    )
    from minisched_tpu_torch.observability import counters

    if os.environ.get("BENCH_SHARD", "0") == "0":
        raise Skip("BENCH_SHARD unset: sharded write plane role is opt-in")

    W = max(int(os.environ.get("BENCH_SHARD_WRITERS", "6")), 6)
    window_s = float(os.environ.get("BENCH_SHARD_WINDOW_S", "2.0"))
    gate = float(os.environ.get("BENCH_SHARD_GATE", "1.5"))
    floor_us = os.environ.get("BENCH_SHARD_FSYNC_FLOOR_US", "2000")
    batches = int(os.environ.get("BENCH_SHARD_BIND_BATCHES", "30"))
    ttl_s = 1.0

    counters.reset()
    tmp = tempfile.mkdtemp(prefix="bench-shard-")

    # writer namespaces balanced across the K=2 topology up front, so both
    # runs carry the same client load and only the group count differs
    probe = ShardTopology({"g0": ["http://a"], "g1": ["http://b"]})
    per_group: Dict[str, List[str]] = {"g0": [], "g1": []}
    i = 0
    while any(len(v) < (W + 1) // 2 for v in per_group.values()):
        ns = f"bench-ns-{i:03d}"
        per_group[probe.owner(ns)].append(ns)
        i += 1
    writer_ns = [per_group[gid][j] for j in range((W + 1) // 2)
                 for gid in ("g0", "g1")][:W]

    helper = os.path.join(tmp, "_write_storm.py")
    repo_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(helper, "w") as f:
        f.write(
            "import sys, time\n"
            f"sys.path.insert(0, {repo_dir!r})\n"
            "from minisched_tpu_torch.api.objects import make_pod\n"
            "from minisched_tpu_torch.controlplane.shards import "
            "ShardedStore\n"
            "seed, ns, window_s = sys.argv[1], sys.argv[2], "
            "float(sys.argv[3])\n"
            "ss = ShardedStore(seeds=[seed], timeout_s=10.0, retries=2)\n"
            "n = 0\n"
            "deadline = time.monotonic() + window_s\n"
            "try:\n"
            "    while time.monotonic() < deadline:\n"
            "        ss.create('Pod', make_pod('%s-%06d' % (ns, n), "
            "namespace=ns))\n"
            "        n += 1\n"
            "finally:\n"
            "    ss.close()\n"
            "print(n)\n")
    writer_env = dict(os.environ, CUDA_VISIBLE_DEVICES="")

    def storm(seed_url: str, label: str) -> float:
        procs = [subprocess.Popen(
            [sys.executable, helper, seed_url, writer_ns[w], str(window_s)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=writer_env)
            for w in range(W)]
        total = 0
        for proc in procs:
            out, err = proc.communicate(timeout=window_s + 120)
            if proc.returncode != 0:
                raise AssertionError(f"[shard] {label} WRITER FAILED: "
                                     f"{err.decode(errors='replace')[-300:]}")
            total += int(out.strip())
        rate = total / window_s
        _log(f"[shard] {label}: {rate:.0f} creates/s ({W} writer procs)")
        return rate

    old_floor = os.environ.get("MINISCHED_FSYNC_FLOOR_US")
    os.environ["MINISCHED_FSYNC_FLOOR_US"] = floor_us
    try:
        rates: Dict[int, float] = {}
        for k in (1, 2):
            plane = ShardedPlane(os.path.join(tmp, f"k{k}"), k=k,
                                 replicas_per_group=1, fsync=True,
                                 ttl_s=ttl_s)
            try:
                seeds = plane.start()
                rates[k] = storm(seeds[0], f"K={k} write storm")
            finally:
                plane.stop()
        scaling = rates[2] / rates[1] if rates[1] else 0.0
        cores = os.cpu_count() or 1
        scaling_gated = cores >= 4
        if scaling_gated and scaling < gate:
            raise AssertionError(
                f"[shard] WRITE SCALING UNDER GATE: {rates[2]:.0f}/s on 2 "
                f"groups vs {rates[1]:.0f}/s on 1 = {scaling:.2f}x < "
                f"{gate}x — a second leader group is not buying write "
                f"throughput")
        _log(f"[shard] write scaling 1->2 groups: {scaling:.2f}x"
             + ("" if scaling_gated else
                f" (gate skipped: {cores} core(s))"))

        # ---- cross-shard batch tax (K=2, measured separately) ---------
        plane = ShardedPlane(os.path.join(tmp, "tax"), k=2,
                             replicas_per_group=1, fsync=True, ttl_s=ttl_s)
        try:
            plane.start()
            ss = plane.client(timeout_s=10.0, retries=2)
            ns0, ns1 = per_group["g0"][0], per_group["g1"][0]
            ss.create("Node", make_node("bn1", capacity={
                "cpu": "64", "memory": "256Gi", "pods": 8 * batches}))
            for b in range(batches):
                ss.create("Pod", make_pod(f"s{b:03d}", namespace=ns0))
                ss.create("Pod", make_pod(f"t{b:03d}", namespace=ns0))
                ss.create("Pod", make_pod(f"x{b:03d}", namespace=ns0))
                ss.create("Pod", make_pod(f"y{b:03d}", namespace=ns1))
            single_lat, cross_lat = [], []
            for b in range(batches):
                t0 = time.monotonic()
                res = ss.bind_many_remote(
                    [Binding(f"s{b:03d}", ns0, "bn1"),
                     Binding(f"t{b:03d}", ns0, "bn1")],
                    return_objects=False)
                single_lat.append(time.monotonic() - t0)
                if any(isinstance(r, BaseException) for r in res):
                    raise AssertionError(f"[shard] single-group bind: {res}")
                t0 = time.monotonic()
                res = ss.bind_many_remote(
                    [Binding(f"x{b:03d}", ns0, "bn1"),
                     Binding(f"y{b:03d}", ns1, "bn1")],
                    return_objects=False)
                cross_lat.append(time.monotonic() - t0)
                if any(isinstance(r, BaseException) for r in res):
                    raise AssertionError(f"[shard] cross-shard bind: {res}")
            ss.close()
        finally:
            plane.stop()
        single_lat.sort()
        cross_lat.sort()
        single_p50 = _pct(single_lat, 0.50, 4)
        cross_p50 = _pct(cross_lat, 0.50, 4)
        tax = cross_p50 / single_p50 if single_p50 else 0.0
        _log(f"[shard] cross-shard batch tax: single p50 {single_p50}s vs "
             f"cross p50 {cross_p50}s = {tax:.2f}x")

        # ---- skewed-load autosplit -------------------------------------
        auto_env = {
            "MINISCHED_AUTOSPLIT": "1",
            "MINISCHED_AUTOSPLIT_P99_S": os.environ.get(
                "BENCH_AUTOSPLIT_P99_S", "0.004"),
            "MINISCHED_AUTOSPLIT_HOT": "2",
            "MINISCHED_AUTOSPLIT_INTERVAL_S": "0.25",
            "MINISCHED_AUTOSPLIT_COOLDOWN_S": "3600",
        }
        saved_env = {k: os.environ.get(k) for k in auto_env}
        os.environ.update(auto_env)

        def scrape_wait(base: str):
            """(cumulative group-wait buckets {le: count}, the autosplit
            trigger count) off one replica's ``/metrics``."""
            with urllib.request.urlopen(base + "/metrics",
                                        timeout=5.0) as r:
                text = r.read().decode()
            buckets: Dict[float, int] = {}
            fired = 0
            for line in text.splitlines():
                if line.startswith("storage_group_wait_seconds_bucket"):
                    le_s = line.split('le="', 1)[1].split('"', 1)[0]
                    le = float("inf") if le_s == "+Inf" else float(le_s)
                    val = line.split("} ", 1)[1].split(" #", 1)[0]
                    buckets[le] = buckets.get(le, 0) + int(float(val))
                elif line.startswith("shard_autosplit_triggered "):
                    fired = int(float(line.split()[1]))
            return buckets, fired

        def window_p99(before: dict, after: dict) -> float:
            """Nearest-rank p99 of the observations between two scrapes
            (cumulative-bucket deltas); 0.0 for an empty window."""
            bounds = sorted(set(before) | set(after))
            delta = {le: after.get(le, 0) - before.get(le, 0)
                     for le in bounds}
            n = delta.get(float("inf"), 0)
            if n <= 0:
                return 0.0
            rank = max(1, int(n * 0.99 + 0.999999))
            for le in bounds:
                if delta[le] >= rank:
                    return le
            return float("inf")

        split_deadline_s = float(os.environ.get(
            "BENCH_AUTOSPLIT_DEADLINE_S", "60"))
        post_window_s = float(os.environ.get(
            "BENCH_AUTOSPLIT_POST_WINDOW_S", "3.0"))
        plane = ShardedPlane(os.path.join(tmp, "auto"), k=2,
                             replicas_per_group=1, fsync=True, ttl_s=ttl_s)
        try:
            plane.start()
            hot_ns = per_group["g0"][0]
            g0_url = plane.groups["g0"].replicas[0].base_url
            stop_evt = threading.Event()
            write_errors: List[str] = []

            def skew_writer(widx: int) -> None:
                wss = plane.client(timeout_s=10.0, retries=4)
                n = 0
                try:
                    while not stop_evt.is_set():
                        try:
                            wss.create("Pod", make_pod(
                                f"skew-{widx}-{n:05d}", namespace=hot_ns))
                            n += 1
                        except Exception as e:  # noqa: BLE001
                            write_errors.append(repr(e))
                            time.sleep(0.1)
                finally:
                    wss.close()

            writers = [threading.Thread(target=skew_writer, args=(w,),
                                        daemon=True) for w in range(W)]
            for t in writers:
                t.start()
            s0, _ = scrape_wait(g0_url)
            t0 = time.monotonic()
            fired_at = None
            while time.monotonic() - t0 < split_deadline_s:
                try:
                    with urllib.request.urlopen(g0_url + "/shards/status",
                                                timeout=5.0) as r:
                        doc = json.loads(r.read())
                except OSError:
                    time.sleep(0.25)
                    continue
                if doc["topology"].get("overrides", {}).get(hot_ns) == "g1":
                    fired_at = time.monotonic() - t0
                    break
                time.sleep(0.25)
            s1, fired_count = scrape_wait(g0_url)
            if fired_at is None:
                stop_evt.set()
                raise AssertionError(
                    f"[shard] AUTOSPLIT NEVER FIRED within "
                    f"{split_deadline_s}s (hot p99 threshold "
                    f"{auto_env['MINISCHED_AUTOSPLIT_P99_S']}s, writer "
                    f"errors {len(write_errors)})")
            pre_p99 = window_p99(s0, s1)
            # the override flips before the watcher's trigger counter
            # bumps (the split's purge still runs): give it a moment
            cdl = time.monotonic() + 10.0
            while fired_count < 1 and time.monotonic() < cdl:
                time.sleep(0.25)
                _b, fired_count = scrape_wait(g0_url)
            time.sleep(1.5)  # the purge's tail and frozen retries
            s2, _ = scrape_wait(g0_url)
            time.sleep(post_window_s)
            s3, _ = scrape_wait(g0_url)
            post_p99 = window_p99(s2, s3)
            stop_evt.set()
            for t in writers:
                t.join(timeout=30.0)
            _log(f"[shard] autosplit fired after {fired_at:.1f}s (trigger "
                 f"count {fired_count}); source group_wait p99 "
                 f"{pre_p99:.4f}s before -> {post_p99:.4f}s after")
            if fired_count < 1:
                raise AssertionError(
                    "[shard] override flipped but shard.autosplit."
                    "triggered never counted — split did not come from "
                    "the watcher")
            recovered = post_p99 < pre_p99 or post_p99 == 0.0
            if scaling_gated and not recovered:
                raise AssertionError(
                    f"[shard] GROUP WAIT DID NOT RECOVER: p99 "
                    f"{pre_p99:.4f}s before the split vs {post_p99:.4f}s "
                    f"after — moving the hot namespace bought nothing")
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            plane.stop()
    finally:
        if old_floor is None:
            os.environ.pop("MINISCHED_FSYNC_FLOOR_US", None)
        else:
            os.environ["MINISCHED_FSYNC_FLOOR_US"] = old_floor

    return {
        "writers": W,
        "window_s": window_s,
        "fsync_floor_us": float(floor_us),
        "rate_1_group_s": round(rates[1], 1),
        "rate_2_groups_s": round(rates[2], 1),
        "write_scaling_x": round(scaling, 2),
        "scaling_gate_x": gate,
        "scaling_gated": scaling_gated,
        "cpu_cores": cores,
        "bind_batches": batches,
        "single_group_bind_p50_s": single_p50,
        "single_group_bind_p99_s": _pct(single_lat, 0.99, 4),
        "cross_shard_bind_p50_s": cross_p50,
        "cross_shard_bind_p99_s": _pct(cross_lat, 0.99, 4),
        "cross_shard_tax_x": round(tax, 2),
        "cross_bind_batches": counters.get("shard.cross_bind_batches"),
        "wrong_shard_chased": counters.get("shard.wrong_shard_chased"),
        "autosplit_fired_after_s": round(fired_at, 2),
        "autosplit_trigger_count": fired_count,
        "autosplit_pre_p99_s": round(pre_p99, 4),
        "autosplit_post_p99_s": round(post_p99, 4),
        "write_errors": len(write_errors),
    }


def _converge(client: Any, sched: Any, n_pods: int,
              deadline: float) -> int:
    """``bench.py``'s degraded-mode poll: the bound pods, replaying the
    parked ones, until all ``n_pods`` are bound or ``deadline`` passes;
    an injected fault on the poll's own list is skipped."""
    bound = 0
    while time.monotonic() < deadline:
        try:
            bound = sum(1 for p in client.pods().list() if p.spec.node_name)
        except Exception:
            continue  # injected list fault on our own poll
        if bound >= n_pods:
            break
        if sched.queue.stats()["unschedulable"]:
            sched.queue.flush_unschedulable_leftover()
            sched.queue.flush_backoff_completed()
        time.sleep(0.25)
    return bound


def _assume_leaked(sched: Any) -> bool:
    """True unless the assume ledger drains within 10 assume TTLs."""
    drain_deadline = time.monotonic() + 10 * sched.assume_ttl_s
    while time.monotonic() < drain_deadline:
        with sched._assumed_lock:
            if not sched._assumed:
                return False
        time.sleep(0.25)
    return True


def role_chaos(device: Any = None) -> Dict[str, Any]:
    """Chaos soak at bench scale (``bench_chaos``): the device engine over
    a WAL store while the fault fabric injects store, bind, watch and WAL
    failures on a seeded schedule (``BENCH_CHAOS_SEED`` reproduces the
    injections).  The record carries convergence, the leak and
    double-bind audits and the injected and recovered counts."""
    import tempfile

    from minisched_tpu_torch.api.objects import make_node, make_pod
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore
    from minisched_tpu_torch.faults import FaultFabric, wal_double_binds
    from minisched_tpu_torch.observability import counters
    from minisched_tpu_torch.service.config import default_full_roster_config
    from minisched_tpu_torch.service.service import SchedulerService

    seed = int(os.environ.get("BENCH_CHAOS_SEED", "1234"))
    n_nodes = int(os.environ.get("BENCH_CHAOS_NODES", "128"))
    n_pods = int(os.environ.get("BENCH_CHAOS_PODS", "2000"))
    with tempfile.TemporaryDirectory(prefix="minisched-chaos-") as tmp:
        wal = os.path.join(tmp, "c.wal")
        store = DurableObjectStore(wal)
        client = Client(store=store)
        for i in range(n_nodes):
            client.nodes().create(make_node(
                f"node{i:04d}", unschedulable=i % 16 == 0,
                capacity={"cpu": "64", "memory": "128Gi", "pods": 256}))
        client.pods().create_many([
            make_pod(f"cp{i:05d}", requests={"cpu": "500m", "memory": "64Mi"})
            for i in range(n_pods)])
        fabric = (
            FaultFabric(seed)
            .on("store.update", rate=0.10)
            .on("store.get", rate=0.05)
            .on("watch.drop", rate=0.02, max_fires=16, keys={"Pod", "Node"})
            .on("wal.append", rate=0.03, max_fires=16)
            .on("engine.bind", rate=0.05, max_fires=16)
        )
        counters.reset()
        svc = SchedulerService(client)
        sched = svc.start_scheduler(
            default_full_roster_config(), device_mode=True,
            max_wave=int(os.environ.get("BENCH_CHAOS_WAVE", "512")),
            device=device)
        sched.faults = fabric
        sched.assume_ttl_s = 3.0
        store.fault_injector = fabric.as_store_injector()
        store.faults = fabric
        t0 = time.monotonic()
        deadline = t0 + float(os.environ.get("BENCH_CHAOS_DEADLINE_S", "300"))
        try:
            bound = _converge(client, sched, n_pods, deadline)
            elapsed = time.monotonic() - t0
            # quiesce: the assume ledger must drain (lease confirm path)
            leaked = _assume_leaked(sched)
            store.fault_injector = None
            store.faults = None
            # per-kind cache staleness and reconnects at quiesce: a cache
            # still stale past the threshold never re-verified itself
            staleness = svc.informer_factory.staleness()
            max_staleness = float(
                os.environ.get("BENCH_CHAOS_MAX_STALENESS_S", "30"))
            loop_errors = sched.loop_errors
            if bound < n_pods:
                raise AssertionError(
                    f"[chaos] DID NOT CONVERGE: {bound}/{n_pods} bound; "
                    f"faults={fabric.stats()} "
                    f"counters={counters.snapshot()}")
            if leaked:
                raise AssertionError("[chaos] ASSUMED-CAPACITY LEAK at "
                                     "quiesce")
            for kind, rec in staleness.items():
                if rec["staleness_s"] > max_staleness:
                    raise AssertionError(
                        f"[chaos] STALE INFORMER at quiesce: {kind} "
                        f"unverified for {rec['staleness_s']}s (> "
                        f"{max_staleness}s); staleness={staleness}")
        finally:
            store.fault_injector = None
            store.faults = None
            svc.shutdown_scheduler()
            store.close()
        violations = wal_double_binds(wal)
    if violations:
        raise AssertionError(f"[chaos] DOUBLE BIND: {violations[:5]}")
    stats = fabric.stats()
    _log(f"[chaos] {n_pods} pods converged under "
         f"{sum(stats['fires'].values())} injected faults in {elapsed:.1f}s "
         f"(seed={seed}; no leak, no double-bind)")
    return {
        "pods": n_pods,
        "nodes": n_nodes,
        "total_s": elapsed,
        "seed": seed,
        "injected": stats["fires"],
        # the port's: each point's draws (fabric calls), of which
        # ``injected`` fired
        "draws": stats["calls"],
        "recovered": {k: v for k, v in counters.snapshot().items()
                      if v and not k.startswith("assume.lease_renewed")},
        "staleness": staleness,
        "loop_errors": loop_errors,
        "leak": False,
        "double_bind": False,
    }


def role_disk(device: Any = None) -> Dict[str, Any]:
    """Storage-integrity soak at bench scale (``bench_disk``): the device
    engine over an archived WAL store with periodic compaction and the
    scrub while the disk fabric refuses appends, runs an ENOSPC episode,
    flips a bit and rots a checkpoint.  The record carries the degraded
    dwell, the scrub and fsck findings (the flip must be convicted) and
    the exactly-once audit."""
    import tempfile

    from minisched_tpu_torch.api.objects import make_node, make_pod
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore
    from minisched_tpu_torch.controlplane.fsck import fsck
    from minisched_tpu_torch.faults import FaultFabric, wal_double_binds
    from minisched_tpu_torch.observability import counters
    from minisched_tpu_torch.service.config import default_full_roster_config
    from minisched_tpu_torch.service.service import SchedulerService

    seed = int(os.environ.get("BENCH_CHAOS_SEED", "1234"))
    n_nodes = int(os.environ.get("BENCH_DISK_NODES", "64"))
    n_pods = int(os.environ.get("BENCH_DISK_PODS", "1500"))
    with tempfile.TemporaryDirectory(prefix="minisched-disk-") as tmp:
        wal = os.path.join(tmp, "d.wal")
        store = DurableObjectStore(wal, archive_compacted=True,
                                   probe_interval_s=0.05)
        store.start_scrub(interval_s=0.5)
        client = Client(store=store)
        client.nodes().create_many([
            make_node(f"node{i:04d}",
                      capacity={"cpu": "64", "memory": "128Gi", "pods": 256})
            for i in range(n_nodes)])
        client.pods().create_many([
            make_pod(f"dk{i:05d}", requests={"cpu": "500m", "memory": "64Mi"})
            for i in range(n_pods)])
        # armed after the seed: the workload, not the setup, takes the
        # weather
        fabric = (
            FaultFabric(seed)
            .on("wal.append", rate=0.05)
            .on("disk.enospc", rate=1.0, after=100, max_fires=8)
            .on("wal.bitflip", rate=1.0, after=250, max_fires=1)
            .on("ckpt.corrupt", rate=1.0, after=1, max_fires=1)
        )
        store.faults = fabric
        counters.reset()
        compact_stop = threading.Event()

        def compactor() -> None:
            while not compact_stop.wait(0.5):
                try:
                    store.compact()
                except Exception:
                    pass  # ENOSPC mid-compaction is this role's weather

        threading.Thread(target=compactor, daemon=True).start()
        svc = SchedulerService(client)
        sched = svc.start_scheduler(
            default_full_roster_config(), device_mode=True,
            max_wave=int(os.environ.get("BENCH_DISK_WAVE", "256")),
            device=device)
        sched.assume_ttl_s = 3.0
        t0 = time.monotonic()
        deadline = t0 + float(os.environ.get("BENCH_DISK_DEADLINE_S", "300"))
        try:
            bound = _converge(client, sched, n_pods, deadline)
            elapsed = time.monotonic() - t0
            leaked = _assume_leaked(sched)
            loop_errors = sched.loop_errors
            if bound < n_pods:
                raise AssertionError(
                    f"[disk] DID NOT CONVERGE: {bound}/{n_pods} bound; "
                    f"faults={fabric.stats()} "
                    f"counters={counters.snapshot()}")
            if leaked:
                raise AssertionError("[disk] ASSUMED-CAPACITY LEAK at "
                                     "quiesce")
        finally:
            compact_stop.set()
            svc.shutdown_scheduler()
            scrub = store.scrub()
            stats = store.storage_stats()
            store.faults = None
            store.close()
        violations = wal_double_binds(wal)
        report = fsck(wal)
    if violations:
        raise AssertionError(f"[disk] DOUBLE BIND: {violations[:5]}")
    fire_stats = fabric.stats()
    if fire_stats["fires"].get("disk.enospc", 0) < 1:
        raise AssertionError("[disk] ENOSPC episode never fired")
    flipped = fire_stats["fires"].get("wal.bitflip", 0)
    crc_findings = sum("crc mismatch" in e for e in report["errors"])
    if flipped and not crc_findings:
        raise AssertionError(
            f"[disk] UNDETECTED BIT-FLIP: {flipped} injected, fsck found "
            f"none; report={report['errors']}")
    _log(f"[disk] {n_pods} pods converged in {elapsed:.1f}s under "
         f"{sum(fire_stats['fires'].values())} disk faults (degraded "
         f"{stats['degraded_episodes']}x / {stats['degraded_dwell_s']}s "
         f"dwell; {flipped} bit-flip(s) detected by fsck; no leak, no "
         f"double-bind)")
    return {
        "pods": n_pods,
        "nodes": n_nodes,
        "total_s": elapsed,
        "seed": seed,
        "injected": fire_stats["fires"],
        "degraded_episodes": stats["degraded_episodes"],
        "degraded_dwell_s": stats["degraded_dwell_s"],
        "scrub_findings": scrub["findings"],
        "fsck_errors": report["errors"],
        "bitflips_detected": crc_findings,
        "group_commit": {
            "groups": counters.get("storage.group_commit.groups"),
            "records": counters.get("storage.group_commit.records"),
            "fsyncs_saved": counters.get("storage.group_commit.fsyncs_saved"),
        },
        "recovered": {k: v for k, v in counters.snapshot().items()
                      if v and (k.startswith("storage.")
                                or k.startswith("remote."))},
        "loop_errors": loop_errors,
        "leak": False,
        "double_bind": False,
    }


def role_ha(device: Any = None) -> Dict[str, Any]:
    """The HA plane at bench scale (``bench_ha``): N active-active
    sharded device engines over one WAL store, one killed mid-run with
    its lease abandoned (peers must time it out).  The record carries
    the TTL-bounded rebalance, convergence, exactly-once binds across the
    full history and the ``ha.*`` counters.  The engines share this
    process and the card; their pods carry no cross-pod constraint, so
    no engine captures a scan-lane graph (``prewarm_scan=False``), which
    another engine's launches on the card would break."""
    import tempfile

    from minisched_tpu_torch.api.objects import make_node, make_pod
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore
    from minisched_tpu_torch.faults import wal_double_binds
    from minisched_tpu_torch.ha import start_ha_engine
    from minisched_tpu_torch.observability import counters
    from minisched_tpu_torch.service.config import default_full_roster_config

    n_engines = int(os.environ.get("BENCH_HA_ENGINES", "3"))
    n_nodes = int(os.environ.get("BENCH_HA_NODES", "48"))
    n_pods = int(os.environ.get("BENCH_HA_PODS", "1200"))
    ttl_s = float(os.environ.get("BENCH_HA_TTL_S", "2.0"))
    with tempfile.TemporaryDirectory(prefix="minisched-ha-") as tmp:
        wal = os.path.join(tmp, "ha.wal")
        store = DurableObjectStore(wal, archive_compacted=True)
        setup = Client(store=store)
        setup.nodes().create_many([
            make_node(f"node{i:04d}",
                      capacity={"cpu": "64", "memory": "128Gi", "pods": 256})
            for i in range(n_nodes)])
        pods = [make_pod(f"hp{i:05d}",
                         requests={"cpu": "500m", "memory": "64Mi"})
                for i in range(n_pods)]
        first = (2 * n_pods) // 3
        setup.pods().create_many(pods[:first])
        counters.reset()
        t0 = time.monotonic()
        engines = []
        try:
            for i in range(n_engines):
                engines.append(start_ha_engine(
                    Client(store=store), f"engine-{i}",
                    cfg=default_full_roster_config(), ttl_s=ttl_s,
                    device=device, prewarm_scan=False))

            def bound() -> int:
                return sum(1 for p in setup.pods().list()
                           if p.spec.node_name)

            deadline = time.monotonic() + float(
                os.environ.get("BENCH_HA_DEADLINE_S", "240"))
            while time.monotonic() < deadline and bound() < first:
                time.sleep(0.2)
            if bound() < first:
                raise AssertionError(f"[ha] first burst stalled: "
                                     f"{bound()}/{first}")
            # kill one engine (no lease release), keep the load coming
            victim = engines[len(engines) // 2]
            survivors = [e for e in engines if e is not victim]
            t_kill = time.monotonic()
            victim.kill()
            engines.remove(victim)
            setup.pods().create_many(pods[first:])
            rebalance_s = None
            while time.monotonic() < deadline:
                if all(victim.membership.member_id
                       not in e.membership.members() for e in survivors):
                    rebalance_s = time.monotonic() - t_kill
                    break
                time.sleep(0.05)
            if rebalance_s is None:
                raise AssertionError("[ha] survivors never dropped the dead "
                                     "member")
            bound_n = 0
            while time.monotonic() < deadline:
                bound_n = bound()
                if bound_n >= n_pods:
                    break
                time.sleep(0.2)
            elapsed = time.monotonic() - t0
            loop_errors = sum(e.scheduler.loop_errors for e in survivors)
        finally:
            for e in engines:
                e.stop()
            store.close()
        violations = wal_double_binds(wal)
    if bound_n < n_pods:
        raise AssertionError(f"[ha] DID NOT CONVERGE: {bound_n}/{n_pods} "
                             "bound")
    # rebalance bounded by the lease TTL (+ a heartbeat tick and margin)
    if rebalance_s > ttl_s + ttl_s / 3.0 + 1.5:
        raise AssertionError(f"[ha] SLOW REBALANCE: {rebalance_s:.2f}s")
    if violations:
        raise AssertionError(f"[ha] DOUBLE BIND: {violations[:5]}")
    _log(f"[ha] {n_pods} pods, {n_engines} engines, 1 kill: converged in "
         f"{elapsed:.1f}s, rebalance {rebalance_s:.2f}s (ttl {ttl_s}s)")
    return {
        "pods": n_pods,
        "nodes": n_nodes,
        "engines": n_engines,
        "kills": 1,
        "lease_ttl_s": ttl_s,
        "total_s": elapsed,
        "rebalance_s": rebalance_s,
        "loop_errors": loop_errors,
        "double_bind": False,
        "counters": {k: v for k, v in counters.snapshot().items()
                     if k.startswith("ha.")},
    }



def role_mesh(device: Any = None, mesh: Any = None) -> Dict[str, Any]:
    """``bench_mesh`` (``bench.py:1984``): the live engine over a device
    mesh against the single-device engine on the same uid-pinned
    workload (``BENCH_MESH_NODES`` 512, ``BENCH_MESH_PODS`` 6,144,
    ``BENCH_MESH_WAVE`` 1,024, the full roster, pipelined).  Its gates:
    parity; the baseline not sharded; at least one sharded wave and no
    fallback; the pipeline not serial under the mesh; the exactly-once
    and capacity audits on both laps; each lap's build and warm (the
    engine's start: evaluator, kernels, prewarm) within
    ``BENCH_MESH_COMPILE_BUDGET_S``; and, when the mesh spans distinct
    devices, its ``wave_device`` total strictly below single-device's.
    ``mesh`` None: every visible card, skipped below two."""
    from minisched_tpu_torch.api.objects import make_node, make_pod
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.observability import counters
    from minisched_tpu_torch.observability.profiling import CycleMetrics
    from minisched_tpu_torch.parallel.sharding import (
        make_mesh,
        mesh_shape_key,
    )
    from minisched_tpu_torch.service.config import default_full_roster_config
    from minisched_tpu_torch.service.service import SchedulerService

    if mesh is None:
        if torch.cuda.device_count() < 2:
            raise Skip("mesh role needs more than one device (distinct "
                       "cards; a virtual mesh shows no speed-up)")
        mesh = make_mesh()
    n_nodes = int(os.environ.get("BENCH_MESH_NODES", "512"))
    n_pods = int(os.environ.get("BENCH_MESH_PODS", "6144"))
    max_wave = int(os.environ.get("BENCH_MESH_WAVE", "1024"))
    budget_s = float(os.environ.get("BENCH_MESH_COMPILE_BUDGET_S", "300"))
    nodes = [make_node(f"node{i:04d}",
                       capacity={"cpu": "64", "memory": "128Gi", "pods": 256})
             for i in range(n_nodes)]

    def lap(device_mesh: Any, tag: str):
        client = Client()
        client.nodes().create_many([n.clone() for n in nodes],
                                   return_objects=False)
        pods = []
        for i in range(n_pods):
            p = make_pod(f"mp{i:05d}",
                         requests={"cpu": "100m", "memory": "64Mi"})
            # the tie-break seed pinned: the two laps compare pod for pod
            p.metadata.uid = f"mesh-uid-{i:05d}"
            pods.append(p)
        client.pods().create_many(pods, return_objects=False)
        bound_n = 0
        mu = threading.Lock()

        def counting(pod, node_name, status):
            nonlocal bound_n
            if node_name:
                with mu:
                    bound_n += 1

        counters.reset()
        metrics = CycleMetrics()
        svc = SchedulerService(client)
        t_warm = time.monotonic()
        sched = svc.start_scheduler(
            default_full_roster_config(), device_mode=True,
            max_wave=max_wave, device_mesh=device_mesh, device=device,
            on_decision=counting, metrics=metrics, prewarm_scan=False)
        warm_s = time.monotonic() - t_warm
        t0 = time.monotonic()
        try:
            deadline = time.monotonic() + 900
            while time.monotonic() < deadline:
                with mu:
                    if bound_n >= n_pods:
                        break
                time.sleep(0.05)
            with mu:
                if bound_n < n_pods:
                    raise AssertionError(f"[mesh] {tag}: only {bound_n}/"
                                         f"{n_pods} bound")
            elapsed = time.monotonic() - t0
            snap = metrics.snapshot()
            loop_errors = sched.loop_errors
        finally:
            svc.shutdown_scheduler()
        # exactly once and within capacity: faster may never mean wrong
        placements = {}
        cpu: Dict[str, int] = defaultdict(int)
        cnt: Dict[str, int] = defaultdict(int)
        for p in client.pods().list():
            if not p.spec.node_name:
                raise AssertionError(f"[mesh] {tag}: pod {p.metadata.name} "
                                     "left unbound")
            placements[p.metadata.name] = p.spec.node_name
            cpu[p.spec.node_name] += p.resource_requests().milli_cpu
            cnt[p.spec.node_name] += 1
        for node in client.nodes().list():
            alloc = node.status.allocatable
            name = node.metadata.name
            if cpu[name] > alloc.milli_cpu or cnt[name] > alloc.pods:
                raise AssertionError(f"[mesh] {tag}: NODE OVER ALLOCATABLE "
                                     f"{name}")

        def phase(name, field):
            return round(snap.get(name, {}).get(field, 0.0), 3)

        out = {
            "total_s": round(elapsed, 2),
            "warm_s": round(warm_s, 2),
            "pods_per_sec_e2e": round(n_pods / elapsed, 1),
            "device_total_s": phase("wave_device", "total_s"),
            "build_total_s": phase("wave_pipeline_build", "total_s"),
            "stall_total_s": phase("wave_pipeline_stall", "total_s"),
            "pipelined_waves": counters.get("wave_pipeline.waves"),
            "loop_errors": loop_errors,
            "wave_mesh": {name: counters.get(f"wave_mesh.{name}") for name in (
                "pod_shards", "node_shards", "waves", "fallbacks",
                "pad_pod_rows", "pad_node_rows")},
        }
        _log(f"[mesh] {tag}: {n_pods} pods in {elapsed:.1f}s (device "
             f"{out['device_total_s']}s, warm {warm_s:.1f}s, mesh waves "
             f"{out['wave_mesh']['waves']}, fallbacks "
             f"{out['wave_mesh']['fallbacks']})")
        return out, placements

    # mesh=False pins the baseline to one device: with several visible,
    # None would shard it too and compare the mesh with itself
    single, base_placements = lap(False, "single-device")
    sharded, mesh_placements = lap(mesh, f"mesh {mesh_shape_key(mesh)}")

    if mesh_placements != base_placements:
        diff = sum(1 for k in base_placements
                   if mesh_placements.get(k) != base_placements[k])
        raise AssertionError(f"[mesh] PARITY BROKEN: {diff} placements "
                             "differ")
    if single["wave_mesh"]["waves"]:
        raise AssertionError("[mesh] BASELINE RAN SHARDED")
    if sharded["wave_mesh"]["waves"] == 0:
        raise AssertionError("[mesh] NO WAVE RAN SHARDED")
    if sharded["wave_mesh"]["fallbacks"]:
        raise AssertionError(f"[mesh] {sharded['wave_mesh']['fallbacks']} "
                             "waves fell back to the single-device evaluator")
    if single["loop_errors"] or sharded["loop_errors"]:
        raise AssertionError("[mesh] the engine loop raised")
    if (sharded["build_total_s"] > 0
            and sharded["stall_total_s"] >= sharded["build_total_s"]):
        raise AssertionError(
            f"[mesh] PIPELINE REGRESSED TO SERIAL under the mesh: stall "
            f"{sharded['stall_total_s']}s >= build "
            f"{sharded['build_total_s']}s")
    for tag, rec in (("single", single), ("mesh", sharded)):
        if rec["warm_s"] > budget_s:
            raise AssertionError(f"[mesh] {tag} build and warm "
                                 f"{rec['warm_s']}s exceeds {budget_s}s")
    # the device-time gate is a speed claim: it needs distinct devices (a
    # virtual mesh repeats one, and splits nothing)
    devices = {d for row in mesh.devices for d in row}
    if len(devices) > 1:
        if sharded["device_total_s"] >= single["device_total_s"]:
            raise AssertionError(
                f"[mesh] SHARDED DEVICE TIME NOT BELOW SINGLE-DEVICE: "
                f"{sharded['device_total_s']}s >= "
                f"{single['device_total_s']}s")
        device_gate = "passed"
    else:
        device_gate = (f"not armed: the mesh's {mesh.size} entries are one "
                       "device")
    _log(f"[mesh] device-time gate {device_gate}")
    return {
        "nodes": n_nodes,
        "pods": n_pods,
        "mesh_shape": [list(kv) for kv in mesh_shape_key(mesh)],
        "distinct_devices": len(devices),
        "single_device": single,
        "sharded": sharded,
        "device_speedup": round(single["device_total_s"]
                                / max(sharded["device_total_s"], 1e-9), 3),
        "device_gate": device_gate,
        "parity_ok": True,
    }


def run_role(role: str) -> Dict[str, Any]:
    """One role's record; ``{"skipped": reason}`` without a card."""
    fn = globals()[f"role_{role}"]
    if not torch.cuda.is_available():
        return {"role": role, "skipped": "no CUDA device is available"}
    from minisched_tpu_torch.utils import build

    build.load_library()
    from minisched_tpu_torch.ops import kernels

    card = card_line()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    try:
        rec = fn()
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
