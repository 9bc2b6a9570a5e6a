"""Bench roles of the port: one JSON record per role, on the card.

Run from the root of the repository on a machine with a CUDA card:

    python3 -m minisched_tpu_torch.bench [--only ROLE]

One role for each ``bench.py`` role the port can run (``ROLES``):

======================  ==================================================
``headline``            ``bench_headline`` (``bench.py:998``): 10,000
                        nodes x 100,000 pods, the fused route, every
                        placement against ``headline_oracle``
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
``gang``                config 5 with 4,096 gangs
                        (``fullchain.mk_c5_gang_cluster``) in repair waves
                        with ``gang_roster_config``
======================  ==================================================

The ``gang`` role is the wave path only: gang members are placed one by
one, and the share of gangs on one slice is reported, not gated.
``bench.py``'s ``gang`` role (``:3159``) drives the live engine through
churn rounds and a deadlock probe; that role waits for ROADMAP item 10d.

Each record holds the role's metrics (times are host wall seconds closed
by a device synchronise; ``device_ms_*`` come from the profiler or CUDA
events; ``peak_mem_gib`` from ``torch.cuda.max_memory_allocated``),
``bench.py``'s key where it names the same quantity, and the card's name
and power limit (``nvidia-smi``).  Without a card a role prints
``{"skipped": reason}`` and exits 0: it never runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Any, Callable, Dict, List

import numpy as np
import torch

ROLES = ("headline", "c2", "c3", "c4", "c5", "c5_waves", "fullchain_parity",
         "c5x", "gang", "c5x_live")

GIB = 2**30


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


def role_gang() -> Dict[str, Any]:
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


def run_role(role: str) -> Dict[str, Any]:
    """One role's record; ``{"skipped": reason}`` without a card."""
    if not torch.cuda.is_available():
        return {"role": role, "skipped": "no CUDA device is available"}
    from minisched_tpu_torch.utils import build

    build.load_library()
    card = card_line()
    t0 = time.monotonic()
    rec = globals()[f"role_{role}"]()
    return {"role": role, **rec, "role_wall_s": time.monotonic() - t0,
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
