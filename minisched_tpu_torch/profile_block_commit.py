"""The blocked lane's step on the card: its device operations and time,
and its block commit alone (the kernel of ``csrc/scan_commit.cu``
against its plain twin).

Run from the root of the repository on a machine with a CUDA card:

    python3 -m minisched_tpu_torch.profile_block_commit [--apps A] [nodes ...]

For an older tree of the port, run a copy of this file from outside the
package (the package's ``queue`` would shadow the standard library's
next to it) with that tree's root on ``PYTHONPATH``:

    cp minisched_tpu_torch/profile_block_commit.py _checkout/pbc.py
    PYTHONPATH=_checkout/<tree> python3 _checkout/pbc.py

A tree without ``ops/scan_commit.py`` gets the lane's numbers alone.

The shape is the benchmark cell's: nodes of 4 CPU, 32 Gi and 110 pods in
zones moon-1..3, each with its hostname label, one running pod of 100m /
500 Mi a node, and 256 pending pods of one spread group (100m / 500 Mi,
DoNotSchedule spreads of max skew 5 over the hostname and the zone), so
the lane runs one live pod a block of 32: one call of 8,192 rows, as the
live engine's.  ``--apps A`` splits the pending pods into A spread groups
instead, so a block holds up to A live pods (config 5's lane runs full
blocks).  For 5,000 nodes (5,120 columns) and 10,000 (10,112), or the
counts given, it prints one JSON line:

* ``lane``: steps, device operations and device ms a step (one replay
  profiled, the rest between CUDA events), ``block_commit`` calls
  recorded a step;
* ``lane_twin`` (trees with the kernel): the same with the step's commit
  run as the plain twin on the card, the step as it was before the
  kernel;
* ``commit``: the first block's commit, kernel and twin, each a CUDA
  graph of 20 calls between two events on a copy of the state: ms a
  call, the twin's device operations, the least bytes (the block's input
  rows read once, the state entries the commit changes read and written
  once, one topology-domain row a committed pod's zone-like combo), that
  bound's ms at 3.35 TB/s and the kernel's share of it; ``equal``: the
  kernel's state after one call is the twin's, tensor for tensor.

Without a card it raises.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
from dataclasses import replace
from typing import Any, Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile

from minisched_tpu_torch.api.objects import (
    LabelSelector,
    TopologySpreadConstraint,
    make_node,
    make_pod,
)
from minisched_tpu_torch.engine.scan_groups import (
    interaction_sets,
    order_into_blocks,
)
from minisched_tpu_torch.headline import pods_by_node
from minisched_tpu_torch.models import tables
from minisched_tpu_torch.models.constraints import build_constraint_tables
from minisched_tpu_torch.ops import sequential
from minisched_tpu_torch.ops.state import COMMITTED_COLUMNS
from minisched_tpu_torch.plugins.registry import build_plugins
from minisched_tpu_torch.service.config import default_full_roster_config

HOST, ZONE = "kubernetes.io/hostname", "topology.kubernetes.io/zone"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
BLOCK = 32
PENDING = 256  # one call of 8,192 rows
GRAPH_CALLS = 20


def cell_tables(n_nodes: int, device: torch.device, apps: int = 1,
                seed: int = 7):
    """(pod table, node table, constraint tables) of one lane call at the
    cell's shape with ``n_nodes`` nodes; with ``apps`` > 1 the pending
    pods split into that many spread groups (labels ``foo: bar<i>``), so a
    block holds up to ``apps`` live pods, as config 5's lane's blocks do."""
    rng = random.Random(seed)
    nodes = [make_node(f"node-{i:05d}",
                       labels={HOST: f"node-{i:05d}",
                               ZONE: f"moon-{i % 3 + 1}"},
                       capacity={"cpu": "4", "memory": "32Gi", "pods": 110})
             for i in range(n_nodes)]
    running = []
    for i in range(n_nodes):
        p = make_pod(f"init-{i:05d}",
                     requests={"cpu": "100m", "memory": "500Mi"})
        p.spec.node_name = rng.choice(nodes).metadata.name
        running.append(p)
    pods = []
    for i in range(PENDING):
        app = {"foo": "bar" if apps == 1 else f"bar{i % apps}"}
        sel = LabelSelector(match_labels=app)
        p = make_pod(f"spread-{i:04d}", labels=app,
                     requests={"cpu": "100m", "memory": "500Mi"})
        p.spec.topology_spread_constraints = [
            TopologySpreadConstraint(max_skew=5, topology_key=key,
                                     when_unsatisfiable="DoNotSchedule",
                                     label_selector=sel)
            for key in (HOST, ZONE)]
        pods.append(p)
    order = order_into_blocks(pods, interaction_sets(pods), BLOCK)
    flat = [m for blk in order for m in blk]
    pad = [i for i, m in enumerate(flat) if m is None]
    flat = [m if m is not None else make_pod("scan-pad") for m in flat]
    nt, _ = tables.build_node_table(nodes, pods_by_node(running),
                                    device=device)
    pt, _ = tables.build_pod_table(flat, capacity=len(flat), device=device,
                                   invalid_rows=pad)
    ex = build_constraint_tables(flat, nodes, running,
                                 pod_capacity=pt.capacity,
                                 node_capacity=nt.capacity, scan_planes=True,
                                 device=device)
    return pt, nt, ex


def _scheduler():
    cfg = default_full_roster_config()
    chains = build_plugins(cfg)
    return sequential.BlockedSequentialScheduler(
        chains.filter, chains.pre_score, chains.score,
        weights=cfg.score_weights(), block_size=BLOCK)


def lane(pt, nt, ex) -> Dict[str, Any]:
    """One lane call with one replay profiled."""
    log = sequential.StepLog(count_ops=True)
    _, choice, _, accepted = _scheduler()(pt, nt, ex, log=log)
    torch.cuda.synchronize()
    loop = log.loops[0]
    return {"steps": loop.steps, "device_ops_per_step": loop.device_ops_per_step,
            "device_ms_per_step": loop.device_ms_per_step,
            "block_commit_per_step": getattr(loop, "block_commit_per_step",
                                             None),
            "placed": int(((choice >= 0) & accepted).sum()),
            "top_ops": [[name[:60], count, round(us, 1)]
                        for name, count, us in loop.top_ops]}


def _graph_ms(fn) -> float:
    """ms a call of ``fn`` as a CUDA graph of GRAPH_CALLS calls, after one
    warm-up replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / GRAPH_CALLS


def _device_ops(fn) -> int:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.events() if e.device_type == cuda)


def commit(pt, nt, ex, scan_commit) -> Dict[str, Any]:
    """The first block's commit alone: kernel against twin."""
    seen: List[tuple] = []
    real = sequential.block_commit

    def record(state, *args):
        if not seen:
            seen.append(({k: v.clone() for k, v in state.items()}, *args))
        real(state, *args)

    sequential.block_commit = record
    try:
        _scheduler()(pt, nt, ex)
    finally:
        sequential.block_commit = real
    torch.cuda.synchronize()
    initial, nodes, *args = seen[0]
    pods, extra, rows, choice, best, rule, combos, volumes = args

    def fresh() -> Dict[str, torch.Tensor]:
        return {k: v.clone() for k, v in initial.items()}

    def call(fn, state) -> None:
        # the node table's committed columns are the state's, as the
        # lane's carried table
        fn(state, replace(nodes, **{c: state[c] for c in COMMITTED_COLUMNS}),
           *args)

    def ops(fn) -> int:
        state = fresh()
        return _device_ops(lambda: call(fn, state))

    got, want = fresh(), fresh()
    call(scan_commit.block_commit_cuda, got)
    call(scan_commit.block_commit_plain, want)
    torch.cuda.synchronize()
    equal = all(torch.equal(got[k], want[k]) for k in want)
    # least bytes: the block's input rows, the changed state entries read
    # and written, one topology-domain row a committed zone-like combo
    inputs = [rows, choice, best, pods.valid, pods.req_cpu, pods.req_mem,
              pods.req_eph, pods.port, pods.num_ports]
    if combos is not None:
        inputs += [extra.pod_matches_combo, extra.pan_combo, extra.pan_n,
                   extra.ppa_combo, extra.ppa_w, extra.ppa_n, extra.pa_combo,
                   extra.pa_n]
    if volumes is not None:
        inputs += [extra.pod_missing, extra.pod_vols_fam]
        inputs += [p.index_select(0, rows) for p in (
            volumes.slot_cnt, volumes.slot_vol, volumes.slot_ro,
            volumes.slot_fam, volumes.slot_dup)]
    changed = sum(int((got[k] != initial[k]).sum()) * got[k].element_size()
                  for k in got)
    zone_rows = 0
    if combos is not None:
        committed = got["accepted"][rows]
        pmc = extra.pod_matches_combo & committed[:, None]
        zone_rows = int((pmc & ~combos.uniq[None, :]).sum())
    n = int(nt.valid.shape[0])
    least = (sum(t.numel() * t.element_size() for t in inputs)
             + 2 * changed + zone_rows * n * 4)
    kernel_ms = _graph_ms(lambda: call(scan_commit.block_commit_cuda, got))
    twin_ms = _graph_ms(lambda: call(scan_commit.block_commit_plain, want))
    bound_ms = least / HBM_BYTES_PER_S * 1e3
    return {"shape": [int(choice.shape[0]), n], "equal": equal,
            "kernel_ms": kernel_ms, "twin_ms": twin_ms,
            "twin_device_ops": ops(scan_commit.block_commit_plain),
            "kernel_device_ops": ops(scan_commit.block_commit_cuda),
            "least_bytes": least, "bound_ms": bound_ms,
            "kernel_share_pct": 100.0 * bound_ms / kernel_ms}


def lane_with_twin(pt, nt, ex, scan_commit) -> Dict[str, Any]:
    """The lane with each block's commit as the plain twin on the card."""
    real = sequential.block_commit
    sequential.block_commit = scan_commit.block_commit_plain
    try:
        return lane(pt, nt, ex)
    finally:
        sequential.block_commit = real


def card() -> Dict[str, Any]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": out}


def measure(n_nodes: int, scan_commit: Optional[Any],
            apps: int = 1) -> Dict[str, Any]:
    dev = torch.device("cuda")
    pt, nt, ex = cell_tables(n_nodes, dev, apps)
    line: Dict[str, Any] = {"nodes": n_nodes, "apps": apps,
                            "columns": int(nt.valid.shape[0])}
    lane(pt, nt, ex)  # first launches and library set-up
    line["lane"] = lane(pt, nt, ex)
    if scan_commit is not None:
        line["lane_twin"] = lane_with_twin(pt, nt, ex, scan_commit)
        line["commit"] = commit(pt, nt, ex, scan_commit)
    return line


def main(argv: List[str]) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_block_commit needs a CUDA card")
    try:
        from minisched_tpu_torch.ops import scan_commit
    except ImportError:  # a tree from before the kernel
        scan_commit = None
    apps = 1
    if argv[:1] == ["--apps"]:
        apps, argv = int(argv[1]), argv[2:]
    widths = [int(a) for a in argv] or [5_000, 10_000]
    for n_nodes in widths:
        print(json.dumps({"card": card(),
                          **measure(n_nodes, scan_commit, apps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
