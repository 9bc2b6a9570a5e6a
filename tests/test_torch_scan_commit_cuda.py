"""The blocked lane's commit kernel (``csrc/scan_commit.cu``) on the card,
against its plain twin on the CPU.

Every test here needs a CUDA card and skips without one (the kernel has
no CPU mode).  The file imports no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_scan_commit_cuda.py -q

Comparisons are exact, on every state tensor: the commit moves integers
and bools.  The cases (``kernel_cases.commit_case``) race for a few hot
nodes, hold zero-demand pods, repeated and contested host ports, nodes
whose port slots overflow, volume families at their limit, read-only
against writable mounts, hostname-like, zone-like and keyless combo keys
with every term kind, and padding rows.
"""

from __future__ import annotations

import pytest
import torch

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
from minisched_tpu_torch.kernel_cases import commit_case
from minisched_tpu_torch.models import tables
from minisched_tpu_torch.models.constraints import build_constraint_tables
from minisched_tpu_torch.ops import kernels, scan_commit, sequential
from minisched_tpu_torch.plugins.registry import build_plugins
from minisched_tpu_torch.service.config import default_full_roster_config

pytestmark = pytest.mark.cuda

#: (acceptance rule, combo planes tracked, volume planes tracked)
TRACKS = [("full", True, True), ("bare", True, True), ("bare", False, False),
          ("ports-restr", False, True), ("bare", True, False)]
CASES = [(B, *track) for B in (1, 2, 8, 32) for track in TRACKS] + [
    (300, "full", True, True)]


@pytest.fixture
def dev() -> torch.device:
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def assert_states_equal(got, want) -> None:
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name].cpu(), want[name]), name


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("B,rule,combos,volumes", CASES)
def test_kernel_matches_twin_eager_and_replayed(seed, B, rule, combos,
                                                volumes, dev):
    """One call eagerly, then the call captured in a CUDA graph and
    replayed twice on a fresh state (the second replay commits against
    the first's state): every state tensor equal to the twin's after one
    and after two commits."""
    for N in (37, 300):
        card = commit_case(seed * 1000 + B, B, N, dev, rule, combos, volumes)
        cpu = commit_case(seed * 1000 + B, B, N, "cpu", rule, combos, volumes)
        want = cpu.state()
        scan_commit.block_commit_plain(*cpu.args(want))
        got = card.state()
        before = kernels.launch_counts["block_commit"]
        scan_commit.block_commit_cuda(*card.args(got))
        torch.cuda.synchronize()
        assert kernels.launch_counts["block_commit"] == before + 1
        assert_states_equal(got, want)

        replayed = card.state()
        graph = torch.cuda.CUDAGraph()
        captured = kernels.captured_counts["block_commit"]
        with torch.cuda.graph(graph):
            scan_commit.block_commit_cuda(*card.args(replayed))
        assert kernels.captured_counts["block_commit"] == captured + 1
        graph.replay()
        torch.cuda.synchronize()
        assert_states_equal(replayed, want)
        graph.replay()
        torch.cuda.synchronize()
        scan_commit.block_commit_plain(*cpu.args(want))
        assert_states_equal(replayed, want)


def test_kernel_commits_something_and_rejects_something(dev):
    """The cases are not vacuous: across seeds the full rule both accepts
    and rejects live pods, and the bare rule accepts every live pod."""
    accepted = rejected = 0
    for seed in range(4):
        case = commit_case(seed, 32, 300, dev, "full")
        state = case.state()
        scan_commit.block_commit(*case.args(state))
        live = case.pods.valid & (case.choice >= 0)
        won = state["accepted"][case.rows]
        accepted += int((won & live).sum())
        rejected += int((~won & live).sum())
        bare = commit_case(seed, 32, 300, dev, "bare")
        state = bare.state()
        scan_commit.block_commit(*bare.args(state))
        live = bare.pods.valid & (bare.choice >= 0)
        assert torch.equal(state["accepted"][bare.rows], live)
    assert accepted and rejected


def test_kernel_refuses_what_it_does_not_take(dev):
    case = commit_case(3, 8, 40, dev)
    with pytest.raises(ValueError, match="not contiguous"):
        state = case.state()
        state["combo_dsum"] = state["combo_dsum"].t().contiguous().t()
        scan_commit.block_commit_cuda(*case.args(state))
    with pytest.raises(TypeError, match="dtype"):
        state = case.state()
        state["req_cpu"] = state["req_cpu"].long()
        scan_commit.block_commit_cuda(*case.args(state))
    cpu = commit_case(3, 8, 40, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        scan_commit.block_commit_cuda(*cpu.args(cpu.state()))


def _spread_cluster(n_nodes: int, n_pods: int):
    """Zone- and hostname-labelled nodes and pods with the two
    DoNotSchedule spreads of one selector: one pod a block."""
    host, zone = "kubernetes.io/hostname", "topology.kubernetes.io/zone"
    nodes = [make_node(f"node-{i:04d}",
                       labels={host: f"node-{i:04d}",
                               zone: f"moon-{i % 3 + 1}"},
                       capacity={"cpu": "4", "memory": "32Gi", "pods": 110})
             for i in range(n_nodes)]
    sel = LabelSelector(match_labels={"foo": "bar"})
    pods = []
    for i in range(n_pods):
        p = make_pod(f"spread-{i:04d}", labels={"foo": "bar"},
                     requests={"cpu": "100m", "memory": "500Mi"})
        p.spec.topology_spread_constraints = [
            TopologySpreadConstraint(max_skew=5, topology_key=key,
                                     when_unsatisfiable="DoNotSchedule",
                                     label_selector=sel)
            for key in (host, zone)]
        pods.append(p)
    return nodes, pods


def test_blocked_lane_records_one_commit_a_replayed_block(dev):
    """The blocked lane on the card at the benchmark cell's pod shape: one
    ``block_commit`` call recorded in each block's graph, launched once a
    replay and once for the warm-up, no plain twin; the lane's outputs
    and final table equal the CPU's."""
    nodes, pods = _spread_cluster(300, 40)
    order = order_into_blocks(pods, interaction_sets(pods), 32)
    flat = [m for blk in order for m in blk]
    pad = [i for i, m in enumerate(flat) if m is None]
    flat = [m if m is not None else make_pod("scan-pad") for m in flat]
    cfg = default_full_roster_config()
    chains = build_plugins(cfg)
    blocked = sequential.BlockedSequentialScheduler(
        chains.filter, chains.pre_score, chains.score,
        weights=cfg.score_weights(), block_size=32)

    def run(device, log=None):
        nt, _ = tables.build_node_table(nodes, device=device)
        pt, _ = tables.build_pod_table(flat, device=device, invalid_rows=pad)
        ex = build_constraint_tables(flat, nodes, [], pod_capacity=pt.capacity,
                                     node_capacity=nt.capacity,
                                     scan_planes=True, device=device)
        return blocked(pt, nt, ex, log=log)

    log = sequential.StepLog()
    kernels.reset_launch_counts()
    card = run(dev, log)
    torch.cuda.synchronize()
    steps = sum(loop.steps for loop in log.loops)
    assert steps == len(pods)
    assert all(loop.block_commit_per_step == 1 for loop in log.loops)
    assert kernels.launch_counts["block_commit"] == steps + len(log.loops)
    assert kernels.plain_calls["block_commit"] == 0
    cpu = run(torch.device("cpu"))
    for got, want in zip(card[1:], cpu[1:]):
        assert torch.equal(got.cpu(), want)
    for name, col in tables.table_columns(cpu[0]).items():
        assert torch.equal(getattr(card[0], name).cpu(), col), name
    assert bool(card[3].any())
