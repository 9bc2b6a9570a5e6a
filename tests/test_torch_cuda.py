"""The port's hand-written kernels on the card, against their twins.

Every test here needs a CUDA card and skips without one (the kernels
have no CPU mode).  The file imports no JAX, so it also runs on a
machine that has PyTorch and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX.)  Comparisons are
exact: the outputs are integers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from minisched_tpu_torch import fullchain
from minisched_tpu_torch.api.objects import (
    Affinity,
    LabelSelector,
    PodAffinityTerm,
    PodAntiAffinity,
    Toleration,
    TopologySpreadConstraint,
    make_node,
    make_pod,
)
from minisched_tpu_torch.engine.oracle import headline_oracle
from minisched_tpu_torch.engine.scan_groups import (
    interaction_sets,
    order_into_blocks,
)
from minisched_tpu_torch.controlplane.codec import _encode
from minisched_tpu_torch.controlplane.evaluate import evaluate_cluster
from minisched_tpu_torch.fullchain import (
    c3_roster_config,
    mk_c3_cluster,
    mk_c5_cluster,
    mk_c5_gang_cluster,
    mk_mixed_cluster,
    schedule_crosspod,
    schedule_repair_waves,
    schedule_scan,
)
from minisched_tpu_torch.headline import (
    BoundPod,
    mk_cluster,
    pods_by_node,
    repair_evaluator,
    schedule_waves,
)
from minisched_tpu_torch.models.constraint_index import ConstraintIndex
from minisched_tpu_torch.models.constraints import build_constraint_tables
from minisched_tpu_torch.plugins.registry import build_plugins
from minisched_tpu_torch.service.config import (
    default_full_roster_config,
    default_scheduler_config,
    gang_roster_config,
    node_local_roster_config,
)
from minisched_tpu_torch import live
from minisched_tpu_torch.scenario.runner import ScenarioHarness, readme_scenario
from minisched_tpu_torch.kernel_cases import (
    SELECT_NS,
    garble,
    offset_view,
    repair_planes,
    select_case,
    select_tensors,
    toleration_cluster,
)
from minisched_tpu_torch.models import tables
from minisched_tpu_torch.ops import fused, kernels, sequential

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev() -> torch.device:
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _planes(seed: int, P: int, N: int, dev, tie_heavy: bool):
    rng = np.random.default_rng(seed)
    scores = (rng.choice(np.array([0, 10], np.int32), size=(P, N)) if tie_heavy
              else rng.integers(-50, 500, size=(P, N), dtype=np.int32))
    mask = rng.random((P, N)) < 0.7
    mask[0] = False
    seeds = rng.integers(0, 1 << 32, size=P, dtype=np.uint64).astype(np.uint32)
    seeds[-1] = 0xFFFFFFFF
    return (torch.from_numpy(scores).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(seeds.view(np.int32)).to(dev))


def _cluster(seed: int, n_nodes: int, n_pods: int):
    rng = np.random.default_rng(seed)
    nodes = [make_node(f"node{i}", unschedulable=rng.random() < 0.4)
             for i in range(n_nodes)]
    tol = Toleration(key="node.kubernetes.io/unschedulable", operator="Exists")
    pods = [make_pod(f"pod{i}", tolerations=[tol] if rng.random() < 0.3 else [])
            for i in range(n_pods)]
    return nodes, pods


SHAPES = [(1, 1), (1, 300), (7, 33), (17, 300), (128, 256), (1000, 4097)]


@pytest.mark.parametrize("P,N", SHAPES)
@pytest.mark.parametrize("tie_heavy", [False, True])
def test_select_hosts_kernel_matches_twin(P, N, tie_heavy, dev):
    scores, mask, seeds = _planes(P * 7919 + N, P, N, dev, tie_heavy)
    before = kernels.launch_counts["select_hosts"]
    got = fused.select_hosts(scores, mask, seeds)  # the CUDA route
    assert kernels.launch_counts["select_hosts"] == before + 1
    want = kernels.select_hosts_plain(scores, mask, seeds)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("P,N", SHAPES)
def test_nodenumber_kernel_matches_twin(P, N, dev):
    nodes, pods = _cluster(P + N, N, P)
    nt, _ = tables.build_node_table(nodes, capacity=N, device=dev)
    pt, _ = tables.build_pod_table(pods, capacity=P, device=dev)
    before = kernels.launch_counts["nodenumber_select_hosts"]
    got = kernels.nodenumber_select_hosts(pt, nt)  # the CUDA route
    assert kernels.launch_counts["nodenumber_select_hosts"] == before + 1
    want = kernels.nodenumber_select_hosts_plain(pt, nt)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _assert_select_matches_twin(scores, mask, seeds):
    before = kernels.launch_counts["select_hosts"]
    got = kernels.select_hosts(scores, mask, seeds)  # the CUDA route
    assert kernels.launch_counts["select_hosts"] == before + 1
    want = kernels.select_hosts_plain(scores, mask, seeds)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("N", SELECT_NS)
@pytest.mark.parametrize("tie_heavy", [False, True])
def test_select_hosts_kernel_edge_rows(N, tie_heavy, dev):
    """P odd, so most row starts are not 16-byte aligned; the edge rows
    (every node a candidate, max in the last column, ties across chunk
    boundaries, INT32_MIN, seeds near 2**32) on both sides of the 16-node
    group and the 512-node step."""
    _assert_select_matches_twin(
        *select_tensors(*select_case(N, 9, N, tie_heavy), dev))


@pytest.mark.parametrize("N", [16, 512, 10112])
def test_select_hosts_kernel_unaligned_planes(N, dev):
    """Planes starting one element into their allocation: no row takes
    the 16-byte path, the edge loop does all of it."""
    scores, mask, seeds = select_tensors(*select_case(N + 1, 9, N), dev)
    _assert_select_matches_twin(offset_view(scores), offset_view(mask), seeds)
    _assert_select_matches_twin(scores, offset_view(mask), seeds)


# (nodes, pods): one tile and several (the kernel stages 7,680 nodes at a
# time), P = 1, and P not a multiple of the rows a block takes
NN_SHAPES = [(300, 1), (200, 100), (7681, 77), (20000, 301), (10112, 8191)]


@pytest.mark.parametrize("n_nodes,n_pods", NN_SHAPES)
def test_nodenumber_kernel_toleration_forms(n_nodes, n_pods, dev):
    nodes, pods = toleration_cluster(n_nodes + n_pods, n_nodes, n_pods)
    nt, _ = tables.build_node_table(nodes, capacity=n_nodes, device=dev)
    pt, _ = tables.build_pod_table(pods, capacity=n_pods, device=dev)
    pt = garble(pt, n_pods)
    before = kernels.launch_counts["nodenumber_select_hosts"]
    got = kernels.nodenumber_select_hosts(pt, nt)
    assert kernels.launch_counts["nodenumber_select_hosts"] == before + 1
    want = kernels.nodenumber_select_hosts_plain(pt, nt)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("match_score", [0, -5, 7])
def test_nodenumber_kernel_other_match_scores(match_score, dev):
    """A zero or negative match score changes which nodes win (the
    kernel's second pass); the twin is the reference."""
    nodes, pods = toleration_cluster(3, 900, 130)
    nt, _ = tables.build_node_table(nodes, device=dev)
    pt, _ = tables.build_pod_table(pods, device=dev)
    pt = garble(pt, 3)
    got = kernels.nodenumber_select_hosts_cuda(pt, nt, match_score)
    want = kernels.nodenumber_select_hosts_plain(pt, nt, match_score)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    scores, mask, seeds = _planes(1, 8, 64, dev, False)
    with pytest.raises(TypeError):
        kernels.select_hosts_cuda(scores.long(), mask, seeds)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.select_hosts_cuda(scores.t().contiguous().t(), mask, seeds)
    with pytest.raises(ValueError, match="shape"):
        kernels.select_hosts_cuda(scores, mask, seeds[:4])
    with pytest.raises(ValueError):
        kernels.select_hosts_cuda(scores, mask.cpu(), seeds)
    nodes, pods = _cluster(2, 64, 8)
    nt, _ = tables.build_node_table(nodes, device=dev)
    pt, _ = tables.build_pod_table(pods, device=dev)
    narrow = pt.tol_value[:, :4].contiguous()
    with pytest.raises(ValueError, match="tol_value"):
        kernels.nodenumber_select_hosts_cuda(
            dataclasses.replace(pt, tol_value=narrow), nt)


@pytest.mark.parametrize("route", ["fused", "generic"])
def test_schedule_waves_on_card_matches_oracle(route, dev):
    nodes, pods = mk_cluster(1000, 5000)
    run = schedule_waves(nodes, pods, wave=1024, route=route)
    assert run.node_table.valid.device.type == "cuda"
    assert np.array_equal(run.choices, headline_oracle(pods, nodes))
    cpu = schedule_waves(nodes, pods, wave=1024, route=route, device="cpu")
    for name, col in tables.table_columns(run.node_table).items():
        assert torch.equal(col.cpu(), getattr(cpu.node_table, name)), name


@pytest.mark.parametrize("roster", ["node-local", "full"])
def test_reduced_config5_on_card_matches_cpu(roster, dev):
    """Repair waves with either roster: the card (every round ends in the
    select_hosts kernel) against the plain twins on the CPU."""
    cfg = (node_local_roster_config() if roster == "node-local"
           else default_full_roster_config())
    nodes, pods = mk_c5_cluster(512, 4096)
    before = kernels.launch_counts["select_hosts"]
    run = schedule_repair_waves(nodes, pods, wave=1024, cfg=cfg)
    assert kernels.launch_counts["select_hosts"] - before >= sum(run.rounds)
    assert run.node_table.valid.device.type == "cuda"
    cpu = schedule_repair_waves(nodes, pods, wave=1024, device="cpu", cfg=cfg)
    assert np.array_equal(run.choices, cpu.choices)
    assert run.rounds == cpu.rounds and max(run.rounds) > 1
    assert run.unschedulable.keys() == cpu.unschedulable.keys()
    for name, m in run.unschedulable.items():
        assert np.array_equal(m, cpu.unschedulable[name]), name
    for name, col in tables.table_columns(run.node_table).items():
        assert torch.equal(col.cpu(), getattr(cpu.node_table, name)), name


@pytest.mark.parametrize("wave", [0, 1])
def test_select_hosts_kernel_on_repair_planes(wave, dev):
    """Round 1 of wave 0 (tie-heavy: every feasible node is an identical
    empty node) and round 2 of wave 1, where the rows committed in round 1
    are fully masked and the rest contend for the emptiest nodes."""
    nodes, pods = mk_c5_cluster(512, 4096)
    nt, _ = tables.build_node_table(nodes, device=dev)
    ev = repair_evaluator(node_local_roster_config())
    pt, _ = tables.build_pod_table(pods[:1024], device=dev)
    if wave:
        nt = ev(pt, nt)[0]
        pt, _ = tables.build_pod_table(pods[1024:2048], device=dev)
    scores, mask = repair_planes(pt, nt, ev, rounds_before=wave)
    empty = ~mask.any(dim=1)
    if wave:
        assert 0.0 < empty.float().mean() < 1.0
    _assert_select_matches_twin(scores, mask, pt.seed)


# ---------------------------------------------------------------------------
# the constraint-table plugins on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed_wave():
    """Wave 0 of the phase-10 mixed cluster (4,096 pods × 2,048 nodes):
    its objects, decided into tables per device by ``mixed_tables``."""
    nodes, assigned, pods, pvcs, pvs = mk_mixed_cluster()
    return nodes, assigned, pods[:4096], pvcs, pvs


def mixed_tables(wave, device):
    nodes, assigned, pods, pvcs, pvs = wave
    nt, _ = tables.build_node_table(nodes, pods_by_node(assigned),
                                    device=device)
    pt, _ = tables.build_pod_table(pods, device=device)
    extra = build_constraint_tables(pods, nodes, assigned,
                                    pod_capacity=pt.capacity,
                                    node_capacity=nt.capacity, pvcs=pvcs,
                                    pvs=pvs, scan_planes=False, device=device)
    return nt, pt, extra


def _carried(extra):
    """The carried planes changed as commits change them."""
    gen = torch.Generator().manual_seed(3)
    vol_any = extra.vol_any.cpu() | (torch.rand(extra.vol_any.shape,
                                                generator=gen) < 0.1)
    return dataclasses.replace(
        extra, vol_any=vol_any.to(extra.vol_any.device),
        vol_rw=(vol_any & (torch.rand(vol_any.shape, generator=gen) < 0.5)
                ).to(extra.vol_any.device),
        node_vols_fam=extra.node_vols_fam + 14)


CONSTRAINT_PLUGINS = ["VolumeRestrictions", "EBSLimits", "GCEPDLimits",
                      "NodeVolumeLimits", "AzureDiskLimits", "VolumeBinding",
                      "VolumeZone", "PodTopologySpread", "InterPodAffinity"]


@pytest.mark.parametrize("name", CONSTRAINT_PLUGINS)
def test_constraint_plugin_planes_on_card_match_cpu(name, dev, mixed_wave):
    """Each plugin's filter (and, for the cross-pod plugins, score and
    normalize) on the card equals its CPU run, with the tables as built
    and with the carried volume planes changed."""
    chains = build_plugins(default_full_roster_config())
    pl = next(p for p in chains.filter if p.name() == name)
    ctx = fused.BatchContext()
    card, cpu = mixed_tables(mixed_wave, dev), mixed_tables(mixed_wave, "cpu")
    for change in (False, True):
        (cnt, cpt, cex), (nt, pt, ex) = card, cpu
        if change:
            cex, ex = _carried(cex), _carried(ex)
        got = pl.batch_filter(ctx, cpt, cnt, cex)
        want = pl.batch_filter(ctx, pt, nt, ex)
        assert torch.equal(got.cpu(), want), (name, change)
        if name in ("PodTopologySpread", "InterPodAffinity"):
            score = pl.batch_score(ctx, cpt, cnt, {}, cex)
            want_score = pl.batch_score(ctx, pt, nt, {}, ex)
            assert torch.equal(score.cpu(), want_score)
            assert torch.equal(pl.batch_normalize(ctx, score, got).cpu(),
                               pl.batch_normalize(ctx, want_score, want))


def test_spread_filter_exact_with_tf32_allowed(dev, mixed_wave):
    """PodTopologySpread's domain sums stay exact when the process allows
    TF32 for float32 products: a zone's sum above 4,096 gives the CPU
    twin's verdicts."""
    (cnt, cpt, cex), (nt, pt, ex) = (mixed_tables(mixed_wave, dev),
                                     mixed_tables(mixed_wave, "cpu"))
    assert int(ex.combo_dsum.max()) > 4096 and ex.in_use.ts_hard
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    try:
        pl = [p for p in build_plugins(default_full_roster_config()).filter
              if p.name() == "PodTopologySpread"][0]
        ctx = fused.BatchContext()
        got = pl.batch_filter(ctx, cpt, cnt, cex)
        want = pl.batch_filter(ctx, pt, nt, ex)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])
    assert torch.equal(got.cpu(), want)
    assert not want[:4096].all() and want[:4096].any()


def test_interpod_products_on_card(dev, mixed_wave):
    """InterPodAffinity's reverse anti-affinity product and symmetric
    score run on CUDA tensors (CUDA has no integer matmul) and give the
    CPU twin's integers."""
    (cnt, cpt, cex), (nt, pt, ex) = (mixed_tables(mixed_wave, dev),
                                     mixed_tables(mixed_wave, "cpu"))
    assert cex.in_use.ex and cex.in_use.rev
    assert cex.pod_matches_ex.is_cuda and cex.rev_weight.is_cuda
    pl = [p for p in build_plugins(default_full_roster_config()).filter
          if p.name() == "InterPodAffinity"][0]
    ctx = fused.BatchContext()
    score = pl.batch_score(ctx, cpt, cnt, {}, cex)
    assert score.is_cuda and score.dtype == torch.int32
    assert torch.equal(score.cpu(), pl.batch_score(ctx, pt, nt, {}, ex))
    assert (score != 0).any()


def test_mixed_cluster_waves_on_card_match_cpu(dev):
    """A smaller mixed cluster in full-roster repair waves: card against
    the CPU twins, carried volume planes included."""
    nodes, assigned, pods, pvcs, pvs = mk_mixed_cluster(512, 2048)
    kw = dict(wave=1024, assigned=assigned, pvcs=pvcs, pvs=pvs)
    run = schedule_repair_waves(nodes, pods, **kw)
    cpu = schedule_repair_waves(nodes, pods, device="cpu", **kw)
    assert np.array_equal(run.choices, cpu.choices) and run.rounds == cpu.rounds
    for name, m in run.unschedulable.items():
        assert np.array_equal(m, cpu.unschedulable[name]), name
    for got, want in zip(run.volumes, cpu.volumes):
        for name in want:
            assert np.array_equal(got[name], want[name]), name
    for name, col in tables.table_columns(run.node_table).items():
        assert torch.equal(col.cpu(), getattr(cpu.node_table, name)), name


# ---------------------------------------------------------------------------
# the scan lanes on the card (CUDA-graph replays) against the CPU twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [1, 32])
def test_select_hosts_kernel_at_scan_shapes(P, dev):
    """The scan lanes' shapes: one pod row (the exact scan) and one block
    of 32 (the blocked lane) against config 5's 10,112 node rows."""
    for tie_heavy in (False, True):
        _assert_select_matches_twin(*_planes(P + 3, P, 10112, dev, tie_heavy))


def _scan_runs(nodes, pods, **kw):
    """``schedule_scan`` on the card and on the CPU twins."""
    log = sequential.StepLog()
    before = kernels.launch_counts["select_hosts"]
    card = schedule_scan(nodes, pods, log=log, **kw)
    launched = kernels.launch_counts["select_hosts"] - before
    cpu = schedule_scan(nodes, pods, device="cpu", **kw)
    return card, cpu, log, launched


def _assert_tables_equal(got, want):
    for name, col in tables.table_columns(got).items():
        assert torch.equal(col.cpu(), getattr(want, name)), name


@pytest.mark.parametrize("cluster", ["config3", "mixed"])
def test_exact_scan_replayed_on_card_matches_cpu(cluster, dev, monkeypatch):
    """The exact scan as CUDA-graph replays, one captured step a pod, in
    several chunks: the same choices, best scores and final table as the
    eager CPU twins; each replay launches select_hosts once (the warm-up
    step too)."""
    if cluster == "config3":
        nodes, pods = mk_c3_cluster(48, 300)  # more pods than room
        kw = dict(cfg=c3_roster_config())
        monkeypatch.setattr(fullchain, "SCAN_MAX_CHUNK", 128)
    else:
        nodes, assigned, pods, pvcs, pvs = mk_mixed_cluster(256, 160)
        kw = dict(assigned=assigned, pvcs=pvcs, pvs=pvs)
        monkeypatch.setattr(fullchain, "SCAN_MAX_CHUNK", 64)
    card, cpu, log, launched = _scan_runs(nodes, pods, **kw)
    assert np.array_equal(card.choices, cpu.choices)
    assert np.array_equal(card.best, cpu.best)
    _assert_tables_equal(card.node_table, cpu.node_table)
    assert (card.choices >= 0).any() and (card.choices < 0).any()
    steps = [s.steps for s in log.loops]
    assert sum(steps) == len(pods)
    assert all(s.select_hosts_per_step == 1 and s.device_ms_per_step
               for s in log.loops)
    assert launched == sum(steps) + len(steps)  # replays + warm-up steps


def test_blocked_lane_replayed_on_card_matches_cpu(dev):
    """Reduced config 5 with spread pods: repair waves for the rest, then
    ``schedule_crosspod``, on the card and on the CPU twins: equal
    choices, calls (choice and accepted of every row), attempts,
    exact-lane leftovers and final tables."""
    nodes, pods = mk_c5_cluster(256, 3000, n_crosspod=600)
    spread = [p for p in pods if p.metadata.name.startswith("spread")]
    rest = [p for p in pods if not p.metadata.name.startswith("spread")]
    runs = {}
    for device in (dev, torch.device("cpu")):
        waves = schedule_repair_waves(nodes, rest, wave=1024, device=device)
        placed = [BoundPod(p, waves.node_names[c])
                  for p, c in zip(rest, waves.choices) if c >= 0]
        runs[device.type] = schedule_crosspod(nodes, spread, waves.node_table,
                                              placed, device=device)
    card, cpu = runs["cuda"], runs["cpu"]
    assert np.array_equal(card.choices, cpu.choices)
    assert (card.attempts, card.blocks, card.exact_pods) == (
        cpu.attempts, cpu.blocks, cpu.exact_pods)
    for (rows, won), (crows, cwon) in zip(card.calls, cpu.calls, strict=True):
        assert np.array_equal(rows, crows) and np.array_equal(won, cwon)
    _assert_tables_equal(card.node_table, cpu.node_table)
    assert (card.choices >= 0).all()
    assert all(s.select_hosts_per_step == 1 for s in card.log.loops)


def one_slot_cluster():
    """64 nodes in 4 zones with room for one 500m pod each, and 64 pods of
    12 apps with a DoNotSchedule zone spread of max skew 1, one in ten
    also with a required anti-affinity to its own app on the hostname
    key: capacity races in all 3 attempts, one pod left to the exact
    scan."""
    host = "kubernetes.io/hostname"
    nodes = [make_node(f"node{i:03d}",
                       labels={"zone": f"z{i % 4}", host: f"node{i:03d}"},
                       capacity={"cpu": "500m", "memory": "8Gi", "pods": 110})
             for i in range(64)]
    pods = []
    for i in range(64):
        app = LabelSelector(match_labels={"app": f"app{i % 12}"})
        p = make_pod(f"spread{i:05d}", labels={"app": f"app{i % 12}"},
                     requests={"cpu": "500m"})
        p.spec.topology_spread_constraints = [TopologySpreadConstraint(
            max_skew=1, topology_key="zone",
            when_unsatisfiable="DoNotSchedule", label_selector=app)]
        if i % 10 == 0:
            p.spec.affinity = Affinity(pod_anti_affinity=PodAntiAffinity(
                required=[PodAffinityTerm(label_selector=app,
                                          topology_key=host)]))
        pods.append(p)
    return nodes, pods


def test_blocked_lane_leftovers_on_card_match_cpu(dev):
    """``schedule_crosspod`` through every branch (3 attempts of races,
    then the exact scan for the leftover) on the card and on the CPU
    twins: equal choices, calls, attempts, leftovers and final tables."""
    nodes, pods = one_slot_cluster()
    runs = {}
    for device in (dev, torch.device("cpu")):
        node_table, _ = tables.build_node_table(nodes, device=device)
        runs[device.type] = schedule_crosspod(nodes, pods, node_table,
                                              device=device)
    card, cpu = runs["cuda"], runs["cpu"]
    assert (card.attempts, card.exact_pods) == (3, 1)
    assert np.array_equal(card.choices, cpu.choices)
    assert (card.attempts, card.blocks, card.exact_pods) == (
        cpu.attempts, cpu.blocks, cpu.exact_pods)
    for (rows, won), (crows, cwon) in zip(card.calls, cpu.calls, strict=True):
        assert np.array_equal(rows, crows) and np.array_equal(won, cwon)
    _assert_tables_equal(card.node_table, cpu.node_table)


def test_blocked_commit_exact_with_tf32_allowed(dev):
    """The blocked scan on the mixed cluster (a zone's domain sum above
    4,096; every term kind) with TF32 allowed for float32 products and
    precision "medium": the card gives the CPU twins' choices, accepted
    masks and final table."""
    nodes, assigned, pods, pvcs, pvs = mk_mixed_cluster(256, 256)
    order = order_into_blocks(pods, interaction_sets(pods), 8)
    flat = [m for blk in order for m in blk]
    pad = [i for i, m in enumerate(flat) if m is None]
    flat = [m if m is not None else make_pod("scan-pad") for m in flat]
    cfg = default_full_roster_config()
    chains = build_plugins(cfg)
    blocked = sequential.BlockedSequentialScheduler(
        chains.filter, chains.pre_score, chains.score,
        weights=cfg.score_weights(), block_size=8)

    def run(device):
        nt, _ = tables.build_node_table(nodes, pods_by_node(assigned),
                                        device=device)
        pt, _ = tables.build_pod_table(flat, device=device, invalid_rows=pad)
        ex = build_constraint_tables(flat, nodes, assigned,
                                     pod_capacity=pt.capacity,
                                     node_capacity=nt.capacity, pvcs=pvcs,
                                     pvs=pvs, device=device)
        return ex, blocked(pt, nt, ex)

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    try:
        ex, card = run(dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])
    _, cpu = run("cpu")
    assert int(ex.combo_dsum.max()) > 4096
    for got, want in zip(card[1:], cpu[1:]):
        assert torch.equal(got.cpu(), want)
    _assert_tables_equal(card[0], cpu[0])
    assert (card[3]).any() and (card[1] < 0).any()


# -- gangs, Evaluate, the constraint index (on the card) ----------------------


def test_gang_waves_and_scan_on_card_match_cpu(dev, monkeypatch):
    """A reduced config 5 with gangs under ``gang_roster_config``: repair
    waves (the gang columns rewritten each wave) and the exact scan of its
    first pods in chunks, the card against the CPU twins: choices,
    rounds, masks, gang views and final tables."""
    nodes, assigned, pods = mk_c5_gang_cluster(256, 2_500, n_gangs=102)
    cfg = gang_roster_config()
    before = kernels.launch_counts["select_hosts"]
    card = schedule_repair_waves(nodes, pods, wave=1024, cfg=cfg,
                                 assigned=assigned)
    assert kernels.launch_counts["select_hosts"] - before >= sum(card.rounds)
    cpu = schedule_repair_waves(nodes, pods, wave=1024, device="cpu",
                                cfg=cfg, assigned=assigned)
    assert np.array_equal(card.choices, cpu.choices)
    assert card.rounds == cpu.rounds and card.gang_views == cpu.gang_views
    assert any(card.gang_views)
    for name, m in card.unschedulable.items():
        assert np.array_equal(m, cpu.unschedulable[name]), name
    _assert_tables_equal(card.node_table, cpu.node_table)
    monkeypatch.setattr(fullchain, "SCAN_MAX_CHUNK", 128)
    card_s, cpu_s, log, launched = _scan_runs(nodes, pods[:300], cfg=cfg,
                                              assigned=assigned)
    assert np.array_equal(card_s.choices, cpu_s.choices)
    assert np.array_equal(card_s.best, cpu_s.best)
    assert card_s.gang_views == cpu_s.gang_views and card_s.chunks == 3
    _assert_tables_equal(card_s.node_table, cpu_s.node_table)
    assert launched == 300 + len(log.loops)


@pytest.mark.parametrize("mode", ["wave", "repair"])
def test_evaluate_cluster_on_card_matches_cpu(mode, dev):
    """``evaluate_cluster`` on the mixed cluster's objects (every feature
    of the full roster), the card against ``device="cpu"``."""
    nodes, assigned, pods, pvcs, pvs = mk_mixed_cluster(256, 512)
    request = {"nodes": [_encode(o) for o in nodes],
               "pods": [_encode(o) for o in pods],
               "assigned": [_encode(o) for o in assigned],
               "pvcs": [_encode(o) for o in pvcs],
               "pvs": [_encode(o) for o in pvs], "mode": mode}
    before = kernels.launch_counts["select_hosts"]
    card = evaluate_cluster(request)
    assert kernels.launch_counts["select_hosts"] - before >= card["rounds"]
    cpu = evaluate_cluster(request, device="cpu")
    assert card == cpu
    assert any(v is not None for v in card["placements"].values())


def test_index_tables_on_card_equal_the_walk(dev):
    """The constraint tables assembled from a ``ConstraintIndex`` on the
    card's tensors equal the tables walked from every assigned pod
    (ex-term planes as row sets), with pods folded in as extras."""
    nodes, assigned, pods, pvcs, pvs = mk_mixed_cluster(256, 512)
    index = ConstraintIndex(
        node_get={n.metadata.name: n for n in nodes}.get,
        pvc_get={c.metadata.key: c for c in pvcs}.get,
        pv_get={v.metadata.name: v for v in pvs}.get)
    index.add_pods(assigned[:-40])
    kw = dict(pod_capacity=512, node_capacity=256, pvcs=pvcs, pvs=pvs,
              scan_planes=True, device=dev)
    got = build_constraint_tables(pods, nodes, (), index=index,
                                  extra_assigned=assigned[-40:], **kw)
    want = build_constraint_tables(pods, nodes, assigned, **kw)
    assert got.in_use == want.in_use
    for name in got.__dataclass_fields__:
        if name in ("in_use", "ex_domain", "pod_matches_ex"):
            continue
        g, w = getattr(got, name), getattr(want, name)
        assert g.device.type == "cuda" and torch.equal(g, w), name

    def ex_rows(t):
        ex, pm = t.ex_domain.cpu().numpy(), t.pod_matches_ex.cpu().numpy()
        return sorted((ex[i].tobytes(), pm[:, i].tobytes())
                      for i in range(ex.shape[0])
                      if ex[i].any() or pm[:, i].any())

    assert ex_rows(got) == ex_rows(want) and ex_rows(got)


def test_readme_scenario_live_on_card(dev):
    """The live engine on the card (its default device): ``pod1`` parks
    behind nine cordoned nodes, then binds to ``node10``."""
    kernels.reset_launch_counts()
    with ScenarioHarness(default_scheduler_config(time_scale=0.01)) as h:
        assert readme_scenario(h, log=lambda _: None) == "node10"
        assert h.service.scheduler.loop_errors == 0
        assert h.service.scheduler.device.type == "cuda"
    assert kernels.launch_counts["select_hosts"] >= 2
    assert not any(kernels.plain_calls.values())


def test_live_reduced_config5_on_card(dev):
    """Config 5 cut to 2,000 nodes and 20,000 pods through the serial live
    engine: park, label, requeue, every pod bound; the store audit, no
    loop error, the assume cache drained, every first-drain bind equal to
    the one-shot repair waves on the same waves."""
    kernels.reset_launch_counts()
    run = live.run_config5_live(2_000, 20_000, max_wave=4_096, pipeline=False)
    assert kernels.launch_counts["select_hosts"] >= run.waves
    assert not any(kernels.plain_calls.values())
    assert live.audit_store(run.client, run.labelled)["bound"] == 20_000
    assert run.loop_errors == 0 and run.assumed_left == 0
    ref = schedule_repair_waves(run.nodes, run.pods, wave=4_096)
    want = [ref.node_names[c] if c >= 0 else "" for c in ref.choices]
    assert [run.first_drain[p.metadata.name] for p in run.pods] == want


def test_cached_node_table_builder_on_card_equals_full_pack(dev):
    """``CachedNodeTableBuilder`` on the card: host builds made on another
    thread (as the pipeline's worker makes them) and placed on this one,
    after a full build, dirty-row builds, a build with an assume delta
    (host ports included) and a reused one, each equal column for column
    to a full pack of the same state (the assumed pods packed as pods)."""
    import threading

    from minisched_tpu_torch.framework.nodeinfo import build_node_infos

    nodes = [make_node(f"n{i:03d}", labels={"zone": f"z{i % 4}"})
             for i in range(300)]
    infos = build_node_infos(nodes, [])
    by_name = {ni.name: ni for ni in infos}
    builder = tables.CachedNodeTableBuilder(dev)
    assigned = {n.metadata.name: [] for n in nodes}

    def pod(name, node, cpu="500m", ports=()):
        p = make_pod(name, requests={"cpu": cpu, "memory": "256Mi"})
        p.metadata.uid = name
        p.spec.node_name = node
        if ports:
            p.spec.containers[0].ports = list(ports)
        return p

    def check(delta=None, assumed=(), **kw):
        out = {}
        worker = threading.Thread(target=lambda: out.update(
            host=builder.build_host(infos, agg_delta=delta, **kw)))
        worker.start()
        worker.join()
        got = builder.place(out["host"][0])
        by_node = {k: list(v) for k, v in assigned.items()}
        for a in assumed:
            by_node[a.spec.node_name].append(a)
        want, _ = tables.build_node_table(nodes, by_node, device=dev)
        torch.cuda.synchronize()
        for name, col in tables.table_columns(want).items():
            assert torch.equal(getattr(got, name), col), name
        return builder.last_build_skipped

    assert not check(dirty=None, epoch=1)
    for i in range(40):
        node = f"n{(7 * i) % 300:03d}"
        p = pod(f"b{i}", node, ports=(8000 + i,) if i % 9 == 0 else ())
        by_name[node].add_pod(p)
        assigned[node].append(p)
    dirty = {f"n{(7 * i) % 300:03d}" for i in range(40)}
    assert not check(dirty=dirty, epoch=2)
    extra = [pod(f"a{i}", f"n{(11 * i) % 300:03d}", cpu="1",
                 ports=(9000 + i,) if i % 5 == 0 else ()) for i in range(30)]
    delta = {}
    for a in extra:
        d = delta.setdefault(a.spec.node_name, [0, 0, 0, 0, 0, 0, []])
        d[0] += 1000
        d[1] += 256
        d[3] += 1
        d[4] += 1000
        d[5] += 256
        d[6].extend(a.spec.containers[0].ports)
    assert not check(delta=delta, assumed=extra, dirty=set(), epoch=3)
    assert check(delta=delta, assumed=extra, dirty=set(), epoch=3)


def test_pipelined_live_run_on_card(dev):
    """Config 5 cut to 500 nodes and 5,000 pods with 200 spread pods
    through the pipelined live engine on the card: every pod bound, the
    audits pass, no loop error, no CUDA error at the end, the scan lanes
    and the waves launched ``select_hosts`` and no plain twin ran."""
    kernels.reset_launch_counts()
    run = live.run_config5_live(500, 5_000, max_wave=1_024, n_crosspod=200)
    torch.cuda.synchronize()
    assert run.pipelined and run.loop_errors == 0 and run.assumed_left == 0
    assert live.audit_store(run.client, run.labelled)["bound"] == 5_000
    assert live.audit_spread(run.client) == 32
    lanes = run.scan_stats
    assert lanes["blocked"].placed + lanes["exact"].placed == 200
    assert lanes["blocked"].select_hosts > 0
    assert kernels.launch_counts["select_hosts"] > run.waves
    assert not any(kernels.plain_calls.values())


@pytest.mark.parametrize("lane", ["exact", "blocked"])
def test_lane_call_split_on_card(lane, dev, monkeypatch):
    """A live engine on the card flushes spread pods through ``lane``
    (``test_torch_scan_spans.lane_run``): the lane spans nest in
    ``scan_evaluate`` as on the CPU, the capture is a span, every replay
    is timed by the loop's CUDA events (the engine counts no operations),
    and the card's time for the replays fits in their span."""
    from test_torch_scan_spans import assert_lane_split, lane_run

    spans, stats, phases = lane_run(lane, "cuda", monkeypatch)
    assert_lane_split(spans, stats, phases)
    assert phases["scan_capture"]["count"] >= stats[lane].calls
    assert all(s.replays == s.steps for s in stats.values())
    device_s = sum(s.device_s for s in stats.values())
    assert 0 < device_s <= phases["scan_replay"]["total_s"]


def _ha_plane(n_nodes: int, n_pods: int):
    """An in-process façade holding a small cluster, for engine children."""
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.controlplane.httpserver import start_api_server
    from minisched_tpu_torch.controlplane.store import ObjectStore

    store = ObjectStore()
    client = Client(store)
    client.nodes().create_many([
        make_node(f"node{i:03d}",
                  capacity={"cpu": "8", "memory": "16Gi", "pods": 110})
        for i in range(n_nodes)])
    if n_pods:
        client.pods().create_many([
            make_pod(f"hp{i:04d}", requests={"cpu": "500m", "memory": "64Mi"})
            for i in range(n_pods)])
    _server, base, shutdown = start_api_server(store)
    return store, base, shutdown


def test_engine_child_on_card_reports_launches(dev):
    """An ``EngineSupervisor`` child on ``cuda`` binds every pod and
    reports its ``select_hosts`` launches (and no plain-twin call) on its
    ``/metrics``; this process's counts never see them."""
    import time

    from minisched_tpu_torch.ha.proc import EngineSupervisor

    store, base, shutdown = _ha_plane(16, 64)
    eng = EngineSupervisor(base, "engine-0", device="cuda", metrics_port=0)
    kernels.reset_launch_counts()
    try:
        eng.start()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not all(
                p.spec.node_name for p in store.list("Pod")):
            time.sleep(0.1)
        assert all(p.spec.node_name for p in store.list("Pod"))
        counts = eng.kernel_counts()
        assert counts["launches"]["select_hosts"] >= 1
        assert not any(counts["plain_calls"].values())
        assert eng.scrape()["engine_pods_bound"] == 64
    finally:
        eng.stop()
        shutdown()
    assert not eng.alive()
    assert kernels.launch_counts["select_hosts"] == 0


def test_engine_child_with_a_missing_device_raises(dev):
    """A child asked for a CUDA device this machine lacks exits non-zero
    before it joins, and ``start()`` raises with the child's stderr."""
    from minisched_tpu_torch.ha.proc import NO_DEVICE_EXIT, EngineSupervisor

    _store, base, shutdown = _ha_plane(2, 0)
    missing = f"cuda:{torch.cuda.device_count()}"
    eng = EngineSupervisor(base, "engine-x", device=missing)
    try:
        with pytest.raises(RuntimeError,
                           match=rf"exitcode {NO_DEVICE_EXIT}\).*no CUDA "
                                 rf"device '{missing}'"):
            eng.start()
    finally:
        eng.stop()
        shutdown()


@pytest.mark.parametrize("N", SELECT_NS)
@pytest.mark.parametrize("base", [1, 1 << 20, "largest"])
def test_select_hosts_kernel_at_a_node_base(N, base, dev):
    """A mesh node shard's call: the kernel hashes ``base + idx`` and
    returns ``base + idx``, as the twin does, on the edge rows."""
    scores, mask, seeds = select_tensors(*select_case(N + 3, 9, N), dev)
    base = (1 << 31) - 1 - N if base == "largest" else base
    got = kernels.select_hosts_cuda(scores, mask, seeds, base)
    want = kernels.select_hosts_plain(scores, mask, seeds, base)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shards", [2, 4])
def test_node_shards_merge_to_the_whole_row_on_card(shards, dev):
    scores, mask, seeds = _planes(5, 257, 10112, dev, tie_heavy=True)
    width = 10112 // shards
    parts = [kernels.select_hosts_cuda(
        scores[:, j * width:(j + 1) * width].contiguous(),
        mask[:, j * width:(j + 1) * width].contiguous(), seeds, j * width)
        for j in range(shards)]
    got = kernels.select_hosts_merge(parts, seeds)
    want = kernels.select_hosts_cuda(scores, mask, seeds)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("path", ["repair", "scan", "blocked"])
def test_mesh_repair_and_scan_on_a_virtual_card_mesh(path, dev):
    """The full roster on the mixed cluster over a virtual 2 x 4 mesh of
    the card: the repair wave, the exact scan and the blocked lane (each
    lane's step over all tiles captured in one CUDA graph) equal the
    mesh-off paths, every tile launching the kernel and no plain twin
    called."""
    from minisched_tpu_torch.ops.repair import RepairingEvaluator
    from minisched_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(8, devices=[dev] * 8)
    nodes, assigned, pods, pvcs, pvs = mk_mixed_cluster(256, 200)
    by_node = {}
    for p in assigned:
        by_node.setdefault(p.spec.node_name, []).append(p)
    nt, _ = tables.build_node_table(nodes, by_node, device=dev)
    pt, _ = tables.build_pod_table(pods, device=dev)
    cfg = default_full_roster_config()
    chains = build_plugins(cfg)
    chain = (chains.filter, chains.pre_score, chains.score)
    extra = build_constraint_tables(
        pods, nodes, assigned, pod_capacity=pt.capacity,
        node_capacity=nt.capacity, pvcs=pvcs, pvs=pvs,
        scan_planes=path != "repair", device=dev)
    weights = cfg.score_weights()

    def run(mesh_):
        if path == "scan":
            return sequential.SequentialScheduler(
                *chain, weights=weights, mesh=mesh_)(pt, nt, extra)
        if path == "blocked":
            return sequential.BlockedSequentialScheduler(
                *chain, weights=weights, block_size=32, mesh=mesh_)(
                    pt, nt, extra)
        out = RepairingEvaluator(*chain, weights=weights,
                                 with_diagnostics=True, mesh=mesh_)(
                                     pt, nt, extra)
        return out.node_table, out.choice, out.unschedulable

    want = run(None)
    kernels.reset_launch_counts()
    got = run(mesh)
    torch.cuda.synchronize()
    assert kernels.launch_counts["select_hosts"] >= 8
    assert not any(kernels.plain_calls.values())
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    want_cols = tables.table_columns(want[0])
    for name, col in tables.table_columns(got[0]).items():
        assert torch.equal(col, want_cols[name]), name


def test_live_engine_on_a_virtual_card_mesh(dev):
    """The mesh ladder on the card: ``mesh.evaluate`` armed once, one
    fallback, later waves sharded, every pod bound, no plain twin."""
    from minisched_tpu_torch.parallel import sharding

    kernels.reset_launch_counts()
    run = live.run_mesh_ladder(sharding.make_mesh(8, devices=[dev] * 8),
                               device=dev)
    assert run.fires == 1 and run.after_second["wave_mesh.fallbacks"] == 1
    assert run.after_second["wave_mesh.waves"] >= 1
    assert all(run.placements.values()) and run.loop_errors == 0
    assert kernels.launch_counts["select_hosts"] >= 8
    assert not any(kernels.plain_calls.values())


def test_nodenumber_wave_step_across_two_processes(dev, tmp_path):
    """Two processes on the card, each a 1 x 4 row of it (one 2 x 4 mesh
    across processes, ``parallel/distributed.py``): every rank's
    NodeNumber wave step gives the mesh-off choice, best and final node
    table, launching the kernel on its 4 tiles and no plain twin."""
    from minisched_tpu_torch.ops.fused import BatchContext, evaluate
    from minisched_tpu_torch.ops.state import apply_placements
    from minisched_tpu_torch.parallel import distributed, rank_steps
    from minisched_tpu_torch.plugins.nodenumber import NodeNumber
    from minisched_tpu_torch.plugins.nodeunschedulable import (
        NodeUnschedulable,
    )

    rng = np.random.default_rng(7)
    nodes = [make_node(f"node{i:04d}", unschedulable=bool(rng.random() < 0.3))
             for i in range(1000)]
    pods = [make_pod(f"pod{i}") for i in range(500)]
    nt, _ = tables.build_node_table(nodes, capacity=1024, device=dev)
    pt, _ = tables.build_pod_table(pods, capacity=512, device=dev)
    nn = NodeNumber()
    off = evaluate(pt, nt, (NodeUnschedulable(),), (nn,), (nn,),
                   BatchContext(weights=(("NodeNumber", 1),)))
    want = tables.table_columns(apply_placements(nt, pt, off.choice))
    path = str(tmp_path / "inputs.pt")
    rank_steps.save_inputs(path, step=(pt, nt, None, "nodenumber"))
    ranks = distributed.spawn(2, rank_steps.run_rank, (path, "cuda", 4), 120)
    for rank, r in enumerate(ranks):
        assert r["shape"] == (2, 4) and r["rows"] == [rank]
        step = r["step"]
        assert torch.equal(step["choice"], off.choice.cpu())
        assert torch.equal(step["best"], off.best_score.cpu())
        for name, col in step["node_table"].items():
            assert torch.equal(col, want[name].cpu()), name
        assert step["launches"] == 4 and step["plain"] == 0
        assert step["gather_calls"] == 2
