"""The blocked lane's commit (``ops/scan_commit.py``) on the CPU.

The lane's plain twin against JAX's blocked lane at the benchmark cell's
shape (blocks of 32 holding one live pod each: one spread group of
100m / 500 Mi pods with DoNotSchedule spreads of max skew 5 over the
hostname and the zone, on zone- and hostname-labelled nodes with pods
already running): ``choice``, ``best``, ``accepted`` and the final node
table, exactly.  Then the dispatcher: the twin for CPU tensors, and a
refusal of what the kernel does not take on either route.  The kernel
itself is held to the twin on the card (``test_torch_scan_commit_cuda.py``).
"""

from __future__ import annotations

import random

import pytest
import torch

from minisched_tpu.api import objects as jobj

from minisched_tpu_torch.kernel_cases import commit_case
from minisched_tpu_torch.ops import kernels, scan_commit
from minisched_tpu_torch.ops import sequential as tseq

from tests.test_torch_blocked_scan import FULL, blocked_tables, both_blocked

HOST, ZONE = "kubernetes.io/hostname", "topology.kubernetes.io/zone"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs test files on parallel workers: this file's torch
    work keeps to two threads so it does not crowd the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def spread_cell(seed: int, n_nodes: int, n_running: int, n_pods: int):
    """The cell's shape, small: nodes of 4 CPU, 32 Gi and 110 pods in
    zones moon-1..3 (node i in i % 3), each with its hostname label;
    ``n_running`` pods of 100m / 500 Mi bound to nodes drawn from the
    seed; ``n_pods`` pending spread pods."""
    rng = random.Random(seed)
    nodes = [jobj.make_node(f"node-{i:04d}",
                            labels={HOST: f"node-{i:04d}",
                                    ZONE: f"moon-{i % 3 + 1}"},
                            capacity={"cpu": "4", "memory": "32Gi",
                                      "pods": 110})
             for i in range(n_nodes)]
    running = []
    for i in range(n_running):
        p = jobj.make_pod(f"init-{i:04d}",
                          requests={"cpu": "100m", "memory": "500Mi"})
        p.spec.node_name = rng.choice(nodes).metadata.name
        running.append(p)
    sel = jobj.LabelSelector(match_labels={"foo": "bar"})
    pods = []
    for i in range(n_pods):
        p = jobj.make_pod(f"spread-{i:04d}", labels={"foo": "bar"},
                          requests={"cpu": "100m", "memory": "500Mi"})
        p.spec.topology_spread_constraints = [
            jobj.TopologySpreadConstraint(
                max_skew=5, topology_key=key,
                when_unsatisfiable="DoNotSchedule", label_selector=sel)
            for key in (HOST, ZONE)]
        pods.append(p)
    return nodes, running, pods


@pytest.mark.parametrize("seed,n_nodes", [(3, 300), (11, 200)])
def test_twin_matches_jax_blocked_lane_at_the_cells_shape(seed, n_nodes):
    """Blocks of 32 with one live pod each, every block through the twin:
    equal to JAX's blocked scan on every output and the final table."""
    nodes, running, pods = spread_cell(seed, n_nodes, n_nodes, 24)
    jtabs, ttabs, flat, _ = blocked_tables(nodes, pods, 32, running)
    assert sum(m is not None for m in flat[:32]) == 1
    log = tseq.StepLog()
    before = kernels.plain_calls["block_commit"]
    _, choice, _, accepted = both_blocked(FULL, jtabs, ttabs, 32, log)
    steps = sum(loop.steps for loop in log.loops)
    assert steps == len(pods)
    assert kernels.plain_calls["block_commit"] - before == steps
    live = torch.tensor([m is not None for m in flat])
    assert bool((accepted[: len(flat)] == live).all())
    assert bool((choice[: len(flat)][live] >= 0).all())


@pytest.mark.parametrize("rule,combos,volumes", [
    ("full", True, True), ("bare", False, False), ("ports-restr", False, True),
])
def test_wrapper_takes_the_twin_on_the_cpu(rule, combos, volumes):
    case = commit_case(5, 32, 120, "cpu", rule, combos, volumes)
    got, want = case.state(), case.state()
    before = kernels.plain_calls["block_commit"]
    scan_commit.block_commit(*case.args(got))
    assert kernels.plain_calls["block_commit"] == before + 1
    scan_commit.block_commit_plain(*case.args(want))
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert any(not torch.equal(got[name], case.initial[name])
               for name in got)


def _bad_choice_dtype(case, state):
    return (state, *case.args(state)[1:5], case.choice.long(),
            *case.args(state)[6:])


def _bad_rows_dtype(case, state):
    args = list(case.args(state))
    args[4] = case.rows.int()
    return tuple(args)


def _empty_block(case, state):
    args = list(case.args(state))
    args[4], args[5], args[6] = (case.rows[:0], case.choice[:0],
                                 case.best[:0])
    return tuple(args)


def _too_many_families(case, state):
    args = list(case.args(state))
    args[7] = scan_commit.CommitRule(True, True, ((0, 4),) * 9, True)
    return tuple(args)


def _limits_without_volume_planes(case, state):
    args = list(case.args(state))
    args[9] = None
    return tuple(args)


def _state_without_a_plane(case, state):
    del state["combo_excl"]
    return case.args(state)


@pytest.mark.parametrize("bad,error", [
    (_bad_choice_dtype, TypeError),
    (_bad_rows_dtype, TypeError),
    (_empty_block, ValueError),
    (_too_many_families, ValueError),
    (_limits_without_volume_planes, ValueError),
    (_state_without_a_plane, ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, error):
    case = commit_case(7, 8, 40, "cpu")
    before = kernels.plain_calls["block_commit"]
    with pytest.raises(error):
        scan_commit.block_commit(*bad(case, case.state()))
    assert kernels.plain_calls["block_commit"] == before


def test_wrapper_refuses_a_block_past_one_cta():
    case = commit_case(2, scan_commit.MAX_BLOCK + 1, 8, "cpu", "bare",
                       False, False)
    with pytest.raises(ValueError, match="1 to 1024"):
        scan_commit.block_commit(*case.args(case.state()))
