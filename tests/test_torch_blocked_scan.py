"""The port's blocked scan lane against the JAX package's.

The cases of ``tests/test_blocked_scan.py``: ``interaction_sets`` and
``order_into_blocks`` (equal to JAX's on random pods, one member of a
group per block in FIFO order, the matching direction), the blocked scan
against the exact scan on disjoint groups, the capacity race flagged for
a retry, fully padded trailing blocks; then the port's
``blocked_scan_schedule`` against JAX's on the full roster (``choice``,
``best``, ``accepted``, every final node-table column), and
``fullchain.schedule_crosspod`` against the same lane driven through the
JAX package (its engine's ``_schedule_scan_blocked`` loop, written out
here: group, order into blocks of 32, chunks, 3 attempts, the exact scan
for what is left).  Tolerance 0: the outputs are integers and bools.
The live-engine case waits for the port's live engine.
"""

from __future__ import annotations

import copy
import random
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from minisched_tpu.api import objects as jobj
from minisched_tpu.engine import scan_groups as jgroups
from minisched_tpu.models import constraints as jconstraints
from minisched_tpu.models import tables as jtables
from minisched_tpu.ops import sequential as jseq

from minisched_tpu_torch import fullchain
from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.engine import scan_groups as tgroups
from minisched_tpu_torch.headline import BoundPod
from minisched_tpu_torch.headline import pods_by_node as by_node
from minisched_tpu_torch.models import tables as ttables
from minisched_tpu_torch.ops import sequential as tseq

from tests.test_torch_constraints import constraint_cluster
from tests.test_torch_sequential import (
    assert_nodes_equal,
    chain_of,
    full_roster,
    jax_tables,
    roster,
    to_port,
)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs test files on parallel workers: this file's torch
    work keeps to two threads so it does not crowd the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _spread_pod(objs, name, app, skew=1, mode="DoNotSchedule", cpu="100m"):
    p = objs.make_pod(name, labels={"app": app}, requests={"cpu": cpu})
    p.spec.topology_spread_constraints = [objs.TopologySpreadConstraint(
        max_skew=skew, topology_key="zone", when_unsatisfiable=mode,
        label_selector=objs.LabelSelector(match_labels={"app": app}))]
    return p


# -- grouping -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 5, 9])
def test_grouping_matches_jax(seed):
    """Interaction sets and the block order of the constraint cluster's
    pods (every term kind, volumes) equal JAX's."""
    jpods = constraint_cluster(jobj, seed)[2]
    tpods = constraint_cluster(tobj, seed)[2]
    jsets, tsets = jgroups.interaction_sets(jpods), tgroups.interaction_sets(tpods)
    assert tsets == jsets
    assert any(len(s) > 1 for s in tsets)
    for size in (4, 32):
        def names(blocks):
            return [[m.metadata.name if m is not None else None for m in b]
                    for b in blocks]
        assert (names(tgroups.order_into_blocks(tpods, tsets, size))
                == names(jgroups.order_into_blocks(jpods, jsets, size)))


def test_same_group_pods_never_share_a_block_and_keep_fifo():
    pods = [_spread_pod(tobj, f"p{i}", f"app{i % 3}") for i in range(12)]
    blocks = tgroups.order_into_blocks(pods, tgroups.interaction_sets(pods), 4)
    for blk in blocks:
        apps = [m.metadata.labels["app"] for m in blk if m is not None]
        assert len(apps) == len(set(apps)), apps
    for app in ("app0", "app1", "app2"):
        got = [m.metadata.name for blk in blocks for m in blk
               if m is not None and m.metadata.labels["app"] == app]
        assert got == [p.metadata.name for p in pods
                       if p.metadata.labels["app"] == app]


def test_matching_direction_counts_as_interaction():
    """A pod whose labels match another pod's selector interacts with it
    though it carries no constraint of that group."""
    chaser = tobj.make_pod("chaser", labels={"app": "x"})
    chaser.spec.affinity = tobj.Affinity(pod_affinity=tobj.PodAffinity(
        preferred=[tobj.WeightedPodAffinityTerm(
            weight=5, term=tobj.PodAffinityTerm(
                label_selector=tobj.LabelSelector(match_labels={"app": "y"}),
                topology_key="zone"))]))
    target = _spread_pod(tobj, "target", "y")
    sets = tgroups.interaction_sets([chaser, target])
    assert sets[0] & sets[1]
    assert len(tgroups.order_into_blocks([chaser, target], sets, 4)) == 2


# -- the blocked scan ---------------------------------------------------------


def _zone_nodes(objs, n_nodes=24, cpu="16"):
    zones = ["za", "zb", "zc"]
    return [objs.make_node(f"n{i:03d}", labels={"zone": zones[i % 3]},
                           capacity={"cpu": cpu, "memory": "32Gi", "pods": 64})
            for i in range(n_nodes)]


def blocked_tables(nodes, pods, block_size, assigned=(), pvcs=(), pvs=()):
    """JAX tables (and the port's copies) of ``pods`` in block order, pad
    rows invalid, and the flat block layout."""
    blocks = jgroups.order_into_blocks(pods, jgroups.interaction_sets(pods),
                                       block_size)
    flat = [m for b in blocks for m in b]
    pad_rows = [i for i, m in enumerate(flat) if m is None]
    dummy = jobj.make_pod("scan-pad")
    flat_pods = [m if m is not None else dummy for m in flat]
    nodes = sorted(nodes, key=lambda n: n.metadata.name)
    jn, names = jtables.build_node_table(nodes, by_node(assigned))
    jp, _ = jtables.build_pod_table(flat_pods, invalid_rows=pad_rows)
    je = jconstraints.build_constraint_tables(
        flat_pods, nodes, assigned, pod_capacity=jp.capacity,
        node_capacity=jn.capacity, pvcs=pvcs, pvs=pvs)
    return (jn, jp, je), to_port(jn, jp, je), flat, names


def jax_call(scheduler, *tables):
    """Call a JAX scan scheduler with its jit caches cleared first: a
    second call of one blocked scheduler at one shape but other table
    contents, in one process, ran the program compiled for the first call
    and failed on its argument count (``Execution supplied 112 buffers but
    compiled program expected 119``)."""
    jax.clear_caches()
    return scheduler(*tables)


FULL = full_roster()


def both_blocked(roster_, jtabs, ttabs, block_size, log=None):
    """JAX and port blocked scans on the same tables: equal outputs."""
    _, tchains, weights = roster_
    jchains, _, _ = roster_
    jout = jax_call(jseq.BlockedSequentialScheduler(
        *chain_of(jchains), weights, block_size=block_size),
        jtabs[1], jtabs[0], jtabs[2])
    tout = tseq.BlockedSequentialScheduler(
        *chain_of(tchains), weights, block_size=block_size)(
            ttabs[1], ttabs[0], ttabs[2], log=log)
    for k, what in ((1, "choice"), (2, "best"), (3, "accepted")):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=what)
    assert_nodes_equal(tout[0], jout[0])
    return tout


SPREAD = roster(["NodeUnschedulable", "NodeResourcesFit", "PodTopologySpread"],
                ["PodTopologySpread"], ["PodTopologySpread"])


def test_blocked_matches_exact_scan_on_disjoint_groups():
    """Disjoint groups and no capacity-coupled scorer: the blocked scan
    reproduces the exact scan, and equals JAX's blocked scan."""
    nodes = _zone_nodes(jobj)
    pods = [_spread_pod(jobj, f"p{i:03d}", f"app{i % 8}") for i in range(64)]
    jn, jp, je, names = jax_tables(nodes, pods)
    tn, tp, te = to_port(jn, jp, je)
    _, want, _ = tseq.SequentialScheduler(*chain_of(SPREAD[1]))(tp, tn, te)
    want = [names[c] for c in want.tolist()[:64]]
    jtabs, ttabs, flat, names = blocked_tables(nodes, pods, 8)
    _, choice, _, accepted = both_blocked(SPREAD, jtabs, ttabs, 8)
    got = {}
    for i, m in enumerate(flat):
        if m is not None:
            assert choice[i] >= 0 and accepted[i], m.metadata.name
            got[m.metadata.name] = names[choice[i]]
    assert [got[p.metadata.name] for p in pods] == want


def test_capacity_race_is_flagged_not_lost():
    """Two independent pods race for the last slot of the only feasible
    node: the first in index order commits, the other comes back feasible
    but not accepted."""
    nodes = [jobj.make_node("only", labels={"zone": "za"},
                            capacity={"cpu": "1", "pods": 10})]
    pods = [_spread_pod(jobj, "a", "appA", cpu="1"),
            _spread_pod(jobj, "b", "appB", cpu="1")]
    jn, jp, je, _ = jax_tables(nodes, pods)
    chains = roster(["NodeUnschedulable", "NodeResourcesFit",
                     "PodTopologySpread"])
    # pod capacity 128 in blocks of 2: 63 fully padded blocks follow
    log = tseq.StepLog()
    _, choice, _, accepted = both_blocked(chains, (jn, jp, je),
                                          to_port(jn, jp, je), 2, log)
    assert choice[0] == 0 and accepted[0]
    assert choice[1] == 0 and not accepted[1]
    assert [s.steps for s in log.loops] == [1]


def test_padded_trailing_blocks_are_not_run():
    """40 pods in blocks of 8 on a 128-row table: 5 live blocks run, the
    11 padded ones give what JAX's skipped step gives."""
    nodes = _zone_nodes(jobj, 12, cpu="2")
    pods = [_spread_pod(jobj, f"p{i:03d}", f"app{i % 8}", cpu="500m")
            for i in range(40)]
    jtabs, ttabs, flat, _ = blocked_tables(nodes, pods, 8)
    assert len(flat) == 40 and jtabs[1].capacity == 128
    log = tseq.StepLog()
    _, choice, best, accepted = both_blocked(SPREAD, jtabs, ttabs, 8, log)
    assert [s.steps for s in log.loops] == [5]
    assert (choice[40:] == -1).all() and (best[40:] == 0).all()
    assert not accepted[40:].any()


@pytest.mark.parametrize("cluster", ["constraint-1", "constraint-5", "tight"])
def test_full_roster_blocked_matches_jax(cluster):
    """The full roster in blocks of 8 (pods in block order, padding rows
    between them) equals JAX's blocked scan: on the constraint cluster
    (every term kind and volume form; its pods interact so much that most
    blocks hold one pod) and on the tight spread cluster of the lane test
    (12 apps a block, capacity races)."""
    if cluster == "tight":
        nodes, assigned, pods = crosspod_cluster(jobj)
        pvcs = pvs = ()
    else:
        nodes, assigned, pods, pvcs, pvs = constraint_cluster(
            jobj, int(cluster[-1]), n_nodes=24, n_pods=120,
            requests={"cpu": "2", "memory": "1Gi"})
    jtabs, ttabs, flat, _ = blocked_tables(nodes, pods, 8, assigned, pvcs,
                                           pvs)
    _, choice, _, accepted = both_blocked(FULL, jtabs, ttabs, 8)
    choice, accepted = choice.numpy(), accepted.numpy()
    live = np.zeros(len(choice), bool)
    live[[i for i, m in enumerate(flat) if m is not None]] = True
    assert (accepted & live).any() and ((choice < 0) & live).any()
    if cluster == "tight":
        assert ((choice >= 0) & ~accepted & live).any()


# -- the lane -----------------------------------------------------------------


def _bound_copy(pod, node_name: str):
    out = copy.deepcopy(pod)
    out.spec.node_name = node_name
    return out


def jax_crosspod(nodes, pods, assigned):
    """The blocked lane through the JAX package: the loop of its engine's
    ``_schedule_scan_blocked`` over table-level calls, each call's node
    table rebuilt from the pods bound so far as the engine rebuilds it.
    Returns the choices by pod, the (choice, accepted) of each blocked
    call, the attempts, the pods left to the exact scan and the final
    node table."""
    jchains, _, weights = FULL
    blocked = jseq.BlockedSequentialScheduler(
        *chain_of(jchains), weights, block_size=fullchain.SCAN_BLOCK_SIZE)
    exact = jseq.SequentialScheduler(*chain_of(jchains), weights)
    names = [n.metadata.name for n in nodes]
    assigned = list(assigned)
    position = {id(p): k for k, p in enumerate(pods)}
    choices = np.full(len(pods), -1, np.int64)
    dummy = jobj.make_pod("scan-pad")
    calls, attempts = [], 0

    def tables(pods_, cap, invalid_rows=()):
        jn, _ = jtables.build_node_table(nodes, by_node(assigned))
        jp, _ = jtables.build_pod_table(pods_, capacity=cap,
                                        invalid_rows=invalid_rows)
        je = jconstraints.build_constraint_tables(
            pods_, nodes, assigned, pod_capacity=cap,
            node_capacity=jn.capacity, scan_planes=True)
        return jn, jp, je

    pending = list(pods)
    for _ in range(fullchain.SCAN_BLOCK_RETRIES):
        attempts += 1
        blocks = jgroups.order_into_blocks(
            pending, jgroups.interaction_sets(pending),
            fullchain.SCAN_BLOCK_SIZE)
        flat = [m for b in blocks for m in b]
        retry = []
        for start in range(0, len(flat), fullchain.BLOCKED_MAX_CHUNK):
            part = flat[start:start + fullchain.BLOCKED_MAX_CHUNK]
            jn, jp, je = tables(
                [m if m is not None else dummy for m in part],
                fullchain._blocked_cap(len(part)),
                [i for i, m in enumerate(part) if m is None])
            _, choice, _, accepted = jax_call(blocked, jp, jn, je)
            rows = np.asarray(choice)[: len(part)]
            won = np.asarray(accepted)[: len(part)]
            calls.append((rows.astype(np.int64), won))
            for m, row, ok in zip(part, rows.tolist(), won.tolist()):
                if m is None:
                    continue
                if row >= 0 and ok:
                    choices[position[id(m)]] = row
                    assigned.append(_bound_copy(m, names[row]))
                elif row >= 0:
                    retry.append(m)
        pending = retry
        if not pending:
            break
    if pending:
        jn, jp, je = tables(pending, jtables.pad_to(len(pending)))
        _, choice, _ = jax_call(exact, jp, jn, je)
        for m, row in zip(pending, np.asarray(choice)[: len(pending)].tolist()):
            choices[position[id(m)]] = row
            if row >= 0:
                assigned.append(_bound_copy(m, names[row]))
    final, _ = jtables.build_node_table(nodes, by_node(assigned))
    return choices, calls, attempts, len(pending), final


def crosspod_cluster(objs, n_nodes=16, n_spread=150, n_assigned=24,
                     node_cpu="2", seed=17):
    """A tight cluster for the lane: 16 nodes of 2 CPU in 4 zones (64
    slots of 500m, a few held by assigned pods), 150 spread pods of 12
    apps (DoNotSchedule, max skew 1), one in ten also with a required
    anti-affinity to its own app on the hostname key."""
    rng = random.Random(seed)
    nodes = [objs.make_node(
        f"node{i:03d}", labels={"zone": f"z{i % 4}",
                                "kubernetes.io/hostname": f"node{i:03d}"},
        capacity={"cpu": node_cpu, "memory": "8Gi", "pods": 110})
        for i in range(n_nodes)]
    assigned = []
    for i in range(n_assigned):
        p = objs.make_pod(f"old{i:03d}", labels={"app": f"app{i % 12}"},
                          requests={"cpu": "500m"})
        p.spec.node_name = rng.choice(nodes).metadata.name
        assigned.append(p)
    pods = []
    for i in range(n_spread):
        app = f"app{i % 12}"
        p = _spread_pod(objs, f"spread{i:05d}", app, skew=1, cpu="500m")
        if i % 10 == 0:
            p.spec.affinity = objs.Affinity(
                pod_anti_affinity=objs.PodAntiAffinity(required=[
                    objs.PodAffinityTerm(
                        label_selector=objs.LabelSelector(
                            match_labels={"app": app}),
                        topology_key="kubernetes.io/hostname")]))
        pods.append(p)
    return nodes, assigned, pods


LANE_CLUSTERS = {
    # 64 slots for 150 pods: races, retries, then no room
    "out-of-room": dict(n_nodes=16, n_spread=150),
    # one pod a node, as many pods as nodes: races in all 3 attempts, and
    # one pod left to the exact scan
    "one-slot": dict(n_nodes=64, n_spread=64, n_assigned=0, node_cpu="500m"),
}


@pytest.mark.parametrize("cluster", sorted(LANE_CLUSTERS))
def test_schedule_crosspod_matches_jax_lane(cluster):
    """``schedule_crosspod`` on the CPU equals the same lane driven through
    the JAX package: choices, every call's (choice, accepted), attempts,
    exact-lane leftovers and the final node table."""
    kw = LANE_CLUSTERS[cluster]
    jnodes, jassigned, jpods = crosspod_cluster(jobj, **kw)
    tnodes, tassigned, tpods = crosspod_cluster(tobj, **kw)
    want, calls, attempts, leftovers, jn = jax_crosspod(jnodes, jpods,
                                                        jassigned)
    node_table, _ = ttables.build_node_table(tnodes, by_node(tassigned),
                                             device="cpu")
    run = fullchain.schedule_crosspod(tnodes, tpods, node_table, tassigned,
                                      device="cpu")
    np.testing.assert_array_equal(run.choices, want)
    assert (run.attempts, run.exact_pods) == (attempts, leftovers)
    assert len(run.calls) == len(calls)
    for (rows, won), (jrows, jwon) in zip(run.calls, calls):
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_array_equal(won, jwon)
    assert_nodes_equal(run.node_table, jn)
    if cluster == "out-of-room":
        assert attempts > 1 and (want < 0).any() and (want >= 0).any()
    else:
        assert attempts == 3 and leftovers == 1 and (want >= 0).all()


def test_schedule_crosspod_keeps_the_skew():
    """Reduced config 5 with spread pods: repair waves for the plain pods,
    then the lane for the spread pods; every spread pod placed, max skew
    4 per app over the zones, no node over its allocatable."""
    nodes, pods = fullchain.mk_c5_cluster(96, 1200, n_crosspod=160)
    spread = [p for p in pods if p.metadata.name.startswith("spread")]
    rest = [p for p in pods if not p.metadata.name.startswith("spread")]
    waves = fullchain.schedule_repair_waves(nodes, rest, wave=512,
                                            device="cpu")
    placed = [BoundPod(p, waves.node_names[c])
              for p, c in zip(rest, waves.choices) if c >= 0]
    run = fullchain.schedule_crosspod(nodes, spread, waves.node_table, placed,
                                      device="cpu")
    assert (run.choices >= 0).all() and run.attempts >= 1
    zone = [n.metadata.labels["zone"] for n in nodes]
    open_zones = sorted({zone[i] for i, n in enumerate(nodes)
                         if not n.spec.unschedulable})
    for app in {p.metadata.labels["app"] for p in spread}:
        counts = Counter(zone[c] for p, c in zip(spread, run.choices)
                         if p.metadata.labels["app"] == app)
        per_zone = [counts.get(z, 0) for z in open_zones]
        assert max(per_zone) - min(per_zone) <= fullchain.C5_MAX_SKEW, app
    final = run.node_table
    assert not (final.req_cpu > final.alloc_cpu).any()
    assert int(final.req_pods.sum()) == int((waves.choices >= 0).sum()) + len(spread)
