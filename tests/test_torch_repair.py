"""The port's repair waves against the JAX package's, bit for bit.

``RepairingEvaluator`` with the node-local roster (the full default roster
without the plugins that read constraint tables) and with the full
default roster (with each wave's constraint tables) must give the JAX
evaluator's choices, round count, every final NodeTable column and the
unschedulable-plugin masks, with diagnostics and the static split on and
off, on contended clusters that carry every feature of the roster.
``accept_placements`` is held to the JAX function on its edge cases, the
safety guards of ``tests/test_repair.py`` are run against the port, and a
reduced config 5 (512 nodes, 4,096 pods, waves of 1,024) goes through
``fullchain.schedule_repair_waves`` and the JAX waves alike, with either
roster; so does a three-wave cluster with cross-pod and volume
constraints, whose later waves see the earlier placements as assigned
pods.  On the JAX side, the reduced config 5 places exactly the same
under both rosters.  Every comparison is exact (integers and bools).

Each JAX chain is compiled for one table shape and reused across tests.
"""

from __future__ import annotations

import copy
import dataclasses
import random

import numpy as np
import pytest
import torch

from minisched_tpu.api import objects as jobj
from minisched_tpu.models import tables as jtables
from minisched_tpu.models.constraints import build_constraint_tables
from minisched_tpu.ops import repair as jrepair
from minisched_tpu.plugins.registry import build_plugins as jbuild_plugins
from minisched_tpu.service import config as jconfig

from minisched_tpu_torch import fullchain
from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.models import tables as ttables
from minisched_tpu_torch.ops import fused as tfused
from minisched_tpu_torch.ops import repair as trepair
from minisched_tpu_torch.plugins.nodenumber import NodeNumber
from minisched_tpu_torch.plugins.nodeports import NodePorts
from minisched_tpu_torch.plugins.noderesources import (
    NodeResourcesFit,
    NodeResourcesLeastAllocated,
)
from minisched_tpu_torch.plugins.nodeunschedulable import NodeUnschedulable
from minisched_tpu_torch.plugins.registry import build_plugins
from minisched_tpu_torch.service import config as tconfig

from tests.test_torch_constraints import constraint_cluster
from tests.test_torch_crosspod import both_waves, by_node
from tests.test_torch_plugins import feature_cluster, port_tables
from tests.test_torch_tables import assert_tables_equal

C5_NODES, C5_PODS, C5_WAVE = 512, 4096, 1024


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs test files on parallel workers: this file's torch
    work keeps to two threads so it does not crowd the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_node_local_config():
    return jconfig.apply_plugin_customization(
        jconfig.default_full_roster_config(), jconfig.SchedulerConfig(
            filter=jconfig.PluginSet(disabled=list(tconfig.CONSTRAINT_FILTERS)),
            pre_score=jconfig.PluginSet(disabled=list(tconfig.CONSTRAINT_SCORERS)),
            score=jconfig.PluginSet(disabled=list(tconfig.CONSTRAINT_SCORERS))))


_JAX_EVALUATORS = {}


def jax_evaluator(cfg_name: str = "node_local", with_diagnostics: bool = True,
                  split_static: bool = True):
    """One JAX RepairingEvaluator per chain, reused across tests so each
    compiles once per table shape."""
    key = (cfg_name, with_diagnostics, split_static)
    if key not in _JAX_EVALUATORS:
        cfg = (_jax_node_local_config() if cfg_name == "node_local"
               else jconfig.default_full_roster_config())
        chains = jbuild_plugins(cfg)
        _JAX_EVALUATORS[key] = jrepair.RepairingEvaluator(
            chains.filter, chains.pre_score, chains.score,
            weights=cfg.score_weights(), with_diagnostics=with_diagnostics,
            split_static=split_static)
    return _JAX_EVALUATORS[key]


def port_evaluator(with_diagnostics: bool = True, split_static: bool = True,
                   cfg_name: str = "node_local"):
    cfg = (tconfig.node_local_roster_config() if cfg_name == "node_local"
           else tconfig.default_full_roster_config())
    chains = build_plugins(cfg)
    return trepair.RepairingEvaluator(
        chains.filter, chains.pre_score, chains.score,
        weights=cfg.score_weights(), with_diagnostics=with_diagnostics,
        split_static=split_static)


# ---------------------------------------------------------------------------
# evaluator parity on contended feature clusters
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def contended():
    """Two seeded feature clusters (60 nodes, 150 pods: P = 256, N = 128)
    as JAX tables."""
    out = {}
    for seed in (5, 23):
        nodes, assigned, pods = feature_cluster(jobj, seed)
        jn, _ = jtables.build_node_table(nodes, assigned)
        jp, _ = jtables.build_pod_table(pods)
        out[seed] = (jn, jp)
    return out


@pytest.mark.parametrize("seed", [5, 23])
@pytest.mark.parametrize("with_diagnostics", [True, False])
@pytest.mark.parametrize("split_static", [True, False])
def test_repairing_evaluator_matches_jax(seed, with_diagnostics, split_static,
                                         contended):
    jn, jp = contended[seed]
    tn, tp = port_tables(jn, jp)
    want = jax_evaluator("node_local", with_diagnostics, split_static)(jp, jn)
    got = port_evaluator(with_diagnostics, split_static)(tp, tn)
    assert len(want) == (4 if with_diagnostics else 3)
    assert (got.unschedulable is None) != with_diagnostics
    assert got.extra is None
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == int(want[2])
    assert_tables_equal(got[0], want[0])
    if with_diagnostics:
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert got[3].any()  # some pod stayed unplaced, with reasons
    choice = got[1].numpy()[: int(np.asarray(jp.valid).sum())]
    assert (choice >= 0).any() and (choice < 0).any()
    if seed == 5:
        assert got[2] > 1, "the cluster should need more than one round"


@pytest.fixture(scope="module")
def constrained():
    """Two seeded constraint clusters (40 nodes, 60 pods of 2 CPU on
    8-CPU nodes, so some waves take several rounds) as (JAX, port)
    tables with their constraint tables."""
    return {seed: both_waves(*constraint_cluster(jobj, seed,
                                                 requests={"cpu": "2"}))
            for seed in (1, 7)}


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("with_diagnostics", [True, False])
@pytest.mark.parametrize("split_static", [True, False])
def test_full_roster_repairing_evaluator_matches_jax(
        seed, with_diagnostics, split_static, constrained):
    (jn, jp, je), (tn, tp, te) = constrained[seed]
    want = jax_evaluator("full", with_diagnostics, split_static)(jp, jn, je)
    got = port_evaluator(with_diagnostics, split_static, "full")(tp, tn, te)
    assert len(want) == (4 if with_diagnostics else 3)
    assert (got.unschedulable is None) != with_diagnostics
    assert got.extra is not None
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == int(want[2]) and got[2] > 1
    assert_tables_equal(got[0], want[0])
    if with_diagnostics:
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        # the constraint plugins are among the first-failing filters
        names = [pl.name() for pl in port_evaluator(cfg_name="full").filter_plugins]
        failing = {n for n, m in zip(names, got[3]) if m.any()}
        assert failing & {"InterPodAffinity", "PodTopologySpread",
                          "VolumeBinding", "VolumeRestrictions"}
    choice = got[1].numpy()[:60]
    assert (choice >= 0).any() and (choice < 0).any()


def test_split_static_rounds_are_bit_identical_with_constraints():
    """``tests/test_repair.py``'s split test on the port: affinity and
    ScheduleAnyway spread constraint tables, resource contention over
    several rounds; the split and unsplit full-roster evaluations agree
    exactly, and both equal the JAX evaluator."""
    rng = random.Random(17)
    nodes = sorted((jobj.make_node(
        f"n{i:03d}", labels={"zone": f"z{rng.randrange(3)}"},
        capacity={"cpu": "2", "memory": "4Gi", "pods": 110},
        unschedulable=rng.random() < 0.2) for i in range(24)),
        key=lambda n: n.metadata.name)
    assigned = []
    for i in range(10):
        p = jobj.make_pod(f"a{i}", labels={"app": f"app{rng.randrange(3)}"},
                          requests={"cpu": "250m"})
        p.metadata.uid = f"a{i}"
        p.spec.node_name = rng.choice(nodes).metadata.name
        assigned.append(p)
    pods = []
    for i in range(40):
        app = f"app{rng.randrange(3)}"
        pod = jobj.make_pod(f"p{i:03d}", labels={"app": app},
                            requests={"cpu": "500m", "memory": "256Mi"})
        selector = jobj.LabelSelector(match_labels={"app": app})
        if rng.random() < 0.5:
            pod.spec.affinity = jobj.Affinity(pod_affinity=jobj.PodAffinity(
                required=[jobj.PodAffinityTerm(label_selector=selector,
                                               topology_key="zone")]))
        pod.spec.topology_spread_constraints = [jobj.TopologySpreadConstraint(
            max_skew=2, topology_key="zone", when_unsatisfiable="ScheduleAnyway",
            label_selector=selector)]
        pods.append(pod)
    (jn, jp, je), (tn, tp, te) = both_waves(nodes, assigned, pods)
    outs = {split: port_evaluator(True, split, "full")(tp, tn, te)
            for split in (False, True)}
    (n0, c0, r0, u0, _), (n1, c1, r1, u1, _) = outs[False], outs[True]
    assert torch.equal(c0, c1) and r0 == r1 and torch.equal(u0, u1)
    for name, col in ttables.table_columns(n0).items():
        assert torch.equal(col, getattr(n1, name)), name
    assert (c0 >= 0).any() and r0 > 1
    want = jax_evaluator("full", True, True)(jp, jn, je)
    np.testing.assert_array_equal(c1.numpy(), np.asarray(want[1]))
    assert r1 == int(want[2])


# ---------------------------------------------------------------------------
# accept_placements
# ---------------------------------------------------------------------------


def _accept_both(nodes, assigned, pods, choice, active, **kw):
    """(port, JAX) accept masks on the same tables and choices."""
    jn, _ = jtables.build_node_table(nodes, assigned)
    jp, _ = jtables.build_pod_table(pods, capacity=len(pods))
    tn, tp = port_tables(jn, jp)
    choice = np.asarray(choice, np.int32)
    active = np.asarray(active, bool)
    want = np.asarray(jrepair.accept_placements(jn, jp, choice, active, **kw))
    got = trepair.accept_placements(tn, tp, torch.from_numpy(choice),
                                    torch.from_numpy(active), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


def test_accept_pod_repeating_its_own_port():
    nodes = [jobj.make_node("n0"), jobj.make_node("n1")]
    again = jobj.make_pod("p0")
    again.spec.containers = [jobj.Container(ports=[8080]),
                             jobj.Container(ports=[8080, 9090])]
    rival = jobj.make_pod("p1")
    rival.spec.containers = [jobj.Container(ports=[9090])]
    other = jobj.make_pod("p2")
    other.spec.containers = [jobj.Container(ports=[8080])]
    got = _accept_both(nodes, {}, [again, rival, other], [0, 0, 1],
                       [True, True, True])
    assert got.tolist() == [True, False, True]


def test_accept_zero_demand_pod_on_overcommitted_node():
    node = jobj.make_node("n0", capacity={"cpu": "1", "memory": "1Gi",
                                          "pods": 100})
    hog = jobj.make_pod("hog", requests={"cpu": "2"})
    free = jobj.make_pod("free")  # asks for nothing
    small = jobj.make_pod("small", requests={"cpu": "100m"})
    got = _accept_both([node], {"n0": [hog]}, [free, small, free], [0, 0, 0],
                       [True, True, True])
    assert got.tolist() == [True, False, True]


@pytest.mark.parametrize("seed", range(4))
def test_accept_dead_rows_mixed_with_live_rows(seed):
    """Unplaced (-1) and inactive rows between live ones, several pods per
    node, ports and resources both checked, and each check alone."""
    rng = random.Random(seed)
    nodes = [jobj.make_node(f"n{i}", capacity={"cpu": "2", "memory": "2Gi",
                                               "pods": 5}) for i in range(6)]
    pods = []
    for i in range(90):
        pod = jobj.make_pod(f"p{i}", requests={
            "cpu": f"{rng.randrange(0, 900)}m",
            "memory": f"{rng.randrange(0, 700)}Mi"})
        if rng.random() < 0.3:
            pod.spec.containers[0].ports = [rng.choice([80, 443])]
        pods.append(pod)
    choice = [rng.randrange(-1, 6) for _ in pods]
    active = [rng.random() < 0.8 for _ in pods]
    for kw in ({}, {"check_ports": False}, {"check_resources": False},
               {"check_ports": False, "check_resources": False}):
        got = _accept_both(nodes, {}, pods, choice, active, **kw)
        live = np.asarray(active) & (np.asarray(choice) >= 0)
        assert not (got & ~live).any()
        if not kw:  # contention: some live rows commit, some wait
            assert 0 < got.sum() < live.sum()


def test_segment_starts_of_sorted_keys_with_dead_rows_last():
    keys = torch.tensor([0, 0, 2, 2, 2, 5, 9, 9] + [trepair._INF32] * 3,
                        dtype=torch.int32)
    pos = torch.arange(keys.numel())
    is_start = torch.ones_like(keys, dtype=torch.bool)
    is_start[1:] = keys[1:] != keys[:-1]
    want = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    assert torch.equal(trepair._segment_starts(keys), want)


# ---------------------------------------------------------------------------
# the safety guards of tests/test_repair.py, on the port
# ---------------------------------------------------------------------------


def _run(pods, nodes, filters, pre_scores, scores, weights=None):
    node_table, node_names = ttables.build_node_table(
        sorted(nodes, key=lambda n: n.metadata.name), device="cpu")
    pod_table, _ = ttables.build_pod_table(pods, device="cpu")
    ev = trepair.RepairingEvaluator(filters, pre_scores, scores, weights)
    new_nodes, choice, rounds = ev(pod_table, node_table)[:3]
    placements = [node_names[c] if c >= 0 else ""
                  for c in choice.tolist()[: len(pods)]]
    return new_nodes, placements, rounds


def test_no_double_booking_on_contested_node():
    nodes = [tobj.make_node(f"n{i}", capacity={"cpu": "1", "memory": "4Gi",
                                               "pods": 10}) for i in range(2)]
    pods = [tobj.make_pod(f"p{i}", requests={"cpu": "1"}) for i in range(3)]
    new_nodes, placements, rounds = _run(
        pods, nodes, [NodeUnschedulable(), NodeResourcesFit()], [],
        [NodeResourcesLeastAllocated()])
    assert sorted(p for p in placements if p) == ["n0", "n1"]
    assert placements.count("") == 1
    assert (new_nodes.req_cpu <= new_nodes.alloc_cpu).all()
    assert rounds >= 2


def test_port_conflicts_within_one_round():
    nodes = [tobj.make_node("n0"), tobj.make_node("n1")]
    pods = []
    for i in range(3):
        p = tobj.make_pod(f"p{i}")
        p.spec.containers = [tobj.Container(ports=[8080])]
        pods.append(p)
    _, placements, _ = _run(pods, nodes, [NodeUnschedulable(), NodePorts()],
                            [], [])
    assert sorted(p for p in placements if p) == ["n0", "n1"]
    assert placements.count("") == 1


def test_pod_repeating_its_own_port_is_one_claim():
    pod = tobj.make_pod("p0")
    pod.spec.containers = [tobj.Container(ports=[8080]),
                           tobj.Container(ports=[8080])]
    _, placements, _ = _run([pod], [tobj.make_node("n0")],
                            [NodeUnschedulable(), NodePorts()], [], [])
    assert placements == ["n0"]


def test_bind_independent_chain_converges_in_one_round():
    """Without resource or port filters acceptance is unconditional: one
    round, the plain wave's placements."""
    rng = random.Random(9)
    nodes = [tobj.make_node(f"node{i}") for i in range(16)]
    pods = [tobj.make_pod(f"pod{rng.randrange(100)}{i % 10}") for i in range(24)]
    nn = NodeNumber()
    _, placements, rounds = _run(pods, nodes, [NodeUnschedulable()], [nn], [nn])
    assert rounds == 1
    node_table, names = ttables.build_node_table(
        sorted(nodes, key=lambda n: n.metadata.name), device="cpu")
    pod_table, _ = ttables.build_pod_table(pods, device="cpu")
    result = tfused.evaluate(pod_table, node_table, [NodeUnschedulable()],
                             [nn], [nn], tfused.BatchContext())
    assert placements == [names[c] if c >= 0 else ""
                          for c in result.choice.tolist()[: len(pods)]]


def test_zero_demand_pod_accepted_on_overcommitted_node():
    node = tobj.make_node("n0", capacity={"cpu": "1", "memory": "1Gi",
                                          "pods": 100})
    hog = tobj.make_pod("hog", requests={"cpu": "2"})
    node_table, _ = ttables.build_node_table([node], {"n0": [hog]},
                                             device="cpu")
    pod_table, _ = ttables.build_pod_table([tobj.make_pod("free")],
                                           device="cpu")
    ev = trepair.RepairingEvaluator([NodeUnschedulable(), NodeResourcesFit()],
                                    [], [NodeResourcesLeastAllocated()])
    assert int(ev(pod_table, node_table).choice[0]) == 0


def test_randomized_safety_invariants():
    """The final table never exceeds an allocatable, and every unplaced
    pod fits no node of the final table."""
    rng = random.Random(77)
    nodes = [tobj.make_node(f"node{i:02d}", capacity={
        "cpu": rng.choice(["1", "2", "4"]),
        "memory": rng.choice(["2Gi", "4Gi"]),
        "pods": rng.choice([2, 5, 110])}) for i in range(12)]
    pods = [tobj.make_pod(f"pod{i}", requests={
        "cpu": rng.choice(["500m", "1", "2"]), "memory": "1Gi"})
        for i in range(64)]
    new_nodes, placements, _ = _run(
        pods, nodes, [NodeUnschedulable(), NodeResourcesFit()], [],
        [NodeResourcesLeastAllocated()])
    t = {k: v.numpy() for k, v in ttables.table_columns(new_nodes).items()}
    for res in ("cpu", "mem", "pods"):
        assert (t[f"req_{res}"] <= t[f"alloc_{res}"]).all()
    assert any(placements) and "" in placements
    for pod, where in zip(pods, placements):
        if where:
            continue
        req = pod.resource_requests()
        fits = ((req.milli_cpu <= t["alloc_cpu"] - t["req_cpu"])
                & (req.memory // (1024 * 1024) <= t["alloc_mem"] - t["req_mem"])
                & (t["req_pods"] + 1 <= t["alloc_pods"]) & t["valid"])
        assert not fits.any(), pod.metadata.name


def test_split_static_rounds_are_bit_identical():
    """The static split gives exactly the unsplit evaluation's results on
    a contended port-built cluster with every node-local feature."""
    nodes, assigned, pods = feature_cluster(tobj, 41, n_nodes=24, n_pods=60,
                                            cpu_request="500m")
    node_table, _ = ttables.build_node_table(nodes, assigned, device="cpu")
    pod_table, _ = ttables.build_pod_table(pods, device="cpu")
    outs = {split: port_evaluator(True, split)(pod_table, node_table)
            for split in (False, True)}
    (n0, c0, r0, u0, _), (n1, c1, r1, u1, _) = outs[False], outs[True]
    assert torch.equal(c0, c1) and r0 == r1 and torch.equal(u0, u1)
    for name, col in ttables.table_columns(n0).items():
        assert torch.equal(col, getattr(n1, name)), name
    assert (c0 >= 0).any() and r0 > 1


def test_static_classification_guard_fires_on_misclassified_plugin():
    class SneakyFit(NodeResourcesFit):
        reads_committed_state = False  # wrong on purpose

        def name(self):
            return "SneakyFit"

    with pytest.raises(TypeError, match="SneakyFit"):
        trepair.RepairingEvaluator([NodeUnschedulable(), SneakyFit()], [], [])
    # no guard without the split: nothing is cached across rounds
    trepair.RepairingEvaluator([NodeUnschedulable(), SneakyFit()], [], [],
                               split_static=False)


# ---------------------------------------------------------------------------
# reduced config 5, across waves
# ---------------------------------------------------------------------------


def jax_c5_cluster(n_nodes: int, n_pods: int):
    """``fullchain.mk_c5_cluster`` built with the JAX package's objects."""
    rng = random.Random(55)
    nodes = [jobj.make_node(f"node{i:05d}", unschedulable=rng.random() < 0.2,
                            capacity={"cpu": "8", "memory": "16Gi", "pods": 110},
                            labels={"zone": f"z{i % 16}"})
             for i in range(n_nodes)]
    n_special = max(n_pods // 50, 1)
    req = fullchain.C5_REQUESTS
    pods = [jobj.make_pod(f"pod{i:06d}", requests=req)
            for i in range(n_pods - n_special)]
    pods += [jobj.make_pod(f"special{i:05d}", requests=req,
                           node_selector={"special": "true"})
             for i in range(n_special)]
    return nodes, pods


def jax_repair_waves(cfg_name: str, nodes, pods, wave: int, assigned=(),
                     pvcs=(), pvs=()):
    """The JAX waves: (choices, rounds per wave, final node table).  The
    node table holds the ``assigned`` pods; the full roster gets each
    wave's constraint tables, with the pods placed so far joining the
    assigned pods."""
    ev = jax_evaluator(cfg_name)
    jn, names = jtables.build_node_table(nodes, by_node(assigned))
    choices, rounds, assigned = [], [], list(assigned)
    for s in range(0, len(pods), wave):
        batch = pods[s:s + wave]
        jp, _ = jtables.build_pod_table(batch, capacity=wave)
        if cfg_name == "full":
            extra = build_constraint_tables(
                batch, nodes, assigned, pod_capacity=wave,
                node_capacity=jn.capacity, pvcs=pvcs, pvs=pvs,
                scan_planes=False)
            jn, choice, r, _ = ev(jp, jn, extra)
        else:
            jn, choice, r, _ = ev(jp, jn)
        choice = np.asarray(choice)[: len(batch)]
        for pod, c in zip(batch, choice):
            if c >= 0:
                placed = copy.copy(pod)
                placed.spec = dataclasses.replace(pod.spec, node_name=names[c])
                assigned.append(placed)
        choices.append(choice)
        rounds.append(int(r))
    return np.concatenate(choices).astype(np.int64), rounds, jn


@pytest.fixture(scope="module")
def c5_jax():
    nodes, pods = jax_c5_cluster(C5_NODES, C5_PODS)
    return nodes, pods, jax_repair_waves("node_local", nodes, pods, C5_WAVE)


@pytest.fixture(scope="module")
def c5_jax_full(c5_jax):
    nodes, pods, _ = c5_jax
    return jax_repair_waves("full", nodes, pods, C5_WAVE)


def test_reduced_config5_matches_jax_across_waves(c5_jax):
    jnodes, jpods, (want, want_rounds, want_table) = c5_jax
    nodes, pods = fullchain.mk_c5_cluster(C5_NODES, C5_PODS)
    # the port's copy of the cluster encodes the JAX package's tables
    assert_tables_equal(ttables.build_node_table(nodes, device="cpu")[0],
                        jtables.build_node_table(jnodes)[0])
    assert_tables_equal(
        ttables.build_pod_table(pods[-C5_WAVE:], capacity=C5_WAVE,
                                device="cpu")[0],
        jtables.build_pod_table(jpods[-C5_WAVE:], capacity=C5_WAVE)[0])
    run = fullchain.schedule_repair_waves(
        nodes, pods, wave=C5_WAVE, device="cpu",
        cfg=tconfig.node_local_roster_config())
    np.testing.assert_array_equal(run.choices, want)
    assert run.rounds == want_rounds and max(run.rounds) > 1
    assert_tables_equal(run.node_table, want_table)
    n_special = C5_PODS // 50
    assert (run.choices[:-n_special] >= 0).all()
    assert (run.choices[-n_special:] == -1).all()
    # the special pods fail NodeAffinity (and NodeUnschedulable on the
    # cordoned nodes) and nothing else
    failing = {name for name, m in run.unschedulable.items()
               if m[-n_special:].any()}
    assert failing == {"NodeUnschedulable", "NodeAffinity"}
    assert not any(m[:-n_special].any() for m in run.unschedulable.values())


def test_node_local_roster_places_config5_as_the_full_roster(c5_jax,
                                                             c5_jax_full):
    """JAX side: the full roster with constraint tables places the reduced
    config 5 exactly as the node-local roster does."""
    nodes, pods, (want, want_rounds, want_table) = c5_jax
    got, rounds, table = c5_jax_full
    np.testing.assert_array_equal(got, want)
    assert rounds == want_rounds
    for f in dataclasses.fields(table):
        np.testing.assert_array_equal(np.asarray(getattr(table, f.name)),
                                      np.asarray(getattr(want_table, f.name)),
                                      err_msg=f.name)


def test_full_roster_config5_matches_jax_across_waves(c5_jax_full):
    """``schedule_repair_waves`` with the full roster (its default), each
    wave's constraint tables built from the placements so far."""
    want, want_rounds, want_table = c5_jax_full
    nodes, pods = fullchain.mk_c5_cluster(C5_NODES, C5_PODS)
    run = fullchain.schedule_repair_waves(nodes, pods, wave=C5_WAVE,
                                          device="cpu")
    np.testing.assert_array_equal(run.choices, want)
    assert run.rounds == want_rounds
    assert_tables_equal(run.node_table, want_table)
    assert len(run.volumes) == len(run.rounds) and run.constraint_build_s > 0
    assert len(run.unschedulable) == 15


def test_later_waves_see_earlier_placements_as_assigned():
    """Three repair waves of a cluster with cross-pod and volume
    constraints (and assigned pods of its own): each wave's constraint
    tables count the pods the earlier waves placed, in both packages."""
    jnodes, jassigned, jpods, jpvcs, jpvs = constraint_cluster(
        jobj, 3, n_nodes=48, n_assigned=40, n_pods=360,
        requests={"cpu": "1"})
    jnodes = sorted(jnodes, key=lambda n: n.metadata.name)
    want, want_rounds, want_table = jax_repair_waves(
        "full", jnodes, jpods, 128, jassigned, jpvcs, jpvs)
    nodes, assigned, pods, pvcs, pvs = constraint_cluster(
        tobj, 3, n_nodes=48, n_assigned=40, n_pods=360, requests={"cpu": "1"})
    nodes = sorted(nodes, key=lambda n: n.metadata.name)
    run = fullchain.schedule_repair_waves(nodes, pods, wave=128, device="cpu",
                                          assigned=assigned, pvcs=pvcs,
                                          pvs=pvs)
    np.testing.assert_array_equal(run.choices, want)
    assert run.rounds == want_rounds
    assert_tables_equal(run.node_table, want_table)
    # the earlier waves' placements matter: scheduled without them as
    # assigned pods, the later waves place differently
    alone = [jax_repair_waves("full", jnodes, jpods[s:s + 128], 128,
                              jassigned, jpvcs, jpvs)[0] for s in (128, 256)]
    assert not all(np.array_equal(a, want[s:s + 128])
                   for a, s in zip(alone, (128, 256)))


def test_static_probe_perturbs_every_committed_plane():
    """The guard's probe changes each NodeTable plane that commits update,
    and each carried plane of the constraint tables, and nothing else (a
    static plugin must answer the same)."""
    from minisched_tpu_torch.models.constraints import _COLUMNS
    from minisched_tpu_torch.ops import staticcheck

    _, nodes, extra = staticcheck._probe_tables()
    changed, extra_p = staticcheck._perturb(nodes, extra)
    for name, col in ttables.table_columns(nodes).items():
        same = torch.equal(col, getattr(changed, name))
        assert same == (name not in staticcheck._NODE_COMMITTED), name
    for name in _COLUMNS:
        same = torch.equal(getattr(extra, name), getattr(extra_p, name))
        assert same == (name not in staticcheck._EXTRA_COMMITTED), name
    assert extra.pod_n_vols[0] == 1 and extra.claim_family[0] == 1  # EBS


def test_full_roster_static_classification_matches_jax():
    """The static guard classifies every full-roster plugin as JAX does:
    the same plugins are round-invariant, and the guard accepts them."""
    chains = build_plugins(tconfig.default_full_roster_config())
    jchains = jbuild_plugins(jconfig.default_full_roster_config())
    for point in ("filter", "score"):
        got = [(p.name(), bool(getattr(p, "reads_committed_state", False)))
               for p in getattr(chains, point)]
        want = [(p.name(), bool(getattr(p, "reads_committed_state", False)))
                for p in getattr(jchains, point)]
        assert got == want, point
    dynamic = {n for n, d in got if d}
    assert dynamic == {"NodeResourcesFit", "NodeResourcesBalancedAllocation"}
    from minisched_tpu_torch.ops.staticcheck import verify_static_classification

    verify_static_classification(
        [p for p in chains.filter if not getattr(p, "reads_committed_state", False)],
        [p for p in chains.score if not getattr(p, "reads_committed_state", False)],
        tfused.BatchContext())
