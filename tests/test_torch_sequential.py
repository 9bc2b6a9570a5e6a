"""The port's exact scan lane against the JAX package's, bit for bit.

The cases of ``tests/test_sequential.py`` (fill in order, port claims,
randomized config 3, the full roster on ``_mixed_cluster``, the missing
constraint tables, intra-scan anti-affinity, the wave-equivalent chain,
intra-scan symmetric preferred scoring) go through the JAX
``SequentialScheduler`` and the port's on the same tables (JAX tables,
carried to the port with ``tables_from_numpy`` and
``constraint_tables_from_numpy``).  ``choice``, ``best`` and every column
of the final node table must be equal, padding rows included: the
outputs are integers and bools, so the tolerance is 0.  Scans with no
assigned pods check each flag the scan itself creates (``rev``,
``excl``).  ``FullRosterScanOracle`` is held against JAX's, and
``fullchain.schedule_scan`` against the oracle and the JAX scan on
reduced configs 3 and 5.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from minisched_tpu.api import objects as jobj
from minisched_tpu.engine import oracle as joracle
from minisched_tpu.models import constraints as jconstraints
from minisched_tpu.models import tables as jtables
from minisched_tpu.ops import sequential as jseq
from minisched_tpu.plugins.registry import build_plugins as jbuild_plugins
from minisched_tpu.service import config as jconfig

from minisched_tpu_torch import fullchain
from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.engine import oracle as toracle
from minisched_tpu_torch.headline import pods_by_node as by_node
from minisched_tpu_torch.models import constraints as tconstraints
from minisched_tpu_torch.models import tables as ttables
from minisched_tpu_torch.ops import fused as tfused
from minisched_tpu_torch.ops import sequential as tseq
from minisched_tpu_torch.plugins.registry import build_plugins
from minisched_tpu_torch.service import config as tconfig

from tests.test_plugins_resources import _resource_cluster
from tests.test_sequential import _mixed_cluster
from tests.test_torch_crosspod import jax_columns
from tests.test_torch_plugins import port_tables


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs test files on parallel workers: this file's torch
    work keeps to two threads so it does not crowd the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def roster(filters, pre_scores=(), scores=(), weights=None):
    """(JAX chains, port chains, weights) of one plugin roster, by name."""
    weights = weights or {}

    def cfg(mod):
        def plugin_set(names, weighted=False):
            return mod.PluginSet(enabled=[
                mod.PluginEnabled(n, weights.get(n, 1)) if weighted
                else mod.PluginEnabled(n) for n in names])

        return mod.SchedulerConfig(filter=plugin_set(filters),
                                   pre_score=plugin_set(pre_scores),
                                   score=plugin_set(scores, weighted=True))

    return jbuild_plugins(cfg(jconfig)), build_plugins(cfg(tconfig)), weights


def full_roster():
    cfg_j, cfg_t = jconfig.default_full_roster_config(), tconfig.default_full_roster_config()
    return jbuild_plugins(cfg_j), build_plugins(cfg_t), cfg_t.score_weights()


def chain_of(chains):
    return chains.filter, chains.pre_score, chains.score


def jax_tables(nodes, pods, assigned=(), pvcs=(), pvs=(), with_extra=True):
    """JAX (node, pod, constraint) tables of ``pods`` against ``nodes``
    (name order) with ``assigned`` pods bound."""
    nodes = sorted(nodes, key=lambda n: n.metadata.name)
    jn, names = jtables.build_node_table(nodes, by_node(assigned))
    jp, _ = jtables.build_pod_table(pods)
    je = (jconstraints.build_constraint_tables(
        pods, nodes, assigned, pod_capacity=jp.capacity,
        node_capacity=jn.capacity, pvcs=pvcs, pvs=pvs)
        if with_extra else None)
    return jn, jp, je, names


def to_port(jn, jp, je):
    tn, tp = port_tables(jn, jp)
    te = (None if je is None
          else tconstraints.constraint_tables_from_numpy(jax_columns(je), "cpu"))
    return tn, tp, te


def assert_nodes_equal(got, want_jax):
    want = jax_columns(want_jax)
    for name, col in ttables.table_columns(got).items():
        np.testing.assert_array_equal(col.numpy(), want[name], err_msg=name)


def both_scans(roster_, nodes, pods, assigned=(), pvcs=(), pvs=(),
               with_extra=True):
    """Run the JAX and the port's SequentialScheduler on the same tables;
    assert equal choices, best scores and final node tables.  Returns
    the placements as node names ("" unplaced) and the port's tables."""
    jchains, tchains, weights = roster_
    jn, jp, je, names = jax_tables(nodes, pods, assigned, pvcs, pvs,
                                   with_extra)
    tn, tp, te = to_port(jn, jp, je)
    jout = jseq.SequentialScheduler(*chain_of(jchains), weights)(jp, jn, je) \
        if je is not None else \
        jseq.SequentialScheduler(*chain_of(jchains), weights)(jp, jn)
    tout = tseq.SequentialScheduler(*chain_of(tchains), weights)(tp, tn, te)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]),
                                  err_msg="choice")
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]),
                                  err_msg="best")
    assert_nodes_equal(tout[0], jout[0])
    return ([names[c] if c >= 0 else "" for c in tout[1].tolist()[: len(pods)]],
            (tn, tp, te))


FIT_LEAST = roster(["NodeUnschedulable", "NodeResourcesFit"], [],
                   ["NodeResourcesLeastAllocated"])


def test_binds_fill_nodes_in_order():
    """Three 1-cpu pods on two 1-cpu nodes: the third is rejected (a
    stateless wave would place all three)."""
    nodes = [jobj.make_node(f"n{i}", capacity={"cpu": "1", "memory": "4Gi",
                                                "pods": 10})
             for i in range(2)]
    pods = [jobj.make_pod(f"p{i}", requests={"cpu": "1"}) for i in range(3)]
    got, _ = both_scans(FIT_LEAST, nodes, pods, with_extra=False)
    assert sorted(got[:2]) == ["n0", "n1"] and got[2] == ""


def test_port_claims_are_seen_by_later_pods():
    nodes = [jobj.make_node("n0"), jobj.make_node("n1")]
    pods = []
    for i in range(3):
        p = jobj.make_pod(f"p{i}")
        p.spec.containers = [jobj.Container(ports=[8080])]
        pods.append(p)
    got, _ = both_scans(roster(["NodeUnschedulable", "NodePorts"]), nodes,
                        pods, with_extra=False)
    assert sorted(got[:2]) == ["n0", "n1"] and got[2] == ""


@pytest.mark.parametrize("seed", [55, 7])
def test_config3_randomized(seed):
    """Fit + LeastAllocated + Balanced with binds applied: scores shift as
    nodes fill."""
    nodes, pods = _resource_cluster(random.Random(seed), 24, 60)
    got, _ = both_scans(
        roster(["NodeUnschedulable", "NodeResourcesFit"], [],
               ["NodeResourcesLeastAllocated",
                "NodeResourcesBalancedAllocation"],
               {"NodeResourcesBalancedAllocation": 2}),
        nodes, pods, with_extra=False)
    assert any(p == "" for p in got) and any(p != "" for p in got)


@pytest.mark.parametrize("seed", [2024, 7])
def test_full_roster_cross_pod(seed):
    """The full default roster, cross-pod and volume plugins included, on
    ``_mixed_cluster``: assigned pods of every term kind and pending pods
    of every coupling."""
    nodes, assigned, pods, pvcs, pvs = _mixed_cluster(random.Random(seed),
                                                      32, 24, 120)
    got, (_, _, te) = both_scans(full_roster(), nodes, pods, assigned, pvcs,
                                 pvs)
    assert len({p for p in got if p}) > 4
    use = te.in_use
    assert use.ts_soft and use.pa and use.pan and use.ppa
    assert use.rev and use.ex and use.vols


@pytest.mark.parametrize("seed", [1, 5])
def test_full_roster_constraint_cluster(seed):
    """The full roster on ``constraint_cluster``: hostname-like keys,
    nodes without the key, DoNotSchedule spread on both keys, shared
    read-only and writable mounts, unbound and missing claims."""
    from tests.test_torch_constraints import constraint_cluster

    nodes, assigned, pods, pvcs, pvs = constraint_cluster(jobj, seed)
    got, (_, _, te) = both_scans(full_roster(), nodes, pods, assigned, pvcs,
                                 pvs)
    assert any(got) and not all(got)
    assert te.in_use.ts_hard and te.in_use.vols


def test_cross_pod_needs_extra():
    nodes = [jobj.make_node("n0")]
    jn, jp, _, _ = jax_tables(nodes, [jobj.make_pod("p")], with_extra=False)
    tn, tp, _ = to_port(jn, jp, None)
    _, tchains, _ = roster(["InterPodAffinity"])
    with pytest.raises(ValueError, match="ConstraintTables"):
        tseq.SequentialScheduler(*chain_of(tchains))(tp, tn)


def _term(app: str, key: str = "zone"):
    return jobj.PodAffinityTerm(
        label_selector=jobj.LabelSelector(match_labels={"app": app}),
        topology_key=key)


def _zone_nodes(n_per_zone: int = 2, zones=("za", "zb")):
    return [jobj.make_node(f"{z[-1]}{i}", labels={"zone": z})
            for z in zones for i in range(1, n_per_zone + 1)]


def _hermit():
    hermit = jobj.make_pod("a-hermit", labels={"app": "web"})
    hermit.spec.affinity = jobj.Affinity(
        pod_anti_affinity=jobj.PodAntiAffinity(required=[_term("web")]))
    return hermit


def test_intra_scan_anti_affinity():
    """No assigned pods: a pod committed mid-scan with required
    anti-affinity excludes later matching pods from its whole zone (the
    carried ``combo_excl``, behind the scan-created ``excl`` flag)."""
    nodes = [jobj.make_node("a1", labels={"zone": "za"}),
             jobj.make_node("a2", labels={"zone": "za"}),
             jobj.make_node("b1", labels={"zone": "zb"})]
    follower = jobj.make_pod("b-follower", labels={"app": "web"})
    chains = roster(["NodeUnschedulable", "InterPodAffinity"])
    got, (_, _, te) = both_scans(chains, nodes, [_hermit(), follower])
    zone = {n.metadata.name: n.metadata.labels["zone"] for n in nodes}
    assert got[0] and got[1] and zone[got[0]] != zone[got[1]]
    # the flag comes from the scanned pods alone
    assert not te.in_use.ex and not te.in_use.excl
    assert tconstraints.scan_use(te.in_use).excl


@pytest.mark.parametrize("kind", ["preferred", "required"])
def test_intra_scan_symmetric_scoring(kind):
    """No assigned pods: a pod committed mid-scan with a preferred
    (weight 60) or required (hard weight) affinity term pulls a later
    matching pod, which has no affinity of its own, into its zone (the
    carried ``rev_weight``, behind the scan-created ``rev`` flag)."""
    nodes = _zone_nodes()
    magnet = jobj.make_pod("a-magnet", labels={"app": "db"})
    if kind == "preferred":
        magnet.spec.affinity = jobj.Affinity(pod_affinity=jobj.PodAffinity(
            preferred=[jobj.WeightedPodAffinityTerm(weight=60,
                                                    term=_term("web"))]))
    else:
        # the magnet's own required term is satisfiable by itself only
        # after it matches: give it the selector of its own label
        magnet.metadata.labels["app"] = "web"
        magnet.spec.affinity = jobj.Affinity(pod_affinity=jobj.PodAffinity(
            required=[_term("web")]))
    follower = jobj.make_pod("b-follower", labels={"app": "web"})
    chains = roster(["NodeUnschedulable", "InterPodAffinity"],
                    ["InterPodAffinity"], ["InterPodAffinity"])
    got, (_, _, te) = both_scans(chains, nodes, [magnet, follower])
    zone = {n.metadata.name: n.metadata.labels["zone"] for n in nodes}
    assert got[0] and got[1] and zone[got[0]] == zone[got[1]]
    assert not te.in_use.rev and tconstraints.scan_use(te.in_use).rev


def test_in_scan_term_decides_the_placement():
    """The in-scan term is live: scanning the anti-affinity case without
    it (``in_scan`` off, as the JAX filter compiles it outside the scan)
    places some follower in the hermit's zone."""
    nodes = [jobj.make_node("a1", labels={"zone": "za"}),
             jobj.make_node("a2", labels={"zone": "za"}),
             jobj.make_node("b1", labels={"zone": "zb"})]
    _, tchains, _ = roster(["NodeUnschedulable", "InterPodAffinity"])
    differs = 0
    for k in range(8):
        follower = jobj.make_pod(f"b-follower{k}", labels={"app": "web"})
        tn, tp, te = to_port(*jax_tables(nodes, [_hermit(), follower])[:3])
        _, exact, _ = tseq.scan_schedule(
            tn, tp, *chain_of(tchains), tfused.BatchContext(in_scan=True), te)
        _, blind, _ = tseq.scan_schedule(
            tn, tp, *chain_of(tchains), tfused.BatchContext(in_scan=False), te)
        differs += not torch.equal(exact, blind)
    assert differs


def test_matches_wave_for_bind_independent_chain():
    """For the NodeNumber chain (decisions independent of binds) the scan
    and the port's wave evaluator agree."""
    rng = random.Random(56)
    nodes = [jobj.make_node(f"node{i}") for i in range(20)]
    pods = [jobj.make_pod(f"pod{rng.randrange(1000)}{i % 10}")
            for i in range(30)]
    chains = roster(["NodeUnschedulable"], ["NodeNumber"], ["NodeNumber"])
    both_scans(chains, nodes, pods, with_extra=False)
    jn, jp, _, _ = jax_tables(nodes, pods, with_extra=False)
    tn, tp, _ = to_port(jn, jp, None)
    tchains = chains[1]
    _, scan, _ = tseq.SequentialScheduler(*chain_of(tchains))(tp, tn)
    wave = tfused.FusedEvaluator(*chain_of(tchains))(tp, tn).choice
    assert torch.equal(scan, wave)


def test_scan_leaves_its_inputs_unchanged():
    nodes, pods = _resource_cluster(random.Random(3), 8, 20)
    jn, jp, _, _ = jax_tables(nodes, pods, with_extra=False)
    tn, tp, _ = to_port(jn, jp, None)
    before = {k: v.clone() for k, v in ttables.table_columns(tn).items()}
    _, tchains, _ = FIT_LEAST
    out, choice, _ = tseq.SequentialScheduler(*chain_of(tchains))(tp, tn)
    assert int((choice >= 0).sum()) > 0
    for k, v in ttables.table_columns(tn).items():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(out.req_cpu, tn.req_cpu)


def test_step_log_counts_each_loop():
    nodes, pods = _resource_cluster(random.Random(4), 8, 20)
    jn, jp, _, _ = jax_tables(nodes, pods, with_extra=False)
    tn, tp, _ = to_port(jn, jp, None)
    log = tseq.StepLog()
    _, tchains, _ = FIT_LEAST
    tseq.SequentialScheduler(*chain_of(tchains))(tp, tn, log=log)
    # padding rows past the last pod are not stepped
    assert [s.steps for s in log.loops] == [len(pods)]
    assert log.loops[0].device_ms_per_step is None  # the CPU has no events


# ---------------------------------------------------------------------------
# the oracle and the entry point
# ---------------------------------------------------------------------------


def _c5_like(objs, seed: int, n_nodes: int, n_pods: int):
    """Config-5-shaped objects of one package: cordoned nodes, uniform and
    mixed requests, some pods with a node selector that a few nodes
    match."""
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        labels = {"zone": f"z{i % 4}"}
        if i % 7 == 0:
            labels["special"] = "true"
        nodes.append(objs.make_node(
            f"node{i:05d}", unschedulable=rng.random() < 0.2, labels=labels,
            capacity={"cpu": rng.choice(["4", "8"]), "memory": "16Gi",
                      "pods": rng.choice([10, 110])}))
    pods = []
    for i in range(n_pods):
        kw = {}
        if rng.random() < 0.1:
            kw["node_selector"] = {"special": "true"}
        req = ({} if rng.random() < 0.1 else
               {"cpu": rng.choice(["500m", "1", "2"]),
                "memory": rng.choice(["256Mi", "2Gi"])})
        pods.append(objs.make_pod(f"pod{i:06d}", requests=req, **kw))
    return nodes, pods


@pytest.mark.parametrize("with_balanced", [True, False])
def test_full_roster_oracle_matches_jax(with_balanced):
    jn, jp = _c5_like(jobj, 9, 40, 300)
    tn, tp = _c5_like(tobj, 9, 40, 300)
    want = joracle.FullRosterScanOracle(
        jn, jtables.DEFAULT_NONZERO_CPU, jtables.DEFAULT_NONZERO_MEM_MIB,
        with_balanced=with_balanced).place_all(jp)
    got = toracle.FullRosterScanOracle(
        tn, ttables.DEFAULT_NONZERO_CPU, ttables.DEFAULT_NONZERO_MEM_MIB,
        with_balanced=with_balanced).place_all(tp)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any() and (got < 0).any()
    np.testing.assert_array_equal(toracle.fullchain_scan_oracle(tp, tn),
                                  joracle.fullchain_scan_oracle(jp, jn))


def test_oracle_refuses_what_it_does_not_model():
    nodes, pods = _c5_like(tobj, 1, 4, 2)
    pods[1].spec.containers[0].ports = [80]
    with pytest.raises(toracle.OracleUnsupported, match="ports"):
        toracle.fullchain_scan_oracle(pods, nodes)


def test_schedule_scan_config5_matches_oracle_and_jax(monkeypatch):
    """Reduced config 5 (``mk_c5_cluster``: 64 nodes, 300 pods, 2%
    special) through ``schedule_scan`` with the full roster in chunks of
    128: every placement equals ``fullchain_scan_oracle`` and the JAX
    scan of the whole table."""
    monkeypatch.setattr(fullchain, "SCAN_MAX_CHUNK", 128)
    nodes, pods = fullchain.mk_c5_cluster(64, 300)
    run = fullchain.schedule_scan(nodes, pods, device="cpu")
    np.testing.assert_array_equal(run.choices,
                                  toracle.fullchain_scan_oracle(pods, nodes))
    assert run.chunks == 3 and [s.steps for s in run.log.loops] == [128, 128, 44]
    jnodes = [jobj.make_node(n.metadata.name,
                             unschedulable=n.spec.unschedulable,
                             capacity={"cpu": "8", "memory": "16Gi",
                                       "pods": 110},
                             labels=dict(n.metadata.labels)) for n in nodes]
    jpods = [jobj.make_pod(p.metadata.name, requests=fullchain.C5_REQUESTS,
                           node_selector=dict(p.spec.node_selector))
             for p in pods]
    jchains, _, weights = full_roster()
    jn, jp, je, _ = jax_tables(jnodes, jpods)
    _, choice, best = jseq.SequentialScheduler(*chain_of(jchains),
                                               weights)(jp, jn, je)
    np.testing.assert_array_equal(run.choices, np.asarray(choice)[:300])
    np.testing.assert_array_equal(run.best, np.asarray(best)[:300])
    special = np.array([p.metadata.name.startswith("special") for p in pods])
    assert (run.choices[special] < 0).all() and (run.choices[~special] >= 0).all()


@pytest.mark.parametrize("seed,chunk", [(1, 40), (5, 16)])
def test_schedule_scan_chunks_match_one_jax_scan(seed, chunk, monkeypatch):
    """``schedule_scan`` in several chunks on ``constraint_cluster``
    (required and preferred (anti-)affinity on zone and hostname keys,
    both spread modes, volumes), the full roster.  Inside a chunk the
    scan carries what committed pods create (``combo_excl``,
    ``rev_weight``, the volume planes); across chunks the pods placed so
    far come in as assigned pods of the next chunk's tables.  Choices,
    best scores and the final node table equal the JAX scan of all the
    pods over one table."""
    from tests.test_torch_constraints import constraint_cluster

    monkeypatch.setattr(fullchain, "SCAN_MAX_CHUNK", chunk)
    kw = dict(n_nodes=24, n_pods=120, requests={"cpu": "2", "memory": "1Gi"})
    jnodes, jassigned, jpods, jpvcs, jpvs = constraint_cluster(jobj, seed, **kw)
    nodes, assigned, pods, pvcs, pvs = constraint_cluster(tobj, seed, **kw)
    run = fullchain.schedule_scan(nodes, pods, assigned=assigned, pvcs=pvcs,
                                  pvs=pvs, device="cpu")
    assert run.chunks == -(-len(pods) // chunk) > 2
    jchains, _, weights = full_roster()
    jn, jp, je, names = jax_tables(jnodes, jpods, jassigned, jpvcs, jpvs)
    final, choice, best = jseq.SequentialScheduler(*chain_of(jchains),
                                                   weights)(jp, jn, je)
    assert run.node_names == names
    np.testing.assert_array_equal(run.choices, np.asarray(choice)[: len(pods)])
    np.testing.assert_array_equal(run.best, np.asarray(best)[: len(pods)])
    assert_nodes_equal(run.node_table, final)
    late = run.choices[chunk:]
    assert (late >= 0).any() and (late < 0).any()


def test_schedule_scan_config3_matches_oracle(monkeypatch):
    monkeypatch.setattr(fullchain, "SCAN_MAX_CHUNK", 128)
    nodes, pods = fullchain.mk_c3_cluster(48, 300)
    run = fullchain.schedule_scan(nodes, pods, cfg=fullchain.c3_roster_config(),
                                  device="cpu")
    want = toracle.FullRosterScanOracle(
        nodes, ttables.DEFAULT_NONZERO_CPU, ttables.DEFAULT_NONZERO_MEM_MIB,
        with_balanced=False).place_all(pods)
    np.testing.assert_array_equal(run.choices, want)
    assert (want < 0).any() and (want >= 0).any()


@pytest.mark.parametrize("rows", [1, 8])
def test_scan_planes_are_the_first_step(rows):
    """``kernel_cases.scan_planes`` (the planes ``chip_smoke.py`` holds the
    kernel to) gives the first step's choices: one pod row of the exact
    scan, one block of the blocked lane."""
    from minisched_tpu_torch.engine.scan_groups import (
        interaction_sets,
        order_into_blocks,
    )
    from minisched_tpu_torch.kernel_cases import scan_planes
    from minisched_tpu_torch.ops.kernels import select_hosts_plain

    nodes, assigned, pods, pvcs, pvs = _mixed_cluster(random.Random(3), 16,
                                                      12, 40)
    if rows > 1:
        block = [m for m in order_into_blocks(
            pods, interaction_sets(pods), rows)[0] if m is not None]
        pods = block + [m for m in pods if m not in block]
    _, tchains, weights = full_roster()
    jn, jp, je, _ = jax_tables(nodes, pods, assigned, pvcs, pvs)
    tn, tp, te = to_port(jn, jp, je)
    seq = tseq.SequentialScheduler(*chain_of(tchains), weights)
    scores, mask = scan_planes(seq, tp, tn, te, rows)
    assert scores.shape == (rows, tn.capacity)
    choice, _ = select_hosts_plain(scores, mask, tp.seed[:rows])
    if rows == 1:
        assert choice.tolist() == seq(tp, tn, te)[1][:1].tolist()
    else:
        blocked = tseq.BlockedSequentialScheduler(*chain_of(tchains), weights,
                                                  block_size=rows)
        assert choice.tolist() == blocked(tp, tn, te)[1][:rows].tolist()
