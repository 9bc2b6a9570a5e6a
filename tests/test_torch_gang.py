"""The port's gangs against the JAX package's, bit for bit.

``GangTopology.batch_score`` on warm and cold gangs and on slices whose
ring wraps (declared dimensions) and does not (none), after
``tests/test_gang.py`` ``test_gang_topology_scalar_batch_parity_warm_gang``
and ``test_gang_topology_torus_wraparound``; the port's scalar rule
against its batch score and against the JAX scalar rule; the gang
columns of ``build_pod_table(gang_view=)`` and ``with_gang_view``; the
placed-member view of a run (``engine.gang.PlacedGangs``) against JAX
``gang_view_from_infos``; the no-gangs identity of ``gang_roster_config``;
and the three drivers with the gang roster (``schedule_repair_waves``,
``schedule_scan`` in chunks, ``schedule_crosspod``) against the JAX
evaluators fed the same gang views as the JAX engine feeds them.
Tolerance 0: the outputs are integers and bools.

Every JAX program compiles for tables of 128 pod and 128 node rows.
"""

from __future__ import annotations

import copy
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from minisched_tpu.api import objects as jobj
from minisched_tpu.engine import gang as jgang
from minisched_tpu.engine import scan_groups as jgroups
from minisched_tpu.models import constraints as jconstraints
from minisched_tpu.models import tables as jtables
from minisched_tpu.ops import repair as jrepair
from minisched_tpu.ops import sequential as jseq
from minisched_tpu.ops.fused import BatchContext as JBatchContext
from minisched_tpu.plugins import gangtopology as jgt
from minisched_tpu.plugins.registry import build_plugins as jbuild_plugins
from minisched_tpu.service import config as jconfig

from minisched_tpu_torch import fullchain
from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.engine import gang as tgang
from minisched_tpu_torch.headline import pods_by_node as by_node
from minisched_tpu_torch.models import tables as ttables
from minisched_tpu_torch.ops import fused as tfused
from minisched_tpu_torch.plugins import gangtopology as tgt
from minisched_tpu_torch.service import config as tconfig

from tests.test_torch_blocked_scan import jax_call
from tests.test_torch_plugins import port_tables
from tests.test_torch_sequential import assert_nodes_equal, chain_of
from tests.test_torch_tables import assert_tables_equal

CAP = 128  # pod and node rows of every table here
WAVE = 16  # waves (and scan chunks) that split gangs g02 and g07


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs test files on parallel workers: this file's torch
    work keeps to two threads so it does not crowd the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def gang_cluster(objs, seed: int = 6, n_gangs: int = 10, size: int = 4,
                 plain_every: int = 3):
    """Nodes on 4 slices of 8 hosts (a 4 x 2 torus; slices 0 and 2 declare
    their dimensions, so their ring wraps) and 8 sliceless nodes, 10%
    cordoned; ``n_gangs`` gangs of ``size``, every third with half its
    members bound on hosts of one slice; the pending pods are
    ``plain_every`` plain pods, then a gang's pending members, per gang.
    Built with either package's objects: (nodes, assigned, pending)."""
    rng = random.Random(seed)
    cap = {"cpu": "2", "memory": "8Gi", "pods": 110}
    nodes = []
    for s in range(4):
        for h in range(8):
            nodes.append(objs.make_node(
                f"s{s}h{h}", unschedulable=rng.random() < 0.1, capacity=cap,
                labels={"zone": f"z{s % 2}"}, slice_id=f"slice{s}",
                torus=(h % 4, h // 4, 0), host_index=h,
                slice_dims=(4, 2, 1) if s % 2 == 0 else None))
    nodes += [objs.make_node(f"plain{i}", unschedulable=rng.random() < 0.1,
                             capacity=cap, labels={"zone": f"z{i % 2}"})
              for i in range(8)]
    nodes.sort(key=lambda n: n.metadata.name)
    assigned, pods = [], []
    for g in range(n_gangs):
        members = objs.make_gang_pods(f"g{g:02d}", size,
                                      requests={"cpu": "500m"})
        if g % 3 == 0:
            s = rng.randrange(4)
            hosts = [n for n in nodes if n.spec.slice_id == f"slice{s}"
                     and not n.spec.unschedulable]
            for m, host in zip(members[:size // 2],
                               rng.sample(hosts, size // 2)):
                m.spec.node_name = host.metadata.name
                assigned.append(m)
            members = members[size // 2:]
        pods += [objs.make_pod(f"p{g:02d}x{i}", requests={"cpu": "500m"})
                 for i in range(plain_every)]
        pods += members
    return nodes, assigned, pods


def _snapshot_view(nodes, placed, pods):
    """JAX ``gang_view_from_infos`` over a snapshot of ``placed``,
    restricted to the gangs of ``pods`` (what the JAX engine's index
    gives a wave)."""
    on = by_node(placed)
    infos = [SimpleNamespace(node=n, pods=on.get(n.metadata.name, []))
             for n in nodes]
    return jgang.gang_view_from_infos(
        infos, {k for k in map(jobj.gang_key, pods) if k is not None})


def _bound(pod, node_name):
    out = copy.copy(pod)
    out.spec = copy.copy(pod.spec)
    out.spec.node_name = node_name
    return out


# ---------------------------------------------------------------------------
# the score plane, the scalar rule, the columns
# ---------------------------------------------------------------------------


def _views(case: str, nodes):
    """(view for the JAX and the port's tables, gangs expected warm)."""
    hashes = {n.spec.slice_id: jtables.fnv1a32(n.spec.slice_id)
              for n in nodes if n.spec.slice_id}
    if case == "cold":
        return {}, False
    # slice0 wraps (dims 4 x 2), slice1 does not; centroids off-grid and
    # beyond the ring, majority slices of either kind, one sliceless
    if case == "wrap":
        sl = ["slice0", "slice2"]
    elif case == "nowrap":
        sl = ["slice1", "slice3"]
    else:
        sl = ["slice0", "slice1", "slice2", "slice3"]
    rng = random.Random(len(case))
    view = {}
    for g in range(10):
        n = rng.randrange(1, 6)
        maj = hashes[sl[g % len(sl)]] if g != 7 else 0
        view[f"default/g{g:02d}"] = (maj, rng.randrange(-3, 4 * n + 4),
                                     rng.randrange(0, 2 * n + 3),
                                     rng.randrange(0, 2), n)
    return view, True


@pytest.mark.parametrize("case", ["warm", "cold", "wrap", "nowrap"])
def test_gang_topology_batch_matches_jax(case):
    nodes, assigned, pods = gang_cluster(jobj)
    view, warm = _views(case, nodes)
    jn, _ = jtables.build_node_table(nodes, by_node(assigned))
    jp, _ = jtables.build_pod_table(pods, gang_view=view)
    tn, tp = port_tables(jn, jp)
    want = np.asarray(jgt.GangTopology().batch_score(JBatchContext(), jp, jn,
                                                     {}))
    got = tgt.GangTopology().batch_score(tfused.BatchContext(), tp, tn, {})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert tp.use.gangs
    assert (want[np.asarray(jp.gang_id) != 0] > 0).any()
    assert ((np.asarray(jp.gang_n) > 0).any()) == warm
    if warm:  # the slice bonus shows on the majority slice
        assert (want >= tgt.SLICE_BONUS).any()


@pytest.mark.parametrize("case", ["warm", "cold"])
def test_scalar_rule_matches_batch_and_jax(case):
    """The port's ``_score_one`` for every (pod, node) equals its batch
    plane, and the JAX scalar rule on random inputs, negative deltas and
    ring sizes included."""
    nodes, assigned, pods = gang_cluster(tobj)
    view, _ = _views(case, nodes)
    tn, _ = ttables.build_node_table(nodes, by_node(assigned), device="cpu")
    tp, _ = ttables.build_pod_table(pods, gang_view=view, device="cpu")
    plane = tgt.GangTopology().batch_score(tfused.BatchContext(), tp, tn, {})
    for i, pod in enumerate(pods):
        key = tobj.gang_key(pod)
        gid = 0 if key is None else ttables.fnv1a32(key)
        for j, node in enumerate(nodes):
            sh, x, y, z = tgang.node_topo(node)
            want = tgt._score_one(gid, view.get(key), sh, x, y, z,
                                  tgang.node_dims(node))
            assert int(plane[i, j]) == want, (pod.metadata.name,
                                              node.metadata.name)
    rng = random.Random(3)
    for _ in range(2000):
        n = rng.randrange(1, 9)
        agg = (rng.choice([0, 5, -7]), rng.randrange(-40, 40),
               rng.randrange(-40, 40), rng.randrange(-9, 9), n)
        args = (rng.randrange(-2**31, 2**31), agg if rng.random() < 0.7
                else None, rng.choice([0, 5, -7, 11]), rng.randrange(8),
                rng.randrange(8), rng.randrange(3),
                (rng.randrange(5), rng.randrange(5), rng.randrange(3)))
        assert tgt._score_one(*args) == jgt._score_one(*args)


def test_pod_table_gang_columns_match_jax():
    """``build_pod_table(gang_view=)`` byte-equal with JAX's; a gang missing
    from the view, and no view, leave zeros; ``with_gang_view`` writes the
    columns the build writes."""
    jnodes, _, jpods = gang_cluster(jobj)
    tnodes, _, tpods = gang_cluster(tobj)
    view, _ = _views("warm", jnodes)
    del view["default/g03"]
    for v in (view, None):
        assert_tables_equal(
            ttables.build_pod_table(tpods, capacity=CAP, gang_view=v,
                                    device="cpu")[0],
            jtables.build_pod_table(jpods, capacity=CAP, gang_view=v)[0])
    plain, _ = ttables.build_pod_table(tpods, capacity=CAP, device="cpu")
    assert not plain.gang_n.any() and plain.gang_id.any()
    rewritten = ttables.with_gang_view(plain, tpods, view)
    assert_tables_equal(rewritten, jtables.build_pod_table(
        jpods, capacity=CAP, gang_view=view)[0])
    assert rewritten.use == plain.use


def test_placed_gangs_view_matches_jax_snapshot():
    """``PlacedGangs`` (the assigned members, then commits) gives the view
    JAX ``gang_view_from_infos`` gives on a snapshot of the same
    placements, and so does the port's own ``gang_view_from_infos``."""
    jnodes, jassigned, jpods = gang_cluster(jobj)
    tnodes, tassigned, tpods = gang_cluster(tobj)
    placed = tgang.PlacedGangs(tnodes, tassigned)
    assert tgang.PlacedGangs.for_pods(tpods[:3], tnodes) is None
    rng = random.Random(1)
    jplaced = list(jassigned)
    for s in range(0, len(tpods), 8):
        keys = tgang.gang_keys(tpods[s:s + 8])
        want = _snapshot_view(jnodes, jplaced, jpods[s:s + 8])
        assert placed.view_for(keys) == want
        rows = [rng.randrange(-1, len(tnodes)) for _ in tpods[s:s + 8]]
        placed.commit(tpods[s:s + 8], rows)
        jplaced += [_bound(p, jnodes[r].metadata.name)
                    for p, r in zip(jpods[s:s + 8], rows) if r >= 0]
        infos = [SimpleNamespace(node=n, pods=by_node(
            [_bound(p, tnodes[r].metadata.name)
             for p, r in zip(tpods[s:s + 8], rows) if r >= 0]).get(
                 n.metadata.name, [])) for n in tnodes]
        assert tgang.gang_view_from_infos(infos) == jgang.gang_view_from_infos(
            [SimpleNamespace(node=jn_, pods=i.pods) for jn_, i in
             zip(jnodes, infos)])
    assert any(agg[4] > 2 for agg in placed.view_for(
        tgang.gang_keys(tpods)).values())


def test_gang_key_and_make_gang_pods():
    pods = tobj.make_gang_pods("train", 3, namespace="ml", ttl_s=5.0,
                               requests={"cpu": "1"})
    assert [p.metadata.name for p in pods] == ["train-0", "train-1", "train-2"]
    assert {tobj.gang_key(p) for p in pods} == {"ml/train"}
    assert pods[0].spec.gang == tobj.GangSpec("train", 3, 5.0)
    assert tobj.gang_key(tobj.make_pod("solo")) is None
    assert tobj.gang_key(tobj.make_pod("x", gang=tobj.GangSpec(""))) is None


def test_no_gangs_means_identical_placements():
    """Config 5 without gang specs: the gang roster places as the full
    roster (choices, rounds, every final column)."""
    nodes, pods = fullchain.mk_c5_cluster(96, 600)
    runs = [fullchain.schedule_repair_waves(nodes, pods, wave=128,
                                            device="cpu", cfg=cfg)
            for cfg in (tconfig.gang_roster_config(),
                        tconfig.default_full_roster_config())]
    np.testing.assert_array_equal(runs[0].choices, runs[1].choices)
    assert runs[0].rounds == runs[1].rounds and not runs[0].gang_views
    want = ttables.table_columns(runs[1].node_table)
    for name, col in ttables.table_columns(runs[0].node_table).items():
        assert torch.equal(col, want[name]), name


# ---------------------------------------------------------------------------
# the drivers against the JAX evaluators
# ---------------------------------------------------------------------------

GANG = (jbuild_plugins(jconfig.gang_roster_config()),
        tconfig.gang_roster_config().score_weights())


@pytest.fixture(scope="module")
def clusters():
    return gang_cluster(jobj), gang_cluster(tobj)


def test_repair_waves_match_jax(clusters):
    """``schedule_repair_waves`` with the gang roster equals the JAX
    ``RepairingEvaluator`` wave by wave, each wave's gang view the JAX
    engine's (the placements so far) and its constraint tables with them
    as assigned pods."""
    (jnodes, jassigned, jpods), (tnodes, tassigned, tpods) = clusters
    chains, weights = GANG
    ev = jrepair.RepairingEvaluator(*chain_of(chains), weights=weights,
                                    with_diagnostics=True)
    jn, names = jtables.build_node_table(jnodes, by_node(jassigned))
    placed, views = list(jassigned), []
    choices, rounds, unsched = [], [], []
    for s in range(0, len(jpods), WAVE):
        batch = jpods[s:s + WAVE]
        views.append(_snapshot_view(jnodes, placed, batch))
        jp, _ = jtables.build_pod_table(batch, capacity=CAP,
                                        gang_view=views[-1])
        extra = jconstraints.build_constraint_tables(
            batch, jnodes, placed, pod_capacity=CAP,
            node_capacity=jn.capacity, scan_planes=False)
        jn, choice, r, u = ev(jp, jn, extra)
        choice = np.asarray(choice)[: len(batch)]
        placed += [_bound(p, names[c]) for p, c in zip(batch, choice)
                   if c >= 0]
        choices.append(choice)
        rounds.append(int(r))
        unsched.append(np.asarray(u)[:, : len(batch)])
    run = fullchain.schedule_repair_waves(
        tnodes, tpods, wave=WAVE, device="cpu",
        cfg=tconfig.gang_roster_config(), assigned=tassigned)
    np.testing.assert_array_equal(run.choices, np.concatenate(choices))
    assert run.rounds == rounds
    assert run.gang_views == views
    # a gang split by a wave boundary is warm in the next wave
    stragglers = {jobj.gang_key(p) for p in jassigned}
    assert any(k not in stragglers for v in views for k in v)
    assert_nodes_equal(run.node_table, jn)
    want_unsched = np.concatenate(unsched, axis=1)
    for k, pl in enumerate(chains.filter):
        np.testing.assert_array_equal(run.unschedulable[pl.name()],
                                      want_unsched[k], err_msg=pl.name())


def test_scan_chunks_match_jax(clusters, monkeypatch):
    """``schedule_scan`` in chunks of 16 (two gangs straddle chunks) equals the
    JAX ``SequentialScheduler`` chunk by chunk, each chunk's gang view
    fixed at its start, as in the JAX engine."""
    monkeypatch.setattr(fullchain, "SCAN_MAX_CHUNK", WAVE)
    (jnodes, jassigned, jpods), (tnodes, tassigned, tpods) = clusters
    chains, weights = GANG
    sched = jseq.SequentialScheduler(*chain_of(chains), weights)
    jn, names = jtables.build_node_table(jnodes, by_node(jassigned))
    placed, views, choices, best = list(jassigned), [], [], []
    for s in range(0, len(jpods), WAVE):
        part = jpods[s:s + WAVE]
        views.append(_snapshot_view(jnodes, placed, part))
        jp, _ = jtables.build_pod_table(part, capacity=CAP,
                                        gang_view=views[-1])
        je = jconstraints.build_constraint_tables(
            part, jnodes, placed, pod_capacity=CAP,
            node_capacity=jn.capacity, scan_planes=True)
        jn, choice, score = sched(jp, jn, je)
        choice = np.asarray(choice)[: len(part)]
        placed += [_bound(p, names[c]) for p, c in zip(part, choice)
                   if c >= 0]
        choices.append(choice)
        best.append(np.asarray(score)[: len(part)])
    run = fullchain.schedule_scan(tnodes, tpods,
                                  cfg=tconfig.gang_roster_config(),
                                  assigned=tassigned, device="cpu")
    assert run.chunks == len(views) > 2
    np.testing.assert_array_equal(run.choices, np.concatenate(choices))
    np.testing.assert_array_equal(run.best, np.concatenate(best))
    assert run.gang_views == views
    assert_nodes_equal(run.node_table, jn)


def jax_lane(nodes, assigned, pods):
    """The blocked lane through the JAX package, as
    ``tests/test_torch_blocked_scan.py`` ``jax_crosspod`` drives it, each
    call's pod table with the gang view of the placements so far (the JAX
    engine's ``_schedule_scan_blocked``): (choices, final node table,
    attempts)."""
    chains, weights = GANG
    blocked = jseq.BlockedSequentialScheduler(
        *chain_of(chains), weights, block_size=fullchain.SCAN_BLOCK_SIZE)
    exact = jseq.SequentialScheduler(*chain_of(chains), weights)
    names = [n.metadata.name for n in nodes]
    placed = list(assigned)
    position = {id(p): k for k, p in enumerate(pods)}
    choices = np.full(len(pods), -1, np.int64)
    dummy = jobj.make_pod("scan-pad")

    def tables(part, invalid_rows=()):
        jn, _ = jtables.build_node_table(nodes, by_node(placed))
        jp, _ = jtables.build_pod_table(
            part, capacity=CAP, invalid_rows=invalid_rows,
            gang_view=_snapshot_view(nodes, placed, part))
        je = jconstraints.build_constraint_tables(
            part, nodes, placed, pod_capacity=CAP, node_capacity=jn.capacity,
            scan_planes=True)
        return jn, jp, je

    pending, attempts = list(pods), 0
    for _ in range(fullchain.SCAN_BLOCK_RETRIES):
        attempts += 1
        blocks = jgroups.order_into_blocks(
            pending, jgroups.interaction_sets(pending),
            fullchain.SCAN_BLOCK_SIZE)
        flat = [m for b in blocks for m in b]
        jn, jp, je = tables([m if m is not None else dummy for m in flat],
                            [i for i, m in enumerate(flat) if m is None])
        _, choice, _, accepted = jax_call(blocked, jp, jn, je)
        retry = []
        for m, row, ok in zip(flat, np.asarray(choice).tolist(),
                              np.asarray(accepted).tolist()):
            if m is None:
                continue
            if row >= 0 and ok:
                choices[position[id(m)]] = row
                placed.append(_bound(m, names[row]))
            elif row >= 0:
                retry.append(m)
        pending = retry
        if not pending:
            break
    if pending:
        jn, jp, je = tables(pending)
        _, choice, _ = jax_call(exact, jp, jn, je)
        for m, row in zip(pending, np.asarray(choice).tolist()):
            choices[position[id(m)]] = row
            if row >= 0:
                placed.append(_bound(m, names[row]))
    final, _ = jtables.build_node_table(nodes, by_node(placed))
    return choices, final, attempts


def test_crosspod_lane_matches_jax(clusters):
    """``schedule_crosspod`` with the gang roster equals the blocked lane
    driven through the JAX package, each call's gang view the JAX
    engine's: choices, attempts and the final node table."""
    (jnodes, jassigned, jpods), (tnodes, tassigned, tpods) = clusters
    want, final, attempts = jax_lane(jnodes, jassigned, jpods)
    tn, _ = ttables.build_node_table(tnodes, by_node(tassigned), device="cpu")
    run = fullchain.schedule_crosspod(tnodes, tpods, tn, tassigned,
                                      cfg=tconfig.gang_roster_config(),
                                      device="cpu")
    assert run.attempts == attempts
    np.testing.assert_array_equal(run.choices, want)
    assert_nodes_equal(run.node_table, final)
    assert (want >= 0).all()
