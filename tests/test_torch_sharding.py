"""The port's device mesh (``parallel/sharding.py``) against JAX's.

The port's steps run on a virtual mesh of the host
(``make_mesh(n, devices=[cpu] * n)``), JAX's on the 8-device CPU mesh
``tests/conftest.py`` forces.  Each case of JAX's ``tests/test_sharding.py``
is mirrored: the sharded wave step (``:74``), commits into node shards
(``:81``), the factoring rule (``:105``), the uneven config-3-scale
repair loop (``:234``) and the exact scan (``:262``), each held bit for
bit (``choice``, ``best`` and the final node tables compared with ``==``)
against JAX's sharded step, JAX's single-device step and the port's
mesh-off path, at 1 x 8, 2 x 4, 1 x 3 and 3 x 1 meshes with node counts
no axis divides.  The mesh policy, ``make_mesh``'s checks and the layout
maps are held to JAX's case by case, the shard merge of ``select_hosts``
to JAX's whole-row argmax, and a property test over the mixed cluster
(every full-roster feature) catches a node-axis reduction that is not
merged.
"""

from __future__ import annotations

import random

import jax
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from minisched_tpu.api import objects as jobj
from minisched_tpu.models import tables as jtables
from minisched_tpu.ops import fused as jfused
from minisched_tpu.ops import repair as jrepair
from minisched_tpu.ops import sequential as jseq
from minisched_tpu.parallel import sharding as jsh
from minisched_tpu.plugins.interpodaffinity import (
    InterPodAffinity as JInterPodAffinity,
)
from minisched_tpu.plugins.nodenumber import NodeNumber as JNodeNumber
from minisched_tpu.plugins.noderesources import (
    NodeResourcesFit as JFit,
    NodeResourcesLeastAllocated as JLeast,
)
from minisched_tpu.plugins.nodeunschedulable import (
    NodeUnschedulable as JNodeUnschedulable,
)
from minisched_tpu.plugins.podtopologyspread import (
    PodTopologySpread as JPodTopologySpread,
)

from minisched_tpu_torch import fullchain
from minisched_tpu_torch.models import constraints as tconstraints
from minisched_tpu_torch.models import tables as ttables
from minisched_tpu_torch.ops import kernels
from minisched_tpu_torch.ops import repair as trepair
from minisched_tpu_torch.ops import sequential as tseq
from minisched_tpu_torch.ops.fused import BatchContext, evaluate
from minisched_tpu_torch.ops.state import apply_placements
from minisched_tpu_torch.parallel import sharding as tsh
from minisched_tpu_torch.plugins.interpodaffinity import InterPodAffinity
from minisched_tpu_torch.plugins.nodenumber import NodeNumber
from minisched_tpu_torch.plugins.noderesources import (
    NodeResourcesFit,
    NodeResourcesLeastAllocated,
)
from minisched_tpu_torch.plugins.nodeunschedulable import NodeUnschedulable
from minisched_tpu_torch.plugins.podtopologyspread import PodTopologySpread
from minisched_tpu_torch.plugins.registry import build_plugins
from minisched_tpu_torch.service import config as tconfig

from tests.test_torch_plugins import jax_columns, port_tables

CPU = torch.device("cpu")
#: (pod shards, node shards) of the port's meshes under test
MESHES = [(1, 8), (2, 4), (1, 3), (3, 1)]
MESH_IDS = [f"{p}x{n}" for p, n in MESHES]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def port_mesh(pod_shards: int, node_shards: int) -> tsh.Mesh:
    n = pod_shards * node_shards
    return tsh.make_mesh(n, pod_shards=pod_shards, devices=[CPU] * n)


def capacity_for(n: int, shards: int) -> int:
    """The lane-padded capacity a mesh axis of ``shards`` needs."""
    return ttables.pad_to(n, tsh.cap_multiple(128, shards))


def assert_port_tables_equal(got, want) -> None:
    want_cols = ttables.table_columns(want)
    for name, col in ttables.table_columns(got).items():
        assert torch.equal(col, want_cols[name]), name


# ---------------------------------------------------------------------------
# policy, factoring, checks, layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_devices, n_processes", [
    (1, 1), (8, 1), (16, 1), (64, 1), (6, 1), (8, 2), (32, 4), (32, 8),
    (6, 4), (12, 1), (2, 1), (3, 1)])
def test_default_pod_shards_factoring(n_devices, n_processes):
    assert (tsh.default_pod_shards(n_devices, n_processes)
            == jsh.default_pod_shards(n_devices, n_processes))


@pytest.mark.parametrize("n_devices, pod_shards", [
    (None, None), (8, None), (8, 1), (8, 8), (4, 2), (6, None), (6, 3),
    (1, None), (3, 1), (3, 3)])
def test_make_mesh_factors_as_jax(n_devices, pod_shards):
    want = jsh.make_mesh(n_devices, pod_shards, devices=jax.devices()[:8])
    got = tsh.make_mesh(n_devices, pod_shards, devices=[CPU] * 8)
    assert got.shape == dict(want.shape)
    assert got.size == want.size
    assert tsh.mesh_shape_key(got) == jsh.mesh_shape_key(want)
    assert tsh.mesh_axis_sizes(got) == jsh.mesh_axis_sizes(want)


@pytest.mark.parametrize("kw", [
    {"n_devices": 0}, {"n_devices": 9}, {"n_devices": 8, "pod_shards": 3},
    {"n_devices": 6, "pod_shards": 4}])
def test_make_mesh_refuses_as_jax(kw):
    with pytest.raises(ValueError):
        jsh.make_mesh(devices=jax.devices()[:8], **kw)
    with pytest.raises(ValueError):
        tsh.make_mesh(devices=[CPU] * 8, **kw)


def test_make_mesh_without_a_card_asks_for_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="devices="):
        tsh.make_mesh()


@pytest.mark.parametrize("base, axis", [(128, 1), (128, 2), (128, 3),
                                        (128, 4), (128, 6), (128, 8)])
def test_cap_multiple_and_off_mesh_keys(base, axis):
    assert tsh.cap_multiple(base, axis) == jsh.cap_multiple(base, axis)
    assert tsh.mesh_shape_key(None) == jsh.mesh_shape_key(None) == ()
    assert tsh.mesh_axis_sizes(None) == jsh.mesh_axis_sizes(None) == (1, 1)


@pytest.mark.parametrize("env, cards, want", [
    ({"MINISCHED_MESH": "0"}, 8, None),
    ({}, 8, {"pods": 2, "nodes": 4}),
    ({}, 1, None),
    ({}, 0, None),
    ({"MINISCHED_MESH": "1"}, 1, {"pods": 1, "nodes": 1}),
    ({"MINISCHED_MESH": "1"}, 8, {"pods": 2, "nodes": 4}),
    ({"MINISCHED_MESH": "1", "MINISCHED_MESH_POD_SHARDS": "1"}, 8,
     {"pods": 1, "nodes": 8}),
    ({"MINISCHED_MESH_POD_SHARDS": "4"}, 8, {"pods": 4, "nodes": 2}),
])
def test_resolve_mesh_policy(monkeypatch, env, cards, want):
    """JAX's rule (``sharding.py:65-88``) over ``torch.cuda``'s visible
    cards; JAX's own answer on its 8 devices where the card count is 8."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got = tsh.resolve_mesh(env=env)
    assert (None if got is None else got.shape) == want
    if got is not None:
        assert got.devices[0][0] == torch.device("cuda", 0)
    if cards == 8:
        jax_mesh = jsh.resolve_mesh(env=env)
        assert (None if jax_mesh is None else dict(jax_mesh.shape)) == want


def test_resolve_mesh_refusals(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for mod in (tsh, jsh):
        with pytest.raises(ValueError):
            mod.resolve_mesh(env={"MINISCHED_MESH": "banana"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsh.resolve_mesh(env={"MINISCHED_MESH": "1"})
    # a CPU engine sees one device, the host
    one = tsh.resolve_mesh(env={"MINISCHED_MESH": "1"}, device="cpu")
    assert one.shape == {"pods": 1, "nodes": 1}
    assert tsh.resolve_mesh(env={}, device="cpu") is None


def _spec(named_sharding, ndim: int):
    """A JAX NamedSharding as the port's placement: (axis, dim) or None;
    a split trailing dim of a 2-D or wider plane is the port's -1."""
    spec = tuple(named_sharding.spec) + (None,) * ndim
    axes = [(a, d) for d, a in enumerate(spec[:ndim]) if a is not None]
    if not axes:
        return None
    (axis, dim), = axes
    return axis, (-1 if dim == ndim - 1 and dim > 0 else dim)


@pytest.fixture(scope="module")
def small_tables():
    nodes, assigned, pods = _scale_cluster(40, 30, 10, seed=4)
    return _tables(nodes, assigned, pods)


@pytest.mark.parametrize("which", ["pods", "nodes", "constraints", "scan",
                                   "static"])
def test_layout_maps_match_jax(which, small_tables):
    (jn, jp, je), (tn, tp, te) = small_tables
    jmesh = jsh.make_mesh(8)
    tmesh = port_mesh(2, 4)
    if which == "pods":
        want, got, table = (jsh.pod_sharding(jmesh, jp),
                            tsh.pod_sharding(tmesh, tp), jp)
    elif which == "nodes":
        want, got, table = (jsh.node_sharding(jmesh, jn),
                            tsh.node_sharding(tmesh, tn), jn)
    elif which == "constraints":
        want, got, table = (jsh.constraint_sharding(jmesh, je),
                            tsh.constraint_sharding(tmesh, te), je)
    elif which == "scan":
        want, got, table = (jsh.scan_constraint_sharding(jmesh, je),
                            tsh.scan_constraint_sharding(tmesh, te), je)
    else:
        cols = {f: getattr(jn, f) for f in ttables.NODE_STATIC_COLS}
        want = jsh.static_col_shardings(jmesh, cols)
        got = tsh.static_col_shardings(tmesh, cols)
        assert set(got) == set(want)
        for name, sh in want.items():
            assert got[name] == _spec(sh, np.ndim(cols[name])), name
        return
    for name in got:
        leaf = getattr(table, name)
        assert got[name] == _spec(getattr(want, name), np.ndim(leaf)), name


# ---------------------------------------------------------------------------
# the shard merge of select_hosts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("tie_heavy", [True, False])
def test_shard_merge_equals_jax_whole_row(shards, tie_heavy):
    """Each shard's twin at its ``node_base``, merged, equals JAX's XLA
    tail over the whole rows, with INT32_MIN scores and empty rows."""
    from minisched_tpu_torch.kernel_cases import select_case

    scores, mask, seeds = select_case(shards + 5, 19, 600, tie_heavy)
    mask[7] = False
    scores[8] = np.iinfo(np.int32).min
    want_c, want_b = jfused.select_hosts(
        jax.numpy.asarray(scores), jax.numpy.asarray(mask),
        jax.numpy.asarray(seeds))
    s, m = torch.from_numpy(scores), torch.from_numpy(mask)
    sd = torch.from_numpy(seeds.view(np.int32))
    width = -(-600 // shards)
    parts = [kernels.select_hosts_plain(s[:, b:b + width].contiguous(),
                                        m[:, b:b + width].contiguous(), sd, b)
             for b in range(0, 600, width)]
    choice, best = kernels.select_hosts_merge(parts, sd)
    np.testing.assert_array_equal(choice.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(best.numpy(), np.asarray(want_b))


def test_merges_are_the_identity_off_a_mesh():
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    for fn in (tsh.node_max, tsh.node_min, tsh.node_sum, tsh.node_any):
        assert fn(x) is x
    assert tsh.node_base() == 0
    c, b = torch.tensor([1], dtype=torch.int32), torch.tensor([5])
    assert tsh.merge_select(c, b, torch.tensor([3])) == (c, b)


def test_diverged_node_shards_raise():
    """Node shards that reach different merges raise, never merge the
    wrong partials."""
    mesh = port_mesh(1, 2)

    def tile(i, j):
        x = torch.ones(3, dtype=torch.int32)
        return tsh.node_max(x) if j == 0 else tsh.node_sum(x)

    with pytest.raises(RuntimeError, match="diverged"):
        tsh.run_tiles(mesh, tile, 4)


def test_a_failing_tile_stops_its_peers():
    mesh = port_mesh(2, 4)

    def tile(i, j):
        if (i, j) == (1, 2):
            raise KeyError("boom")
        return tsh.node_sum(torch.ones(2))

    with pytest.raises(KeyError, match="boom"):
        tsh.run_tiles(mesh, tile, 4)
    # the mesh runs again afterwards
    out = tsh.run_tiles(mesh, lambda i, j: tsh.node_sum(torch.ones(2)), 4)
    assert all(torch.equal(v, torch.full((2,), 4.0)) for v in out.values())


def test_tiles_stress_under_a_short_switch_interval():
    """More tiles than cores, the interpreter switching every 10 us: every
    merge of every round gives each node shard its pod shard's value, and
    the launch ledger the tiles share loses no update."""
    import sys

    mesh = tsh.make_mesh(32, pod_shards=4, devices=[CPU] * 32)
    rounds = 40
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        kernels.reset_launch_counts()

        def tile(i, j):
            seen = []
            for r in range(rounds):
                x = torch.tensor([i * 1000 + j + r])
                seen.append(int(tsh.node_max(x)))
                seen.append(int(tsh.node_sum(torch.ones(1,
                                                        dtype=torch.int32))))
                kernels.select_hosts(torch.zeros((1, 2), dtype=torch.int32),
                                     torch.ones((1, 2), dtype=torch.bool),
                                     torch.zeros(1, dtype=torch.int32))
            return seen

        out = tsh.run_tiles(mesh, tile, 4)
    finally:
        sys.setswitchinterval(before)
    for (i, _j), seen in out.items():
        assert seen == [v for r in range(rounds)
                        for v in (i * 1000 + 7 + r, 8)]
    assert kernels.plain_calls["select_hosts"] == 32 * rounds


# ---------------------------------------------------------------------------
# the sharded wave step (JAX test_sharding.py:74, :81)
# ---------------------------------------------------------------------------


def _nn_cluster(objs, seed=5, n_nodes=200, n_pods=130):
    rng = random.Random(seed)
    nodes = sorted((objs.make_node(f"node{i}",
                                   unschedulable=rng.random() < 0.3)
                    for i in range(n_nodes)), key=lambda n: n.metadata.name)
    return nodes, [objs.make_pod(f"pod{i}") for i in range(n_pods)]


def _nn_chain(mod):
    nn = mod[1]()
    return (mod[0](),), (nn,), (nn,)


@pytest.mark.parametrize("pod_shards, node_shards",
                         [(1, 1), (2, 4), (1, 8), (8, 1), (2, 2), (1, 3),
                          (3, 1)],
                         ids=["1x1", "2x4", "1x8", "8x1", "2x2", "1x3", "3x1"])
def test_sharded_step_matches_single_device(pod_shards, node_shards):
    nodes, pods = _nn_cluster(jobj)
    cap_n = capacity_for(len(nodes), node_shards)
    cap_p = capacity_for(len(pods), pod_shards)
    jn, _ = jtables.build_node_table(nodes, capacity=cap_n)
    jp, _ = jtables.build_pod_table(pods, capacity=cap_p)
    jctx = jfused.BatchContext(weights=(("NodeNumber", 1),))
    jmesh = jsh.make_mesh(pod_shards * node_shards, pod_shards)
    jstep = jsh.sharded_wave_step(jmesh, *_nn_chain(
        (JNodeUnschedulable, JNodeNumber)), jctx)
    jp_s, jn_s = jsh.shard_tables(jmesh, jp, jn)
    jnodes, jchoice, jbest = jstep(jn_s, jp_s)
    tn, tp = port_tables(jn, jp)
    ctx = BatchContext(weights=(("NodeNumber", 1),))
    chain = _nn_chain((NodeUnschedulable, NodeNumber))
    off = evaluate(tp, tn, *chain, ctx)
    step = tsh.sharded_wave_step(port_mesh(pod_shards, node_shards), *chain,
                                 ctx)
    got_nodes, choice, best = step(tp, tn)
    np.testing.assert_array_equal(choice.numpy(), np.asarray(jchoice))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    assert torch.equal(choice, off.choice) and torch.equal(best, off.best_score)
    assert_port_tables_equal(got_nodes, apply_placements(tn, tp, off.choice))
    np.testing.assert_array_equal(got_nodes.req_pods.numpy(),
                                  np.asarray(jnodes.req_pods))


@pytest.mark.parametrize("pod_shards, node_shards", MESHES, ids=MESH_IDS)
def test_shard_tables_splits_as_jax_lays_out(pod_shards, node_shards):
    """``shard_tables``: pod shard i holds rows ``i * P / pods`` on, node
    shard j rows ``j * N / nodes`` on with the profile planes whole, as
    JAX's shardings place them; gathering gives the table back."""
    from minisched_tpu_torch.api import objects as tobj

    nodes, pods = _nn_cluster(tobj, n_nodes=300, n_pods=100)
    tn, _ = ttables.build_node_table(nodes, capacity=768, device="cpu")
    tp, _ = ttables.build_pod_table(pods, capacity=384, device="cpu")
    pod_parts, node_parts = tsh.shard_tables(
        port_mesh(pod_shards, node_shards), tp, tn)
    pw, nw = 384 // pod_shards, 768 // node_shards
    assert len(pod_parts) == pod_shards and node_parts.width == nw
    for i, part in enumerate(pod_parts):
        assert torch.equal(part.seed, tp.seed[i * pw:(i + 1) * pw])
        assert part.use == tp.use
    for j, part in enumerate(node_parts.shards):
        assert torch.equal(part.name_hash, tn.name_hash[j * nw:(j + 1) * nw])
        assert torch.equal(part.prof_label_key, tn.prof_label_key)
    assert_port_tables_equal(tsh.gather_nodes(node_parts, CPU), tn)


def test_commits_land_in_the_owning_shard():
    """JAX's ``:81`` through node shards: two pods on node 0, one
    unplaced, padding rows nothing, the other shards untouched; a split
    table gathers back to itself."""
    from minisched_tpu_torch.api import objects as tobj

    nodes, pods = _nn_cluster(tobj, n_nodes=300, n_pods=3)
    tn, _ = ttables.build_node_table(nodes, capacity=384, device="cpu")
    tp, _ = ttables.build_pod_table(pods, device="cpu")
    shards = tsh.shard_nodes(port_mesh(1, 3), tn)
    assert [s.valid.shape[0] for s in shards.shards] == [128, 128, 128]
    assert_port_tables_equal(tsh.gather_nodes(shards, CPU), tn)
    choice = torch.tensor([0, 0, -1] + [0] * (tp.capacity - 3),
                          dtype=torch.int32)
    choice = torch.where(tp.valid, choice, -1)
    for j in range(3):
        base = shards.base(j)
        own = (choice >= base) & (choice < base + shards.width)
        shards.shards[j] = apply_placements(
            shards.shards[j], tp,
            torch.where(own, choice - base, -1).to(torch.int32))
    got = tsh.gather_nodes(shards, CPU)
    assert_port_tables_equal(got, apply_placements(tn, tp, choice))
    assert int(got.req_pods[0]) == 2 and int(got.req_pods[1:].sum()) == 0
    assert int(got.req_cpu[0]) == int(tp.req_cpu[0] + tp.req_cpu[1])


# ---------------------------------------------------------------------------
# the uneven config-3-scale repair loop (JAX :234) and the scan (:262)
# ---------------------------------------------------------------------------


def _scale_cluster(n_nodes, n_pods, n_assigned, seed):
    """JAX's ``_scale_cluster`` (``tests/test_sharding.py:123``) at a
    size the CPU tests afford: zones, cordons, assigned pods, spread and
    preferred affinity."""
    from tests.test_sharding import _scale_cluster as jscale

    return jscale(n_nodes=n_nodes, n_pods=n_pods, n_assigned=n_assigned,
                  seed=seed)


def _tables(nodes, assigned, pods, node_cap=None, pod_cap=None,
            scan_planes=False):
    from minisched_tpu.models.constraints import build_constraint_tables

    by_node = {}
    for p in assigned:
        by_node.setdefault(p.spec.node_name, []).append(p)
    jn, _ = jtables.build_node_table(nodes, by_node, capacity=node_cap)
    jp, _ = jtables.build_pod_table(pods, capacity=pod_cap)
    je = build_constraint_tables(pods, nodes, assigned,
                                 pod_capacity=jp.capacity,
                                 node_capacity=jn.capacity,
                                 scan_planes=scan_planes)
    tn, tp = port_tables(jn, jp)
    te = tconstraints.constraint_tables_from_numpy(jax_columns(je), "cpu")
    return (jn, jp, je), (tn, tp, te)


def _crosspod(mods):
    ipa, ts = mods[2](), mods[3]()
    return ((mods[0](), mods[1](), ipa, ts), (ipa, ts), (mods[4](), ipa, ts))


JCROSS = (JNodeUnschedulable, JFit, JInterPodAffinity, JPodTopologySpread,
          JLeast)
TCROSS = (NodeUnschedulable, NodeResourcesFit, InterPodAffinity,
          PodTopologySpread, NodeResourcesLeastAllocated)


@pytest.fixture(scope="module")
def c3_uneven():
    """700 nodes and 900 pods (neither divides any axis) with cross-pod
    constraint tables, at capacities 768 x 1152 (384 divides both)."""
    nodes, assigned, pods = _scale_cluster(700, 900, 60, seed=9)
    tabs = _tables(nodes, assigned, pods, pod_cap=1152)
    (jn, jp, je), _ = tabs
    want = jrepair.RepairingEvaluator(*_crosspod(JCROSS))(jp, jn, je)
    jmesh = jsh.make_mesh(8)
    step = jsh.sharded_repair_step(jmesh, *_crosspod(JCROSS),
                                   jfused.BatchContext(weights=()))
    jp_s, jn_s = jsh.shard_tables(jmesh, jp, jn)
    je_s = jax.device_put(je, jsh.constraint_sharding(jmesh, je))
    sharded = step(jn_s, jp_s, je_s)
    return tabs, len(pods), want, sharded


@pytest.mark.parametrize("pod_shards, node_shards", MESHES, ids=MESH_IDS)
def test_sharded_repair_config3_scale_uneven_bit_equal(
        pod_shards, node_shards, c3_uneven):
    (_, (tn, tp, te)), n_pods, want, jax_sharded = c3_uneven
    np.testing.assert_array_equal(np.asarray(jax_sharded[1]),
                                  np.asarray(want[1]))
    chains = _crosspod(TCROSS)
    off = trepair.RepairingEvaluator(*chains)(tp, tn, te)
    got = trepair.RepairingEvaluator(
        *chains, mesh=port_mesh(pod_shards, node_shards))(tp, tn, te)
    np.testing.assert_array_equal(got.choice.numpy(), np.asarray(want[1]))
    assert torch.equal(got.choice, off.choice) and got.rounds == off.rounds
    assert got.rounds == int(want[2])
    assert_port_tables_equal(got.node_table, off.node_table)
    placed = int((got.choice[:n_pods] >= 0).sum())
    assert placed == n_pods  # ample headroom: all place


@pytest.fixture(scope="module")
def scan_case():
    nodes, assigned, pods = _scale_cluster(130, 96, 20, seed=3)
    tabs = _tables(nodes, assigned, pods, node_cap=384)
    (jn, jp, je), _ = tabs
    want = jseq.SequentialScheduler(*_crosspod(JCROSS))(jp, jn, je)
    step = jsh.sharded_scan_step(jsh.make_mesh(8), *_crosspod(JCROSS),
                                 jfused.BatchContext(weights=()))
    sharded = step(jn, jp, je)
    return tabs, len(pods), want, sharded


@pytest.mark.parametrize("pod_shards, node_shards", MESHES, ids=MESH_IDS)
def test_sharded_scan_matches_single_device(pod_shards, node_shards,
                                            scan_case):
    (_, (tn, tp, te)), n_pods, want, jax_sharded = scan_case
    np.testing.assert_array_equal(np.asarray(jax_sharded[1]),
                                  np.asarray(want[1]))
    chains = _crosspod(TCROSS)
    off = tseq.SequentialScheduler(*chains)(tp, tn, te)
    mesh = port_mesh(pod_shards, node_shards)
    got = tseq.SequentialScheduler(*chains, mesh=mesh)(tp, tn, te)
    step = tsh.sharded_scan_step(mesh, *chains, BatchContext(in_scan=True))
    stepped = step(tp, tn, te)
    for out in (got, stepped):
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(want[2]))
        assert_port_tables_equal(out[0], off[0])
    assert int((got[1] >= 0).sum()) == n_pods



@pytest.mark.parametrize("lane", ["exact", "blocked"])
@pytest.mark.parametrize("pod_shards, node_shards", MESHES, ids=MESH_IDS)
def test_mesh_scan_lanes_keep_their_step_log(lane, pod_shards, node_shards,
                                             scan_case):
    """A ``StepLog`` passed to a scan lane over a mesh gets the loop the
    mesh-off lane logs: one loop, a step a live pod (a block for the
    blocked lane)."""
    (_, (tn, tp, te)), n_pods, _, _ = scan_case
    chains = _crosspod(TCROSS)
    kw = {"block_size": 8} if lane == "blocked" else {}
    cls = (tseq.BlockedSequentialScheduler if lane == "blocked"
           else tseq.SequentialScheduler)
    logs = []
    for mesh in (None, port_mesh(pod_shards, node_shards)):
        log = tseq.StepLog()
        cls(*chains, mesh=mesh, **kw)(tp, tn, te, log)
        logs.append([loop.steps for loop in log.loops])
    want = n_pods if lane == "exact" else -(-n_pods // 8)
    assert logs[1] == logs[0] == [want]


def test_eager_mesh_steps_keep_the_log(monkeypatch):
    """Over distinct devices a mesh scan's steps run eagerly, outside
    ``run_steps``: the log still gets the loop, with its steps and the
    ``select_hosts`` launches a step."""
    mesh = tsh.Mesh([[torch.device("cpu", 0), torch.device("cpu", 1)]])
    monkeypatch.setattr(tseq, "run_steps", None)  # not taken
    monkeypatch.setitem(kernels.launch_counts, "select_hosts", 0)
    state = {"i": torch.zeros((), dtype=torch.int64)}

    def step(st):
        kernels.launch_counts["select_hosts"] += 2
        st["i"] += 1

    log = tseq.StepLog()
    tsh._run_mesh_steps(mesh, step, state, 5, log)
    tsh._run_mesh_steps(mesh, step, state, 0, log)
    assert int(state["i"]) == 5
    [loop] = log.loops
    assert (loop.steps, loop.select_hosts_per_step) == (5, 2)
    assert loop.replays == 0  # no CUDA graph: nothing replayed


# ---------------------------------------------------------------------------
# a property test: every node-axis reduction merged
# ---------------------------------------------------------------------------


def _mixed_tables(n_nodes, n_pods, seed, node_cap, pod_cap):
    nodes, assigned, pods, pvcs, pvs = fullchain.mk_mixed_cluster(
        n_nodes, n_pods, seed)
    by_node = {}
    for p in assigned:
        by_node.setdefault(p.spec.node_name, []).append(p)
    tn, _ = ttables.build_node_table(nodes, by_node, capacity=node_cap,
                                     device="cpu")
    tp, _ = ttables.build_pod_table(pods, capacity=pod_cap, device="cpu")
    te = tconstraints.build_constraint_tables(
        pods, nodes, assigned, pod_capacity=pod_cap, node_capacity=node_cap,
        pvcs=pvcs, pvs=pvs, device="cpu")
    return tn, tp, te


_FULL = build_plugins(tconfig.default_full_roster_config())
_FULL_WEIGHTS = tconfig.default_full_roster_config().score_weights()


@settings(max_examples=8, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(shape=st.sampled_from(MESHES + [(1, 2)]),
       live_rows=st.integers(1, 6), n_pods=st.integers(20, 70),
       seed=st.integers(0, 2**16))
def test_property_mesh_matches_mesh_off(shape, live_rows, n_pods, seed):
    """The mixed cluster (every full-roster feature: zone and hostname
    spread and (anti-)affinity, images, ports, taints, node affinity,
    volumes) in a full-roster repair wave with diagnostics: the mesh
    places bit-identically to the mesh-off path, with node counts that
    leave the last node shard ``live_rows`` live rows and the rest
    padding.  A node-axis reduction left unmerged changes some pod."""
    pod_shards, node_shards = shape
    node_cap = tsh.cap_multiple(128, node_shards) * (
        2 if node_shards > 1 else 1)
    width = node_cap // node_shards
    n_nodes = node_cap - width + live_rows if node_shards > 1 else live_rows * 8
    pod_cap = tsh.cap_multiple(128, pod_shards)
    tn, tp, te = _mixed_tables(n_nodes, n_pods, seed, node_cap, pod_cap)
    ev = trepair.RepairingEvaluator(_FULL.filter, _FULL.pre_score,
                                    _FULL.score, weights=_FULL_WEIGHTS,
                                    with_diagnostics=True)
    mev = trepair.RepairingEvaluator(_FULL.filter, _FULL.pre_score,
                                     _FULL.score, weights=_FULL_WEIGHTS,
                                     with_diagnostics=True,
                                     mesh=port_mesh(pod_shards, node_shards))
    want, got = ev(tp, tn, te), mev(tp, tn, te)
    assert torch.equal(got.choice, want.choice)
    assert got.rounds == want.rounds
    assert torch.equal(got.unschedulable, want.unschedulable)
    assert_port_tables_equal(got.node_table, want.node_table)
    ctx = BatchContext(weights=tuple(sorted(_FULL_WEIGHTS.items())))
    one = evaluate(tp, tn, _FULL.filter, _FULL.pre_score, _FULL.score, ctx,
                   extra=te)
    _, choice, best = tsh.sharded_wave_step(
        port_mesh(pod_shards, node_shards), _FULL.filter, _FULL.pre_score,
        _FULL.score, ctx)(tp, tn, te)
    assert torch.equal(choice, one.choice)
    assert torch.equal(best, one.best_score)


@pytest.fixture(scope="module")
def blocked_case():
    """The sequential tests' mixed cluster (every cross-pod and volume
    feature, hostname and zone keys) with its scan-plane tables, and the
    port's mesh-off blocked lane over it (held against JAX's in
    ``tests/test_torch_blocked_scan.py``)."""
    from minisched_tpu.models.constraints import build_constraint_tables

    from tests.test_torch_crosspod import by_node
    from tests.test_torch_sequential import _mixed_cluster, to_port

    nodes, assigned, pods, pvcs, pvs = _mixed_cluster(random.Random(2024),
                                                      32, 24, 120)
    nodes = sorted(nodes, key=lambda n: n.metadata.name)
    # 384 node rows: whole rows on 1, 2, 3, 4 and 8 node shards
    jn, _ = jtables.build_node_table(nodes, by_node(assigned), capacity=384)
    jp, _ = jtables.build_pod_table(pods)
    je = build_constraint_tables(pods, nodes, assigned,
                                 pod_capacity=jp.capacity,
                                 node_capacity=jn.capacity, pvcs=pvcs,
                                 pvs=pvs)
    return to_port(jn, jp, je)


@pytest.mark.parametrize("pod_shards, node_shards", MESHES + [(1, 2)],
                         ids=MESH_IDS + ["1x2"])
def test_blocked_lane_in_the_scan_layout(pod_shards, node_shards,
                                         blocked_case):
    """``BlockedSequentialScheduler(mesh=)``: blocks of 8 over the node
    shards, the accept rule on the gathered node columns, commits where
    the node lives: choices, best scores, accepted masks and the final
    node table equal to the mesh-off lane."""
    tn, tp, te = blocked_case
    chains = (_FULL.filter, _FULL.pre_score, _FULL.score)
    want = tseq.BlockedSequentialScheduler(
        *chains, _FULL_WEIGHTS, block_size=8)(tp, tn, te)
    got = tseq.BlockedSequentialScheduler(
        *chains, _FULL_WEIGHTS, block_size=8,
        mesh=port_mesh(pod_shards, node_shards))(tp, tn, te)
    for k in (1, 2, 3):
        assert torch.equal(got[k], want[k]), k
    assert_port_tables_equal(got[0], want[0])
    assert int(want[3].sum()) > 0
