"""The port's volume plugins and the repair loop's volume carry against
the JAX package's.

* Every volume plugin's ``batch_filter`` on the seeded clusters of
  ``tests/test_torch_constraints.py`` (bound, unbound, missing and
  dangling claims, shared read-only and writable mounts, all four driver
  families), as built and with the carried planes changed (as the repair
  loop changes them), at the default limits and at small ones.
* ``accept_placements`` with the volume-limit and VolumeRestrictions
  rules, on random choices.
* The repair-carry and chain cases of ``tests/test_volume_roster.py``
  and ``tests/test_volume_plugins.py`` (family limits, a volume shared by
  two claims counting once, intra-wave restriction conflicts, read-only
  sharing, a claim bound to a missing PV, the runner-up after a node's
  limit fills), each run through both packages from each package's own
  objects: equal choices, rounds, unschedulable masks and final tables,
  and the case's own expectation.

Tolerance 0: integers and bools.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from minisched_tpu.api import objects as jobj
from minisched_tpu.models import constraints as jconstraints
from minisched_tpu.models import tables as jtables
from minisched_tpu.ops import fused as jfused
from minisched_tpu.ops import repair as jrepair
from minisched_tpu.ops.fused import BatchContext as JBatchContext
from minisched_tpu.plugins import nodeunschedulable as jnodeunschedulable
from minisched_tpu.plugins import volumebinding as jvolumebinding
from minisched_tpu.plugins import volumelimits as jvolumelimits
from minisched_tpu.plugins import volumerestrictions as jvolumerestrictions
from minisched_tpu.plugins import volumezone as jvolumezone

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.models import constraints as tconstraints
from minisched_tpu_torch.models import tables as ttables
from minisched_tpu_torch.ops import fused as tfused
from minisched_tpu_torch.ops import repair as trepair
from minisched_tpu_torch.plugins import nodeunschedulable as tnodeunschedulable
from minisched_tpu_torch.plugins import volumebinding as tvolumebinding
from minisched_tpu_torch.plugins import volumelimits as tvolumelimits
from minisched_tpu_torch.plugins import volumerestrictions as tvolumerestrictions
from minisched_tpu_torch.plugins import volumezone as tvolumezone

from tests.test_torch_constraints import GI, ZONE_KEY, constraint_cluster
from tests.test_torch_crosspod import both_waves, by_node
from tests.test_torch_tables import assert_tables_equal

JAX_MODULES = (jnodeunschedulable, jvolumebinding, jvolumelimits,
               jvolumerestrictions, jvolumezone)
PORT_MODULES = (tnodeunschedulable, tvolumebinding, tvolumelimits,
                tvolumerestrictions, tvolumezone)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs test files on parallel workers: this file's torch
    work keeps to two threads so it does not crowd the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def plugin(modules, name: str, **kw):
    """The plugin class ``name`` of one package, built with ``kw``."""
    for mod in modules:
        if hasattr(mod, name):
            return getattr(mod, name)(**kw)
    raise KeyError(name)


VOLUME_FILTERS = [("VolumeBinding", {}), ("VolumeZone", {}),
                  ("VolumeRestrictions", {}), ("NodeVolumeLimits", {}),
                  ("EBSLimits", {}), ("GCEPDLimits", {}),
                  ("AzureDiskLimits", {}), ("NodeVolumeLimits", {"max_volumes": 2}),
                  ("EBSLimits", {"max_volumes": 1}),
                  ("GCEPDLimits", {"max_volumes": 1}),
                  ("AzureDiskLimits", {"max_volumes": 2})]
VOLUME_IDS = [name + (f"-max{kw['max_volumes']}" if kw else "")
              for name, kw in VOLUME_FILTERS]


@pytest.fixture(scope="module")
def volume_waves():
    return {seed: both_waves(*constraint_cluster(jobj, seed))
            for seed in (1, 7)}


def _carried_change(extra, to_jax: bool, seed: int):
    """``extra`` with its carried planes changed at random, as the repair
    loop's commits change them (same change for both packages)."""
    rng = np.random.default_rng(seed)
    va = np.asarray(extra.vol_any if to_jax else extra.vol_any.numpy())
    shape = va.shape
    vol_any = va | (rng.random(shape) < 0.2)
    vol_rw = vol_any & (rng.random(shape) < 0.5)
    fam = np.asarray(extra.node_vols_fam if to_jax else extra.node_vols_fam.numpy())
    node_vols_fam = fam + rng.integers(0, 3, size=fam.shape, dtype=np.int32)
    if to_jax:
        import jax.numpy as jnp

        return dataclasses.replace(extra, vol_any=jnp.asarray(vol_any),
                                   vol_rw=jnp.asarray(vol_rw),
                                   node_vols_fam=jnp.asarray(node_vols_fam))
    return dataclasses.replace(extra, vol_any=torch.from_numpy(vol_any),
                               vol_rw=torch.from_numpy(vol_rw),
                               node_vols_fam=torch.from_numpy(node_vols_fam))


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("name,kw", VOLUME_FILTERS, ids=VOLUME_IDS)
def test_volume_filter_matches_jax(name, kw, carried, seed, volume_waves):
    (jn, jp, je), (tn, tp, te) = volume_waves[seed]
    if carried:
        je, te = _carried_change(je, True, seed), _carried_change(te, False, seed)
    want = np.asarray(plugin(JAX_MODULES, name, **kw).batch_filter(
        JBatchContext(), jp, jn, je))
    got = plugin(PORT_MODULES, name, **kw).batch_filter(
        tfused.BatchContext(), tp, tn, te)
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    live = want[: 60]
    assert live.any()
    if not name.endswith("Limits") or (kw and carried):
        assert not live.all()


def test_plugin_markers_match_jax():
    """What the repair loop and the static split read off each plugin."""
    for name, kw in VOLUME_FILTERS:
        jpl = plugin(JAX_MODULES, name, **kw)
        tpl = plugin(PORT_MODULES, name, **kw)
        for attr in ("reads_committed_state", "needs_extra",
                     "enforces_volume_restrictions"):
            assert (bool(getattr(tpl, attr, False))
                    == bool(getattr(jpl, attr, False))), (name, attr)
        for attr in ("volume_family_index", "max_volumes"):
            assert getattr(tpl, attr, None) == getattr(jpl, attr, None), (
                name, attr)
    assert tvolumelimits.FAMILIES == jvolumelimits.FAMILIES


@pytest.mark.parametrize("seed", range(4))
def test_accept_placements_volume_rules_match_jax(seed):
    """Family prefix limits and the same-round mount rule, on random
    choices over a few nodes (with ports and resources checked too)."""
    rng = np.random.default_rng(seed)
    nodes = [jobj.make_node(f"n{i}", capacity={"cpu": "4", "memory": "8Gi",
                                               "pods": 20}) for i in range(5)]
    pods = [jobj.make_pod(f"p{i}", requests={"cpu": f"{rng.integers(0, 900)}m"})
            for i in range(80)]
    jn, _ = jtables.build_node_table(nodes)
    jp, _ = jtables.build_pod_table(pods, capacity=len(pods))
    tn, tp = ttables.tables_from_numpy(
        {f.name: np.asarray(getattr(jn, f.name)) for f in dataclasses.fields(jn)},
        {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)},
        "cpu")
    P, V, rows = len(pods), 4, 9
    choice = rng.integers(-1, 5, size=P).astype(np.int32)
    active = rng.random(P) < 0.85
    pod_vol = np.where(rng.random((P, V)) < 0.5,
                       rng.integers(0, rows - 1, size=(P, V)), -1).astype(np.int32)
    pod_ro = rng.random((P, V)) < 0.5
    fam_amt = rng.integers(0, 3, size=(2, P)).astype(np.int32)
    node_count = rng.integers(0, 4, size=(2, 5)).astype(np.int32)
    for kw in ({}, {"check_resources": False, "check_ports": False}):
        want = np.asarray(jrepair.accept_placements(
            jn, jp, choice, active, **kw,
            vol_state=[(fam_amt[0], node_count[0], 5), (fam_amt[1], node_count[1], 3)],
            restr_state=(pod_vol, pod_ro, rows)))
        got = trepair.accept_placements(
            tn, tp, torch.from_numpy(choice), torch.from_numpy(active), **kw,
            vol_state=[(torch.from_numpy(fam_amt[f]), torch.from_numpy(node_count[f]), mx)
                       for f, mx in ((0, 5), (1, 3))],
            restr_state=(torch.from_numpy(pod_vol), torch.from_numpy(pod_ro), rows))
        np.testing.assert_array_equal(got.numpy(), want)
        live = active & (choice >= 0)
        assert 0 < want.sum() < live.sum()
        only = np.asarray(jrepair.accept_placements(
            jn, jp, choice, active, check_resources=False, check_ports=False,
            restr_state=(pod_vol, pod_ro, rows)))
        got = trepair.accept_placements(
            tn, tp, torch.from_numpy(choice), torch.from_numpy(active),
            check_resources=False, check_ports=False,
            restr_state=(torch.from_numpy(pod_vol), torch.from_numpy(pod_ro), rows))
        np.testing.assert_array_equal(got.numpy(), only)


# ---------------------------------------------------------------------------
# the repair-carry and chain cases, through both packages
# ---------------------------------------------------------------------------


def _pv(objs, name, capacity=GI, claim="", labels=None, node_labels=None,
        driver=""):
    return objs.PersistentVolume(
        metadata=objs.ObjectMeta(name=name, namespace="", labels=dict(labels or {})),
        spec=objs.PVSpec(capacity=capacity, claim_ref=claim, driver=driver,
                         required_node_labels=dict(node_labels or {})))


def _pvc(objs, name, request=GI, volume="", read_only=False):
    return objs.PersistentVolumeClaim(
        metadata=objs.ObjectMeta(name=name),
        spec=objs.PVCSpec(request=request, volume_name=volume,
                          read_only=read_only))


def _assigned(objs, name, node, volumes=()):
    p = objs.make_pod(name, volumes=list(volumes))
    p.metadata.uid = name
    p.spec.node_name = node
    return p


def case_roster_chain(objs):
    """test_volume_roster.py: test_batch_parity_volume_roster_chain."""
    nodes = [objs.make_node("a", labels={ZONE_KEY: "zone-a"}),
             objs.make_node("b", labels={ZONE_KEY: "zone-b"}),
             objs.make_node("c", labels={ZONE_KEY: "zone-a"})]
    assigned = [_assigned(objs, "holder-disk", "a", ["shared"]),
                _assigned(objs, "holder-ebs", "c", ["ebs-held"])]
    pvs = [_pv(objs, "disk", claim="default/shared", labels={ZONE_KEY: "zone-a"}),
           _pv(objs, "zoned-b", claim="default/in-b", labels={ZONE_KEY: "zone-b"}),
           _pv(objs, "ebs1", claim="default/ebs-held", driver="ebs"),
           _pv(objs, "ebs2", claim="default/ebs-new", driver="ebs"),
           _pv(objs, "shared2", claim="default/shared-again",
               labels={ZONE_KEY: "zone-a"})]
    pvcs = [_pvc(objs, "shared", volume="disk"),
            _pvc(objs, "shared-again", volume="disk"),
            _pvc(objs, "in-b", volume="zoned-b"),
            _pvc(objs, "ebs-held", volume="ebs1"),
            _pvc(objs, "ebs-new", volume="ebs2")]
    pods = [objs.make_pod("p-conflict", volumes=["shared-again"]),
            objs.make_pod("p-zoneb", volumes=["in-b"]),
            objs.make_pod("p-ebs", volumes=["ebs-new"]),
            objs.make_pod("p-free")]
    chain = [("NodeUnschedulable", {}), ("VolumeRestrictions", {}),
             ("EBSLimits", {"max_volumes": 1}), ("NodeVolumeLimits", {}),
             ("VolumeBinding", {}), ("VolumeZone", {})]

    def check(names):
        assert names[0] == "c" and names[1] == "b" and names[2] in ("a", "b")
    return nodes, assigned, pods, pvcs, pvs, chain, check


def case_family_limits(objs):
    """test_volume_roster.py: test_repair_respects_family_limits."""
    nodes = [objs.make_node("n1"), objs.make_node("n2")]
    pvs = [_pv(objs, f"pve{i}", claim=f"default/e{i}", driver="ebs")
           for i in range(4)]
    pvcs = [_pvc(objs, f"e{i}", volume=f"pve{i}") for i in range(4)]
    pods = [objs.make_pod(f"p{i}", volumes=[f"e{i}"]) for i in range(4)]
    chain = [("NodeUnschedulable", {}), ("VolumeBinding", {}),
             ("EBSLimits", {"max_volumes": 2})]

    def check(names):
        assert "" not in names and max(names.count(n) for n in names) == 2
    return nodes, [], pods, pvcs, pvs, chain, check


def case_shared_counts_once(objs):
    """test_volume_roster.py: test_shared_volume_counts_once_scalar_and_batch."""
    nodes = [objs.make_node("n1")]
    assigned = [_assigned(objs, "holder", "n1", ["c-held"])]
    pvs = [_pv(objs, "shared-pv", claim="default/c-held"),
           _pv(objs, "other-pv", claim="default/c-new")]
    pvcs = [_pvc(objs, "c-held", volume="shared-pv", read_only=True),
            _pvc(objs, "c-same", volume="shared-pv", read_only=True),
            _pvc(objs, "c-new", volume="other-pv")]
    pods = [objs.make_pod("p", volumes=["c-same"]),
            objs.make_pod("q", volumes=["c-new"])]
    chain = [("NodeVolumeLimits", {"max_volumes": 1})]

    def check(names):
        assert names == ["n1", ""]
    return nodes, assigned, pods, pvcs, pvs, chain, check


def case_restriction_conflict(objs):
    """test_volume_roster.py: test_repair_enforces_intra_wave_restriction_conflicts."""
    nodes = [objs.make_node("n1")]
    pvs = [_pv(objs, "disk", claim="default/c1")]
    pvcs = [_pvc(objs, "c1", volume="disk"), _pvc(objs, "c2", volume="disk")]
    pods = [objs.make_pod("p1", volumes=["c1"]), objs.make_pod("p2", volumes=["c2"])]
    chain = [("NodeUnschedulable", {}), ("VolumeRestrictions", {})]

    def check(names):
        assert names == ["n1", ""]
    return nodes, [], pods, pvcs, pvs, chain, check


def case_read_only_share(objs):
    """test_volume_roster.py: test_repair_intra_wave_read_only_mounts_share."""
    nodes = [objs.make_node("n1"), objs.make_node("n2")]
    pvs = [_pv(objs, "disk", claim="default/ro1")]
    pvcs = [_pvc(objs, "ro1", volume="disk", read_only=True),
            _pvc(objs, "ro2", volume="disk", read_only=True),
            _pvc(objs, "rw", volume="disk")]
    pods = [objs.make_pod("a-ro1", volumes=["ro1"]),
            objs.make_pod("b-ro2", volumes=["ro2"]),
            objs.make_pod("c-rw", volumes=["rw"])]
    chain = [("NodeUnschedulable", {}), ("VolumeRestrictions", {})]

    def check(names):
        assert "" not in names and names[0] == names[1] != names[2]
    return nodes, [], pods, pvcs, pvs, chain, check


def case_volume_chain(objs):
    """test_volume_plugins.py: test_batch_parity_volume_chain."""
    nodes = [objs.make_node("a", labels={"zone": "a"}),
             objs.make_node("b", labels={"zone": "b"})]
    pvs = [_pv(objs, "pv-a", claim="default/bound-a", node_labels={"zone": "a"}),
           _pv(objs, "free-b", capacity=2 * GI, node_labels={"zone": "b"})]
    pvcs = [_pvc(objs, "bound-a", volume="pv-a"), _pvc(objs, "loose")]
    pods = [objs.make_pod("p-bound", volumes=["bound-a"]),
            objs.make_pod("p-loose", volumes=["loose"]),
            objs.make_pod("p-ghost", volumes=["nope"]),
            objs.make_pod("p-free")]
    chain = [("NodeUnschedulable", {}), ("VolumeBinding", {}),
             ("NodeVolumeLimits", {})]

    def check(names):
        assert names[:3] == ["a", "b", ""] and names[3]
    return nodes, [], pods, pvcs, pvs, chain, check


def case_missing_pv(objs):
    """test_volume_plugins.py: test_claim_bound_to_missing_pv_unschedulable_in_both_paths."""
    nodes = [objs.make_node("n1")]
    pvcs = [_pvc(objs, "orphan", volume="gone")]
    pods = [objs.make_pod("p", volumes=["orphan"])]
    chain = [("VolumeBinding", {})]

    def check(names):
        assert names == [""]
    return nodes, [], pods, pvcs, [], chain, check


def case_limit_rounds(objs):
    """test_volume_plugins.py: test_repair_rounds_respect_volume_limits."""
    nodes = [objs.make_node("n1")]
    pvcs = [_pvc(objs, f"v{i}", volume=f"pv{i}") for i in range(10)]
    pvs = [_pv(objs, f"pv{i}", claim=f"default/v{i}") for i in range(10)]
    pods = [objs.make_pod(f"p{i}", volumes=[f"v{2 * i}", f"v{2 * i + 1}"])
            for i in range(5)]
    chain = [("NodeUnschedulable", {}), ("VolumeBinding", {}),
             ("NodeVolumeLimits", {"max_volumes": 4})]

    def check(names):
        assert sum(1 for n in names if n) == 2
    return nodes, [], pods, pvcs, pvs, chain, check


def case_runner_up(objs):
    """test_volume_plugins.py: test_repair_moves_to_runner_up_when_volumes_fill."""
    nodes = [objs.make_node("n1"), objs.make_node("n2")]
    pvcs = [_pvc(objs, f"v{i}", volume=f"pv{i}") for i in range(3)]
    pvs = [_pv(objs, f"pv{i}", claim=f"default/v{i}") for i in range(3)]
    pods = [objs.make_pod(f"p{i}", volumes=[f"v{i}"]) for i in range(3)]
    chain = [("NodeUnschedulable", {}), ("VolumeBinding", {}),
             ("NodeVolumeLimits", {"max_volumes": 2})]

    def check(names):
        assert "" not in names and len(set(names)) == 2
    return nodes, [], pods, pvcs, pvs, chain, check


CASES = {
    "roster_chain": (case_roster_chain, "fused"),
    "roster_chain_repair": (case_roster_chain, "repair"),
    "family_limits": (case_family_limits, "repair"),
    "shared_counts_once": (case_shared_counts_once, "fused"),
    "restriction_conflict": (case_restriction_conflict, "repair"),
    "read_only_share": (case_read_only_share, "repair"),
    "volume_chain": (case_volume_chain, "fused"),
    "missing_pv": (case_missing_pv, "fused"),
    "limit_rounds": (case_limit_rounds, "repair"),
    "runner_up": (case_runner_up, "repair"),
}


def _run(pkg: str, case, mode: str):
    """One package's run of a case, from its own objects: (names, choice,
    rounds, unschedulable masks, node table)."""
    objs = jobj if pkg == "jax" else tobj
    nodes, assigned, pods, pvcs, pvs, spec, _ = case(objs)
    nodes = sorted(nodes, key=lambda n: n.metadata.name)
    modules = JAX_MODULES if pkg == "jax" else PORT_MODULES
    chain = [plugin(modules, name, **kw) for name, kw in spec]
    if pkg == "jax":
        nt, names = jtables.build_node_table(nodes, by_node(assigned))
        pt, _ = jtables.build_pod_table(pods)
        extra = jconstraints.build_constraint_tables(
            pods, nodes, assigned, pod_capacity=pt.capacity,
            node_capacity=nt.capacity, pvcs=pvcs, pvs=pvs)
        ev = (jfused.FusedEvaluator(chain, [], []) if mode == "fused" else
              jrepair.RepairingEvaluator(chain, [], [], with_diagnostics=True))
    else:
        nt, names = ttables.build_node_table(nodes, by_node(assigned),
                                             device="cpu")
        pt, _ = ttables.build_pod_table(pods, device="cpu")
        extra = tconstraints.build_constraint_tables(
            pods, nodes, assigned, pod_capacity=pt.capacity,
            node_capacity=nt.capacity, pvcs=pvcs, pvs=pvs, device="cpu")
        ev = (tfused.FusedEvaluator(chain, [], []) if mode == "fused" else
              trepair.RepairingEvaluator(chain, [], [], with_diagnostics=True))
    out = ev(pt, nt, extra)
    if mode == "fused":
        choice, rounds, unsched, table = out.choice, 1, None, None
    else:
        table, choice, rounds, unsched = out[:4]
    choice = np.asarray(choice)[: len(pods)]
    return ([names[c] if c >= 0 else "" for c in choice], choice, int(rounds),
            None if unsched is None else np.asarray(unsched), table)


@pytest.mark.parametrize("name", list(CASES))
def test_volume_case_matches_jax(name):
    case, mode = CASES[name]
    got = _run("port", case, mode)
    want = _run("jax", case, mode)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    if mode == "repair":
        np.testing.assert_array_equal(got[3], want[3])
        assert_tables_equal(got[4], want[4])
    case(tobj)[-1](got[0])  # the case's own expectation


def test_repair_carries_the_committed_volume_state():
    """The carried planes out of a repair wave: every committed pod's
    counting rows marked on its node, its writable bound mounts in
    vol_rw, and its new attachments counted once per family."""
    nodes, assigned, pods, pvcs, pvs = constraint_cluster(tobj, 7,
                                                          requests={"cpu": "2"})
    nodes = sorted(nodes, key=lambda n: n.metadata.name)
    nt, _ = ttables.build_node_table(nodes, by_node(assigned), device="cpu")
    pt, _ = ttables.build_pod_table(pods, device="cpu")
    extra = tconstraints.build_constraint_tables(
        pods, nodes, assigned, pod_capacity=pt.capacity,
        node_capacity=nt.capacity, pvcs=pvcs, pvs=pvs, device="cpu")
    chain = [plugin(PORT_MODULES, name) for name in (
        "NodeUnschedulable", "VolumeRestrictions", "EBSLimits",
        "NodeVolumeLimits", "VolumeBinding")]
    _, choice, rounds, _, carried = trepair.RepairingEvaluator(chain, [], [])(
        pt, nt, extra)
    placed = choice[: len(pods)] >= 0
    assert placed.any() and rounds >= 1
    from minisched_tpu_torch.ops.state import mount_slot_planes

    slot_cnt, slot_vol, slot_ro, _, _ = mount_slot_planes(extra)
    va, vr = carried.vol_any, carried.vol_rw
    for p in np.flatnonzero(placed.numpy()):
        n = int(choice[p])
        for j in range(4):
            if slot_cnt[p, j] >= 0:
                assert va[slot_cnt[p, j], n]
            if slot_vol[p, j] >= 0 and not slot_ro[p, j]:
                assert vr[slot_vol[p, j], n]
    assert (carried.node_vols_fam >= extra.node_vols_fam).all()
    assert (carried.node_vols_fam > extra.node_vols_fam).any()
