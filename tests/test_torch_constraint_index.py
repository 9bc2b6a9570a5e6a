"""The port's ``ConstraintIndex`` against the walk and the JAX package.

After ``tests/test_constraint_index.py``: the tables assembled from the
index (``build_constraint_tables(index=, extra_assigned=)``) equal the
tables walked from every assigned pod, and both equal the JAX package's,
through churn (deletes, new binds, a pod relabelled, a node label move, a
claim binding to a new PV), with assumed pods folded in, and when a later wave brings a
selector that must be backfilled over the pods already held.  The index
is driven by its direct methods on both sides (the JAX index's informer
wiring is not used), with the same lookups.

Between the index and the walk two axes are compared as sets: the
ex-term rows (``ex_domain``, ``pod_matches_ex``), and the combos that
only assigned pods' scoring terms bring (after churn the index holds
them in another order than the assigned pods').  A combo is compared by
its planes and its pod-match column, and each pod's constraint slots by
the combos they name; every consumer reads a combo through those ids or
reduces over the axis.  Index against JAX index, and walk against JAX
walk, are compared exactly.

The port keys a pod with an empty uid by ``namespace/name``: two such
pods count twice.  Tolerance 0.
"""

from __future__ import annotations

import copy
import random

import numpy as np

from minisched_tpu.api import objects as jobj
from minisched_tpu.models import constraint_index as jindex
from minisched_tpu.models import constraints as jconstraints

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.headline import ConstraintFeed
from minisched_tpu_torch.models import constraint_index as tindex
from minisched_tpu_torch.models import constraints as tconstraints
from minisched_tpu_torch.models.tables import pad_to

#: combo-indexed columns: rows, the pod-match columns, the slot values
COMBO_ROWS = ("combo_key", "combo_haskey", "combo_dsum", "combo_here",
              "combo_global", "rev_weight", "combo_excl")
COMBO_SLOTS = (("ts", "ts_combo", ("ts_skew", "ts_mode")),
               ("pa", "pa_combo", ("pa_self",)), ("pan", "pan_combo", ()),
               ("ppa", "ppa_combo", ("ppa_w",)))
ORDER_FREE = (("ex_domain", "pod_matches_ex", "pod_matches_combo")
              + COMBO_ROWS + tuple(slot for _, slot, _ in COMBO_SLOTS))


def _pending(objs, rng, n):
    pods = []
    for i in range(n):
        app = f"app{rng.randrange(4)}"
        sel = objs.LabelSelector(match_labels={"app": app})
        pod = objs.make_pod(f"pend{i:03d}", labels={"app": app})
        pod.spec.topology_spread_constraints = [objs.TopologySpreadConstraint(
            max_skew=2, topology_key="zone",
            when_unsatisfiable="DoNotSchedule", label_selector=sel)]
        pod.spec.affinity = objs.Affinity(
            pod_affinity=objs.PodAffinity(required=[objs.PodAffinityTerm(
                label_selector=sel, topology_key="zone")]),
            pod_anti_affinity=objs.PodAntiAffinity(required=[
                objs.PodAffinityTerm(label_selector=objs.LabelSelector(
                    match_labels={"app": f"app{(i + 1) % 4}"}),
                    topology_key="zone")]))
        if i % 3 == 0:
            pod.spec.volumes = [f"claim{i % 6}"]
        pods.append(pod)
    return pods


def _assigned(objs, rng, i, nodes, uid=True):
    p = objs.make_pod(f"asg{i:04d}", labels={"app": f"app{rng.randrange(4)}"})
    if uid:
        p.metadata.uid = f"uid-asg{i:04d}"
    if i % 4 == 0:
        p.spec.affinity = objs.Affinity(
            pod_anti_affinity=objs.PodAntiAffinity(required=[
                objs.PodAffinityTerm(label_selector=objs.LabelSelector(
                    match_labels={"app": f"app{rng.randrange(4)}"}),
                    topology_key="zone")]),
            pod_affinity=objs.PodAffinity(preferred=[
                objs.WeightedPodAffinityTerm(rng.randrange(1, 50),
                                             objs.PodAffinityTerm(
                    label_selector=objs.LabelSelector(
                        match_labels={"app": f"app{rng.randrange(4)}"}),
                    topology_key="zone"))]))
    if i % 5 == 0:
        p.spec.volumes = [f"claim{rng.randrange(6)}", "nosuchclaim"][: 1 + i % 2]
    p.spec.node_name = rng.choice(nodes).metadata.name
    return p


class Side:
    """One package's cluster, its index and its lookups."""

    def __init__(self, objs, index_mod, seed, n_nodes, n_assigned, uid=True):
        self.objs, self.rng = objs, random.Random(seed)
        self.nodes = [objs.make_node(f"node{i:03d}",
                                     labels={"zone": f"z{i % 5}"})
                      for i in range(n_nodes)]
        self.by_name = {n.metadata.name: n for n in self.nodes}
        self.pvcs, self.pvs = {}, {}
        for i in range(6):
            pvc = objs.PersistentVolumeClaim(
                metadata=objs.ObjectMeta(name=f"claim{i}"), spec=objs.PVCSpec())
            if i % 2 == 0:
                pvc.spec.volume_name = f"pv{i}"
                self.pvs[f"pv{i}"] = objs.PersistentVolume(
                    metadata=objs.ObjectMeta(name=f"pv{i}", namespace=""),
                    spec=objs.PVSpec(driver=["", "ebs", "gcepd"][i % 3]))
            self.pvcs[pvc.metadata.key] = pvc
        self.assigned = [_assigned(objs, self.rng, i, self.nodes, uid)
                         for i in range(n_assigned)]
        if index_mod is tindex:
            self.index = tindex.ConstraintIndex(
                node_get=self.by_name.get, pvc_get=self.pvcs.get,
                pv_get=self.pvs.get)
        else:
            self.index = jindex.ConstraintIndex()
            self.index._node_get = self.by_name.get
            self.index._pvc_lister = self.pvcs.get
            self.index._pv_lister = self.pvs.get
        for p in self.assigned:
            self.index.add_pod(p)

    def columns(self, pending, extra=(), index=True):
        kw = dict(pod_capacity=pad_to(len(pending)),
                  node_capacity=pad_to(len(self.nodes)),
                  pvcs=list(self.pvcs.values()), pvs=list(self.pvs.values()),
                  scan_planes=True)
        if self.objs is tobj:
            if index:
                return tconstraints.constraint_columns(
                    pending, self.nodes, (), index=self.index,
                    extra_assigned=extra, **kw)
            return tconstraints.constraint_columns(
                pending, self.nodes, self.assigned + list(extra), **kw)
        if index:
            t = jconstraints.build_constraint_tables(
                pending, self.nodes, (), index=self.index,
                extra_assigned=extra, **kw)
        else:
            t = jconstraints.build_constraint_tables(
                pending, self.nodes, self.assigned + list(extra), **kw)
        return {f: np.asarray(getattr(t, f)) for f in t.__dataclass_fields__}


def _canon_ex(cols):
    ex, pm = cols["ex_domain"], cols["pod_matches_ex"]
    return sorted((ex[i].tobytes(), pm[:, i].tobytes())
                  for i in range(ex.shape[0]) if ex[i].any() or pm[:, i].any())


def _canon_combos(cols):
    """Order-free form of the combos: each combo's planes and pod-match
    column, and each pod row's slots by the combo they name."""
    sig = [tuple(cols[f][c].tobytes() for f in COMBO_ROWS)
           + (cols["pod_matches_combo"][:, c].tobytes(),)
           for c in range(cols["combo_key"].shape[0])]
    slots = [tuple((kind, sig[cols[slot][p, j]])
                   + tuple(cols[f][p, j].item() for f in extra)
                   for kind, slot, extra in COMBO_SLOTS
                   for j in range(cols[f"{kind}_n"][p]))
             for p in range(cols["ts_n"].shape[0])]
    return sorted(sig), slots


def assert_columns_equal(got, want, order_free=False):
    assert set(got) == set(want)
    for name in want:
        if order_free and name in ORDER_FREE:
            continue
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if order_free:
        assert _canon_ex(got) == _canon_ex(want), "ex-term planes differ"
        assert _canon_combos(got) == _canon_combos(want), "combos differ"


def assert_all_equal(port, jax_, pending, jpending, extra=(), jextra=()):
    """Index = walk (ex planes as row sets) on the port; index = JAX index
    and walk = JAX walk exactly."""
    t_index = port.columns(pending, extra)
    t_walk = port.columns(pending, extra, index=False)
    assert_columns_equal(t_index, t_walk, order_free=True)
    assert_columns_equal(t_index, jax_.columns(jpending, jextra))
    assert_columns_equal(t_walk, jax_.columns(jpending, jextra, index=False))
    return t_index


def _sides(seed, n_nodes, n_assigned):
    return (Side(tobj, tindex, seed, n_nodes, n_assigned),
            Side(jobj, jindex, seed, n_nodes, n_assigned))


def test_index_matches_walk_and_jax_through_churn():
    port, jax_ = _sides(42, 40, 120)
    pending = _pending(tobj, random.Random(1), 24)
    jpending = _pending(jobj, random.Random(1), 24)
    cols = assert_all_equal(port, jax_, pending, jpending)
    assert cols["combo_global"].any() and cols["ex_domain"].any()
    assert cols["rev_weight"].any() and cols["node_vols_fam"].any()
    for side in (port, jax_):
        # deletes, new binds
        for i in range(0, 40, 4):
            gone = side.assigned[i]
            side.index.delete_pod(gone)
        side.assigned = [p for k, p in enumerate(side.assigned)
                         if not (k < 40 and k % 4 == 0)]
        for i in range(120, 150):
            p = _assigned(side.objs, side.rng, i, side.nodes)
            side.assigned.append(p)
            side.index.add_pod(p)
        # a pod changes its labels in place
        old_pod = side.assigned[1]
        new_pod = copy.deepcopy(old_pod)
        new_pod.metadata.labels = {"app": "app3", "tier": "new"}
        side.assigned[1] = new_pod
        side.index.update_pod(old_pod, new_pod)
        # a node moves zone
        node = side.by_name["node003"]
        old = copy.deepcopy(node)
        node.metadata.labels["zone"] = "z9"
        side.index.update_node(old, node)
        # a claim binds to a new PV
        side.pvs["pvlate"] = side.objs.PersistentVolume(
            metadata=side.objs.ObjectMeta(name="pvlate", namespace=""),
            spec=side.objs.PVSpec(driver="ebs"))
        side.index.volume_changed("pvlate")
        side.pvcs["default/claim1"].spec.volume_name = "pvlate"
        side.index.claim_changed("default/claim1")
    assert len(port.index.assigned_keys()) == 140
    assert_all_equal(port, jax_, pending, jpending)
    # a selector first seen after the churn: backfilled over what is held
    late = []
    for objs in (tobj, jobj):
        pod = objs.make_pod("late", labels={"team": "x"})
        pod.spec.topology_spread_constraints = [objs.TopologySpreadConstraint(
            max_skew=1, topology_key="zone",
            when_unsatisfiable="ScheduleAnyway",
            label_selector=objs.LabelSelector())]
        late.append([pod])
    cols = assert_all_equal(port, jax_, late[0], late[1])
    assert cols["combo_global"][0] == 140


def test_index_folds_assumed_pods():
    port, jax_ = _sides(7, 12, 30)
    extras = []
    for side in (port, jax_):
        rng = random.Random(3)
        extra = []
        for i in range(100, 106):
            p = _assigned(side.objs, rng, i, side.nodes)
            p.metadata.uid = f"assumed-{i}"
            extra.append(p)
        extras.append(extra)
    cols = assert_all_equal(port, jax_, _pending(tobj, random.Random(2), 12),
                            _pending(jobj, random.Random(2), 12),
                            extras[0], extras[1])
    without = port.columns(_pending(tobj, random.Random(2), 12))
    assert not np.array_equal(cols["combo_here"], without["combo_here"])


def test_new_combo_backfills_the_pods_held():
    port, jax_ = _sides(9, 8, 40)
    assert_all_equal(port, jax_, _pending(tobj, random.Random(4), 4),
                     _pending(jobj, random.Random(4), 4))
    late = []
    for objs in (tobj, jobj):
        pod = objs.make_pod("late", labels={"team": "x"})
        pod.spec.topology_spread_constraints = [objs.TopologySpreadConstraint(
            max_skew=1, topology_key="zone",
            when_unsatisfiable="ScheduleAnyway",
            label_selector=objs.LabelSelector(match_labels={"app": "app2"}))]
        late.append([pod])
    cols = assert_all_equal(port, jax_, late[0], late[1])
    assert cols["combo_global"][0] > 0


def test_empty_uid_pods_count_apart():
    """Two pods with an empty uid (the port's default) on two nodes count
    twice, in the combo counts and in the per-mount keys of claims that do
    not exist; the same pod added twice counts once."""
    nodes = [tobj.make_node(f"n{i}", labels={"zone": "z0"}) for i in range(2)]
    pods = []
    for i in range(2):
        p = tobj.make_pod(f"web{i}", labels={"app": "web"}, volumes=["gone"])
        p.spec.node_name = nodes[i].metadata.name
        pods.append(p)
    assert all(p.metadata.uid == "" for p in pods)
    index = tindex.ConstraintIndex(node_get={n.metadata.name: n
                                             for n in nodes}.get)
    for p in pods + pods[:1]:
        index.add_pod(p)
    assert index.assigned_keys() == {"default/web0", "default/web1"}
    pending = tobj.make_pod("new", labels={"app": "web"})
    pending.spec.topology_spread_constraints = [tobj.TopologySpreadConstraint(
        max_skew=1, topology_key="zone",
        label_selector=tobj.LabelSelector(match_labels={"app": "web"}))]
    kw = dict(pod_capacity=128, node_capacity=128, scan_planes=True)
    got = tconstraints.constraint_columns([pending], nodes, (), index=index,
                                          **kw)
    want = tconstraints.constraint_columns([pending], nodes, pods, **kw)
    assert_columns_equal(got, want, order_free=True)
    assert got["combo_global"][0] == 2
    assert got["node_vols_fam"][:, :2].sum() == 2
    index.delete_pod(pods[0])
    assert index.assigned_keys() == {"default/web1"}


def test_feed_tables_equal_the_walk():
    """``ConstraintFeed`` (one index, fed with the assigned pods, then with
    each commit) builds the tables the walk of every assigned pod builds."""
    port = Side(tobj, tindex, 5, 24, 60, uid=False)
    feed = ConstraintFeed(port.nodes, [n.metadata.name for n in port.nodes],
                          port.assigned, list(port.pvcs.values()),
                          list(port.pvs.values()), pad_to(len(port.nodes)),
                          "cpu", scan_planes=True)
    rng = random.Random(8)
    for wave in range(3):
        pending = _pending(tobj, random.Random(wave), 16)
        for p in pending:  # one identity a pod: the index keys by name
            p.metadata.name = f"w{wave}-{p.metadata.name}"
        got = feed.tables(pending, 128)
        want = tconstraints.build_constraint_tables(
            pending, port.nodes, port.assigned, pod_capacity=128,
            node_capacity=pad_to(len(port.nodes)),
            pvcs=list(port.pvcs.values()), pvs=list(port.pvs.values()),
            scan_planes=True, device="cpu")
        assert_columns_equal(
            {f: getattr(got, f).numpy() for f in tconstraints._COLUMNS},
            {f: getattr(want, f).numpy() for f in tconstraints._COLUMNS},
            order_free=True)
        assert got.in_use == want.in_use
        rows = [rng.randrange(-1, len(port.nodes)) for _ in pending]
        feed.commit(pending, rows)
        port.assigned += [_placed(p, port.nodes[r].metadata.name)
                          for p, r in zip(pending, rows) if r >= 0]
    assert feed.build_s > 0


def _placed(pod, node_name):
    out = copy.copy(pod)
    out.spec = copy.copy(pod.spec)
    out.spec.node_name = node_name
    return out
