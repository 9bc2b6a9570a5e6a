"""The PyTorch port's tables against the JAX package's, column by column.

Every column the port builds (``minisched_tpu_torch.models.tables``) must
be byte-equal to the JAX table's: same names, shapes, dtypes and values.
The one deliberate difference is ``seed``: u32 in the JAX table, int32
holding the same bits in the port.  Inputs come from seeded generators;
the tolerance is zero (integer and bool columns).
"""

from __future__ import annotations

import random
from dataclasses import fields

import numpy as np
import pytest
import torch

from minisched_tpu.api import objects as jobj
from minisched_tpu.models import tables as jtables
from minisched_tpu import native as jnative

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.models import tables as ttables
from minisched_tpu_torch.utils import hashing


def jax_columns(table) -> dict:
    return {f.name: np.asarray(getattr(table, f.name)) for f in fields(table)}


def port_columns(table) -> dict:
    cols = {name: t.cpu().numpy() for name, t in ttables.table_columns(table).items()}
    if "seed" in cols:
        cols["seed"] = cols["seed"].view(np.uint32)
    return cols


def assert_tables_equal(port_table, jax_table) -> None:
    got, want = port_columns(port_table), jax_columns(jax_table)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        assert np.array_equal(got[name], want[name]), name


def _nodes(objs, rng: random.Random, n: int, rich: bool):
    """``n`` nodes built with the ``objs`` module (JAX or port objects)."""
    out = []
    for i in range(n):
        labels, taints, images = {}, [], {}
        if rich:
            if rng.random() < 0.5:
                labels = {"zone": f"z{rng.randrange(3)}",
                          "rank": str(rng.randrange(-5, 50))}
            if rng.random() < 0.3:
                labels["pool"] = rng.choice(["gpu", "cpu", "ünïcode"])
            if rng.random() < 0.3:
                taints = [objs.Taint(key="dedicated", value=rng.choice(["a", "b"]),
                                     effect=rng.choice(["NoSchedule", "NoExecute"]))]
            if rng.random() < 0.2:
                taints.append(objs.Taint(key="spot", effect="PreferNoSchedule"))
        node = objs.make_node(
            f"node-{i:03d}" if rng.random() < 0.9 else f"node-{i}x",
            unschedulable=rng.random() < 0.25,
            labels=labels,
            capacity={"cpu": str(rng.choice([2, 4, 8])), "memory": "16Gi",
                      "pods": rng.choice([32, 110]),
                      "ephemeral-storage": "100Gi"},
            taints=taints,
        )
        if rich and rng.random() < 0.3:
            images = {f"img{k}": rng.randrange(1, 900) * 1024 * 1024
                      for k in range(rng.randrange(1, 4))}
            node.status.images = images
        out.append(node)
    return out


def _pods(objs, rng: random.Random, n: int, kind: str):
    """``n`` pods of one feature mix, built with the ``objs`` module."""
    out = []
    for i in range(n):
        name = f"pod-{i}" if rng.random() < 0.9 else f"web-{i}-x"
        reqs = ({"cpu": f"{rng.randrange(1, 900)}m",
                 "memory": f"{rng.randrange(1, 900)}Mi"}
                if rng.random() < 0.7 else None)
        kw = {}
        if kind == "tolerations" and rng.random() < 0.6:
            kw["tolerations"] = [
                objs.Toleration(key=rng.choice(
                    ["node.kubernetes.io/unschedulable", "dedicated", ""]),
                    operator=rng.choice(["Exists", "Equal"]),
                    value=rng.choice(["", "a"]),
                    effect=rng.choice(["", "NoSchedule", "NoExecute"]))
                for _ in range(rng.randrange(1, 4))
            ]
        if kind == "ports_selector":
            if rng.random() < 0.5:
                kw["node_selector"] = {"zone": f"z{rng.randrange(3)}"}
            if rng.random() < 0.3:
                kw["node_name"] = f"node-{rng.randrange(40):03d}"
        pod = objs.make_pod(name, requests=reqs, **kw)
        if kind == "ports_selector" and rng.random() < 0.5:
            pod.spec.containers[0].ports = [8000 + rng.randrange(4)]
            pod.spec.containers[0].image = "nginx"
            if rng.random() < 0.5:
                pod.spec.containers.append(objs.Container(
                    name="side", image="envoy",
                    requests=objs.ResourceList.parse({"cpu": "50m"}),
                    ports=[9000, 9001]))
        out.append(pod)
    return out


@pytest.mark.parametrize("kind", ["simple", "tolerations", "ports_selector"])
@pytest.mark.parametrize("objs_for_port", ["port", "jax"])
def test_pod_table_columns_equal_jax(kind, objs_for_port):
    port_objs = tobj if objs_for_port == "port" else jobj
    jpods = _pods(jobj, random.Random(7), 150, kind)
    tpods = _pods(port_objs, random.Random(7), 150, kind)
    jt, jnames = jtables.build_pod_table(jpods)
    tt, tnames = ttables.build_pod_table(tpods, device="cpu")
    assert tnames == jnames
    assert_tables_equal(tt, jt)


def test_pod_table_affinity_and_gang_read_duck_typed():
    """Node affinity and gangs have no object model in the port yet: the
    port's table encoder takes the JAX package's objects as they are."""
    rng = random.Random(3)
    pods = []
    for i in range(60):
        req = [jobj.LabelSelectorRequirement("zone", "In", ["z0", "z1"]),
               jobj.LabelSelectorRequirement("rank", rng.choice(["Gt", "Lt"]),
                                             [rng.choice(["3", "x"])])]
        aff = jobj.Affinity(node_affinity=jobj.NodeAffinity(
            required_terms=[jobj.NodeSelectorTerm(req)] if i % 3 else None,
            preferred=[jobj.PreferredSchedulingTerm(
                weight=rng.randrange(1, 100),
                preference=jobj.NodeSelectorTerm(
                    [jobj.LabelSelectorRequirement("pool", "Exists")]))],
        ))
        gang = jobj.GangSpec(name=f"g{i % 4}", size=4) if i % 2 else None
        pods.append(jobj.make_pod(f"pod{i}", affinity=aff, gang=gang))
    jt, _ = jtables.build_pod_table(pods)
    tt, _ = ttables.build_pod_table(pods, device="cpu")
    assert_tables_equal(tt, jt)


@pytest.mark.parametrize("rich", [False, True])
@pytest.mark.parametrize("objs_for_port", ["port", "jax"])
def test_node_table_columns_equal_jax(rich, objs_for_port):
    port_objs = tobj if objs_for_port == "port" else jobj
    jnodes = _nodes(jobj, random.Random(11), 70, rich)
    tnodes = _nodes(port_objs, random.Random(11), 70, rich)
    # already-assigned pods fill the req_*, nzreq_* and used_port columns
    rng = random.Random(5)
    jby, tby = {}, {}
    for k, (jp, tp) in enumerate(zip(_pods(jobj, rng, 40, "ports_selector"),
                                     _pods(port_objs, random.Random(5), 40,
                                           "ports_selector"))):
        target = jnodes[k % 9].metadata.name
        if sum(len(c.ports) for p in jby.get(target, []) + [jp]
               for c in p.spec.containers) > jtables.MAX_PORTS:
            continue
        jby.setdefault(target, []).append(jp)
        tby.setdefault(target, []).append(tp)
    jt, jnames = jtables.build_node_table(jnodes, jby)
    tt, tnames = ttables.build_node_table(tnodes, tby, device="cpu")
    assert tnames == jnames
    assert_tables_equal(tt, jt)


def test_tables_keep_capacities():
    nodes = _nodes(jobj, random.Random(1), 5, True)
    pods = _pods(jobj, random.Random(1), 5, "tolerations")
    jn, _ = jtables.build_node_table(nodes, capacity=256, prof_capacity=128)
    tn, _ = ttables.build_node_table(nodes, capacity=256, prof_capacity=128,
                                     device="cpu")
    jp, _ = jtables.build_pod_table(pods, capacity=384)
    tp, _ = ttables.build_pod_table(pods, capacity=384, device="cpu")
    assert_tables_equal(tn, jn)
    assert_tables_equal(tp, jp)
    assert tn.capacity == 256 and tp.capacity == 384
    with pytest.raises(ValueError):
        ttables.build_pod_table(pods, capacity=4, device="cpu")


def test_tables_from_numpy_round_trips_jax_tables():
    """The JAX tables' columns carried across keep every byte, including
    seeds at and above 2**31 (negative as int32)."""
    nodes = _nodes(jobj, random.Random(2), 50, True)
    pods = _pods(jobj, random.Random(2), 300, "tolerations")
    jn, _ = jtables.build_node_table(nodes)
    jp, _ = jtables.build_pod_table(pods)
    tn, tp = ttables.tables_from_numpy(jax_columns(jn), jax_columns(jp), "cpu")
    assert_tables_equal(tn, jn)
    assert_tables_equal(tp, jp)
    seeds = np.asarray(jp.seed)
    assert (seeds >= 1 << 31).any()  # the sign bit is exercised
    assert tp.seed.dtype == torch.int32
    assert np.array_equal(tp.seed.numpy().view(np.uint32), seeds)


def test_host_table_split_is_views_of_one_buffer():
    pods = _pods(tobj, random.Random(4), 20, "simple")
    host, _ = ttables.pack_pod_table(pods)
    table = host.to_device("cpu")
    live = [name for name, _kind, _shape in host.metas]
    assert "seed" in live and "tol_key" not in live  # zero columns not shipped
    assert host.flat.dtype == np.int32
    assert table.tol_key.shape == (128, ttables.MAX_TOLERATIONS)
    assert not table.tol_key.any()


_STRINGS = ["", "a", "pod0", "node-12", "x" * 300, "ünïcode-7", "node٣",
            "名前9", "tailé", "0"]


def test_hashing_batches_equal_jax_native():
    rng = random.Random(9)
    strings = _STRINGS + [
        "".join(rng.choice("abz09-_éü") for _ in range(rng.randrange(0, 40)))
        for _ in range(300)
    ]
    assert np.array_equal(hashing.fnv1a32_batch(strings),
                          jnative.fnv1a32_batch(strings))
    assert np.array_equal(hashing.pod_seed_batch(strings),
                          jnative.pod_seed_batch(strings))
    assert np.array_equal(hashing.name_suffix_batch(strings),
                          jnative.name_suffix_batch(strings))
    for s in strings:
        assert hashing.fnv1a32(s) == jtables.fnv1a32(s)
        assert hashing.name_suffix(s) == jtables._name_suffix(s)
        assert hashing.pod_seed(s) == jtables.pod_seed(s)
    assert hashing.name_suffix("node٣") == -1  # ASCII digits only
    assert len(hashing.fnv1a32_batch([])) == 0


def test_tolerations_and_quantities_match_jax():
    taint = tobj.Taint(key="node.kubernetes.io/unschedulable")
    jtaint = jobj.Taint(key="node.kubernetes.io/unschedulable")
    for key in ("", "node.kubernetes.io/unschedulable", "other"):
        for op in ("Exists", "Equal"):
            for value in ("", "v"):
                for effect in ("", "NoSchedule", "NoExecute"):
                    t = tobj.Toleration(key, op, value, effect)
                    j = jobj.Toleration(key, op, value, effect)
                    assert t.tolerates(taint) == j.tolerates(jtaint)
    for value, res in (("4", "cpu"), ("250m", "cpu"), ("1.5", "cpu"),
                       ("8Gi", "memory"), ("512Mi", "memory"), ("1e3", "memory"),
                       ("2k", "memory"), (7, "pods")):
        assert tobj.parse_quantity(value, res) == jobj.parse_quantity(value, res)
    p = tobj.make_pod("p1", requests={"cpu": "2", "memory": "1Gi"})
    jp = jobj.make_pod("p1", requests={"cpu": "2", "memory": "1Gi"})
    assert p.resource_requests().milli_cpu == jp.resource_requests().milli_cpu
    assert p.resource_requests().pods == jp.resource_requests().pods == 1
    assert p.metadata.uid == jp.metadata.uid == ""
