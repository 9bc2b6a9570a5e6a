"""The headline wave path of the port against the JAX package, end to end.

A few hundred nodes and about a thousand pods go through several waves
against one resident NodeTable.  After every wave the port's
``wave_step`` must give the JAX ``wave_step``'s choices and best scores,
and every column of the updated NodeTable, including the host-port slots
that ``_commit_ports`` fills and the ports it drops when a node's slots
run out.  Both routes of ``headline.schedule_waves`` must give the JAX
``headline_oracle``'s choice for every pod.  All comparisons are exact.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from minisched_tpu.api import objects as jobj
from minisched_tpu.engine.oracle import headline_oracle as jax_headline_oracle
from minisched_tpu.models import tables as jtables
from minisched_tpu.ops.fused import BatchContext as JBatchContext
from minisched_tpu.ops.pallas_kernels import (
    nodenumber_select_hosts as jax_nodenumber_select_hosts,
)
from minisched_tpu.ops.state import apply_placements as jax_apply_placements
from minisched_tpu.ops.state import wave_step as jax_wave_step
from minisched_tpu.plugins.nodenumber import NodeNumber as JNodeNumber
from minisched_tpu.plugins.nodeunschedulable import (
    NodeUnschedulable as JNodeUnschedulable,
)

import minisched_tpu_torch
from minisched_tpu_torch import headline
from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.engine.oracle import headline_oracle
from minisched_tpu_torch.models import tables as ttables
from minisched_tpu_torch.ops import fused as tfused
from minisched_tpu_torch.ops import state as tstate
from minisched_tpu_torch.plugins.nodenumber import NodeNumber
from minisched_tpu_torch.plugins.nodeunschedulable import NodeUnschedulable

from tests.test_torch_tables import assert_tables_equal

N_NODES, N_PODS, WAVE = 300, 1000, 256


def _cluster(objs, seed: int):
    """Nodes (some cordoned, some already holding host ports) and pods
    (some tolerating cordons, some with requests and host ports), built
    with the ``objs`` module from one seed."""
    rng = random.Random(seed)
    nodes = sorted(
        (objs.make_node(f"node{i:04d}", unschedulable=rng.random() < 0.3)
         for i in range(N_NODES)),
        key=lambda n: n.metadata.name,
    )
    assigned = {}
    for node in nodes[::7]:
        pod = objs.make_pod(f"old-{node.metadata.name}",
                            requests={"cpu": "300m"})
        pod.spec.containers[0].ports = [7000 + k for k in range(rng.randrange(1, 7))]
        assigned[node.metadata.name] = [pod]
    pods = []
    for i in range(N_PODS):
        kw = {}
        if rng.random() < 0.2:
            kw["tolerations"] = [objs.Toleration(
                key=rng.choice(["node.kubernetes.io/unschedulable", ""]),
                operator="Exists", effect=rng.choice(["", "NoSchedule"]))]
        reqs = ({"cpu": f"{rng.randrange(0, 500)}m",
                 "memory": f"{rng.randrange(0, 300)}Mi"}
                if rng.random() < 0.6 else None)
        pod = objs.make_pod(f"pod{i}", requests=reqs, **kw)
        if rng.random() < 0.4:
            pod.spec.containers[0].ports = [8000 + k for k in range(rng.randrange(1, 4))]
        pods.append(pod)
    return nodes, assigned, pods


def _jax_chain():
    nn = JNodeNumber()
    return (JNodeUnschedulable(),), (nn,), (nn,), JBatchContext(
        weights=(("NodeNumber", 1),))


def _port_chain():
    nn = NodeNumber()
    return (NodeUnschedulable(),), (nn,), (nn,), tfused.BatchContext(
        weights=(("NodeNumber", 1),))


@pytest.mark.parametrize("objs_for_port", ["port", "jax"])
def test_wave_step_matches_jax_every_wave(objs_for_port):
    jnodes, jassigned, jpods = _cluster(jobj, 31)
    tnodes, tassigned, tpods = _cluster(
        tobj if objs_for_port == "port" else jobj, 31)
    jn, _ = jtables.build_node_table(jnodes, jassigned)
    tn, _ = ttables.build_node_table(tnodes, tassigned, device="cpu")
    assert_tables_equal(tn, jn)
    jchain, tchain = _jax_chain(), _port_chain()
    dropped = 0
    for start in range(0, N_PODS, WAVE):
        jp, _ = jtables.build_pod_table(jpods[start:start + WAVE], capacity=WAVE)
        tp, _ = ttables.build_pod_table(tpods[start:start + WAVE],
                                        capacity=WAVE, device="cpu")
        before = int(np.asarray(jn.num_used_ports).sum())
        jn, jc, jb = jax_wave_step(jn, jp, *jchain)
        tn, tc, tb = tstate.wave_step(tn, tp, *tchain)
        assert np.array_equal(tc.numpy(), np.asarray(jc))
        assert np.array_equal(tb.numpy(), np.asarray(jb))
        assert_tables_equal(tn, jn)
        placed = (np.asarray(jc) >= 0) & np.asarray(jp.valid)
        offered = int(np.asarray(jp.num_ports)[placed].sum())
        dropped += offered - (int(np.asarray(jn.num_used_ports).sum()) - before)
    # the slot overflow really happened, and the port dropped the same ports
    assert dropped > 0
    assert int(tn.num_used_ports.max()) == ttables.MAX_PORTS


def test_apply_placements_is_pure_and_skips_unplaced():
    nodes, assigned, pods = _cluster(tobj, 5)
    tn, _ = ttables.build_node_table(nodes, assigned, device="cpu")
    tp, _ = ttables.build_pod_table(pods[:WAVE], device="cpu")
    snapshot = {k: v.clone() for k, v in ttables.table_columns(tn).items()}
    choice = torch.full((tp.capacity,), -1, dtype=torch.int32)
    out = tstate.apply_placements(tn, tp, choice)
    for name, col in ttables.table_columns(tn).items():
        assert torch.equal(col, snapshot[name]), name  # input untouched
        assert torch.equal(getattr(out, name), col), name  # nothing placed


@pytest.mark.parametrize("route", headline.ROUTES)
def test_schedule_waves_matches_oracles(route):
    nodes, pods = headline.mk_cluster(N_NODES, N_PODS)
    run = headline.schedule_waves(nodes, pods, wave=WAVE, route=route,
                                  device="cpu")
    assert run.n_waves == 4 and run.choices.shape == (N_PODS,)
    want = headline_oracle(pods, nodes)
    assert np.array_equal(run.choices, want)
    jnodes = [jobj.make_node(n.metadata.name,
                             unschedulable=n.spec.unschedulable) for n in nodes]
    jpods = [jobj.make_pod(p.metadata.name) for p in pods]
    assert np.array_equal(jax_headline_oracle(jpods, jnodes), want)
    assert (run.choices >= 0).all()
    assert np.array_equal(run.best == 10, run.choices % 10 == np.array(
        [int(p.metadata.name[-1]) for p in pods]))


def test_schedule_waves_routes_leave_equal_tables_and_match_jax_fused():
    """Both routes commit the same placements; their final tables equal
    the JAX fused flow's (``nodenumber_select_hosts`` + ``apply_placements``
    per wave, as in ``bench.py``)."""
    nodes, pods = headline.mk_cluster(N_NODES, N_PODS, seed=77)
    runs = [headline.schedule_waves(nodes, pods, wave=WAVE, route=r,
                                    device="cpu") for r in headline.ROUTES]
    assert np.array_equal(runs[0].choices, runs[1].choices)
    jn, _ = jtables.build_node_table(
        [jobj.make_node(n.metadata.name, unschedulable=n.spec.unschedulable)
         for n in nodes])
    jpods = [jobj.make_pod(p.metadata.name) for p in pods]
    for start in range(0, N_PODS, WAVE):
        jp, _ = jtables.build_pod_table(jpods[start:start + WAVE], capacity=WAVE)
        jc, _ = jax_nodenumber_select_hosts(jp, jn, interpret=True)
        jn = jax_apply_placements(jn, jp, jc)
    for run in runs:
        assert_tables_equal(run.node_table, jn)
    assert int(runs[0].node_table.req_pods.sum()) == N_PODS


def test_schedule_waves_small_wave_and_ragged_tail():
    nodes, pods = headline.mk_cluster(130, 250, seed=3)
    run = headline.schedule_waves(nodes, pods, wave=100, route="fused",
                                  device="cpu")
    assert run.n_waves == 3
    assert np.array_equal(run.choices, headline_oracle(pods, nodes))


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes, pods = headline.mk_cluster(10, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        headline.schedule_waves(nodes, pods)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttables.build_node_table(nodes)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        minisched_tpu_torch.resolve_device(None)
    assert minisched_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown route"):
        headline.schedule_waves(nodes, pods, route="nope", device="cpu")
