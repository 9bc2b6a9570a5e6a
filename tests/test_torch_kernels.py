"""The seeded masked argmax of the port against the JAX package.

``minisched_tpu_torch.ops.kernels`` holds two hand-written Hopper kernels
and their plain PyTorch twins.  Here, on the CPU, each twin is held
against the JAX function its kernel replaces: the XLA tail
``fused.select_hosts`` and ``select_hosts_pallas(interpret=True)`` where
the shape tiles, and ``nodenumber_select_hosts(interpret=True)``.  The
kernels themselves run only on a card: ``tests/test_torch_cuda.py``.  All
comparisons are exact: the outputs are integers.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minisched_tpu.api.objects import Toleration, make_node, make_pod
from minisched_tpu.engine import oracle as joracle
from minisched_tpu.engine import tiebreak as jtiebreak
from minisched_tpu.models import tables as jtables
from minisched_tpu.ops import fused as jfused
from minisched_tpu.ops.pallas_kernels import (
    nodenumber_select_hosts as jax_nodenumber_select_hosts,
    select_hosts_pallas,
)
from minisched_tpu.plugins.nodenumber import NodeNumber as JNodeNumber
from minisched_tpu.plugins.nodeunschedulable import (
    NodeUnschedulable as JNodeUnschedulable,
    tolerates_unschedulable as jax_tolerates_unschedulable,
)

from minisched_tpu_torch import kernel_cases
from minisched_tpu_torch.api import objects as tobjects
from minisched_tpu_torch.engine import oracle as toracle
from minisched_tpu_torch.engine import tiebreak as ttiebreak
from minisched_tpu_torch.models import tables as ttables
from minisched_tpu_torch.ops import fused as tfused
from minisched_tpu_torch.ops import kernels, scan_commit
from minisched_tpu_torch.plugins.nodeunschedulable import tolerates_unschedulable

from tests.test_torch_tables import jax_columns, port_columns


def _case(seed: int, P: int, N: int, tie_heavy: bool, high_seeds: bool = False):
    """(scores i32, mask bool, seeds u32) numpy arrays from one seed —
    the ``tests/test_pallas.py`` generator, plus forced edge rows."""
    rng = np.random.default_rng(seed)
    if tie_heavy:
        scores = rng.choice(np.array([0, 10], np.int32), size=(P, N))
    else:
        scores = rng.integers(-50, 500, size=(P, N), dtype=np.int32)
    mask = rng.random((P, N)) < 0.7
    mask[0, :] = False  # one pod with no feasible node
    lo = 0x80000000 if high_seeds else 0
    seeds = rng.integers(lo, 1 << 32, size=P, dtype=np.uint64).astype(np.uint32)
    if P > 2:
        mask[1, :] = True
        scores[1, :] = np.iinfo(np.int32).min  # feasible at INT32_MIN
        seeds[2] = 0xFFFFFFFF
    return scores, mask, seeds


def _port(scores, mask, seeds):
    return (torch.from_numpy(scores), torch.from_numpy(mask),
            torch.from_numpy(seeds.view(np.int32)))


def _jax_select(scores, mask, seeds):
    c, b = jfused.select_hosts(jnp.asarray(scores), jnp.asarray(mask),
                               jnp.asarray(seeds))
    return np.asarray(c), np.asarray(b)


SHAPES = [
    (1, False, 128, 256), (2, True, 128, 256), (3, True, 128, 256),
    (4, False, 1, 300), (5, True, 1, 7), (6, True, 17, 300),
    (7, False, 8, 128), (8, True, 40, 1000),
]


@pytest.mark.parametrize("seed,tie_heavy,P,N", SHAPES)
@pytest.mark.parametrize("high_seeds", [False, True])
def test_select_hosts_plain_matches_jax(seed, tie_heavy, P, N, high_seeds):
    scores, mask, seeds = _case(seed, P, N, tie_heavy, high_seeds)
    want_c, want_b = _jax_select(scores, mask, seeds)
    got_c, got_b = kernels.select_hosts_plain(*_port(scores, mask, seeds))
    assert got_c.dtype == torch.int32 and got_b.dtype == torch.int32
    assert np.array_equal(got_c.numpy(), want_c)
    assert np.array_equal(got_b.numpy(), want_b)
    # the CPU route of the dispatcher is the twin
    route_c, route_b = tfused.select_hosts(*_port(scores, mask, seeds))
    assert torch.equal(route_c, got_c) and torch.equal(route_b, got_b)
    if P % 8 == 0 and N % 128 == 0:
        pc, pb = select_hosts_pallas(jnp.asarray(scores), jnp.asarray(mask),
                                     jnp.asarray(seeds), interpret=True)
        # the Pallas kernel calls a row infeasible when its only feasible
        # scores are INT32_MIN (it tests best > INT32_MIN); the XLA tail,
        # and the port, test mask.any — so that one row is left out here
        rows = np.flatnonzero(~(mask & (scores == np.iinfo(np.int32).min)).any(1))
        assert np.array_equal(got_c.numpy()[rows], np.asarray(pc)[rows])
        assert np.array_equal(got_b.numpy()[rows], np.asarray(pb)[rows])


def test_select_hosts_plain_matches_scalar_select_host():
    scores, mask, seeds = _case(21, 12, 60, tie_heavy=True, high_seeds=True)
    got, _ = kernels.select_hosts_plain(*_port(scores, mask, seeds))
    for p in range(12):
        want = jtiebreak.select_host(scores[p].tolist(), mask[p].tolist(),
                                     int(seeds[p]))
        assert ttiebreak.select_host(scores[p].tolist(), mask[p].tolist(),
                                     int(seeds[p])) == want
        assert int(got[p]) == want


def test_select_hosts_plain_empty_node_axis():
    c, b = kernels.select_hosts_plain(torch.zeros((3, 0), dtype=torch.int32),
                                      torch.zeros((3, 0), dtype=torch.bool),
                                      torch.zeros(3, dtype=torch.int32))
    assert c.tolist() == [-1, -1, -1] and b.tolist() == [0, 0, 0]


def test_mix32_matches_scalar_and_jax():
    rng = np.random.default_rng(0)
    seeds = np.concatenate([
        rng.integers(0, 1 << 32, 400, dtype=np.uint64),
        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 np.uint64),
    ]).astype(np.uint32)
    idx = np.concatenate([rng.integers(0, 1 << 20, 400),
                          np.array([0, 1, 10111, (1 << 31) - 1, 1 << 31,
                                    (1 << 32) - 1])]).astype(np.uint32)
    got = tfused.mix32(torch.from_numpy(seeds.view(np.int32)),
                       torch.from_numpy(idx.astype(np.int64))).numpy()
    want = np.asarray(jfused.mix32(jnp.asarray(seeds), jnp.asarray(idx)))
    assert np.array_equal(got, want.astype(np.int64))
    assert np.array_equal(toracle.mix32_np(seeds, idx), joracle.mix32_np(seeds, idx))
    for s, i in zip(seeds.tolist(), idx.tolist()):
        assert ttiebreak.mix32(s, i) == jtiebreak.mix32(s, i)


def _nodenumber_cluster(seed: int, n_nodes: int, n_pods: int):
    """The ``tests/test_pallas.py`` fused-kernel cluster, with the JAX
    package's objects (the port's table encoders read them duck-typed)."""
    rng = random.Random(seed)
    nodes = [make_node(f"node{i}", unschedulable=rng.random() < 0.4)
             for i in range(n_nodes)]
    pods = []
    for i in range(n_pods):
        tols = ([Toleration(key="node.kubernetes.io/unschedulable",
                            operator="Exists", effect="NoSchedule")]
                if rng.random() < 0.3 else [])
        pods.append(make_pod(f"pod{i}", tolerations=tols))
    return sorted(nodes, key=lambda n: n.metadata.name), pods


@pytest.mark.parametrize("seed,n_nodes,n_pods", [(6, 200, 100), (8, 300, 1),
                                                 (9, 50, 129)])
def test_nodenumber_select_hosts_plain_matches_jax(seed, n_nodes, n_pods):
    nodes, pods = _nodenumber_cluster(seed, n_nodes, n_pods)
    jn, _ = jtables.build_node_table(nodes)
    jp, _ = jtables.build_pod_table(pods)
    nn = JNodeNumber()
    ref = jfused.FusedEvaluator([JNodeUnschedulable()], [nn], [nn])(jp, jn)
    want_c, want_b = jax_nodenumber_select_hosts(jp, jn, interpret=True)
    assert np.array_equal(np.asarray(want_c), np.asarray(ref.choice))
    tn, _ = ttables.build_node_table(nodes, device="cpu")
    tp, _ = ttables.build_pod_table(pods, device="cpu")
    for c, b in (kernels.nodenumber_select_hosts_plain(tp, tn),
                 kernels.nodenumber_select_hosts(tp, tn)):
        assert np.array_equal(c.numpy(), np.asarray(want_c))
        assert np.array_equal(b.numpy(), np.asarray(want_b))
    assert np.array_equal(tolerates_unschedulable(tp).numpy(),
                          np.asarray(jax_tolerates_unschedulable(jp)))


def test_nodenumber_plain_on_jax_columns_with_ragged_shapes():
    """Unpadded shapes (P=1, N=300) through ``tables_from_numpy``: the
    twin takes any shape, as the kernel does."""
    nodes, pods = _nodenumber_cluster(12, 300, 1)
    jn, _ = jtables.build_node_table(nodes, capacity=300)
    jp, _ = jtables.build_pod_table(pods, capacity=1)
    tn, tp = ttables.tables_from_numpy(jax_columns(jn), jax_columns(jp), "cpu")
    c, b = kernels.nodenumber_select_hosts_plain(tp, tn)
    scores, mask = kernels.nodenumber_planes(
        tolerates_unschedulable(tp), tp, tn, 10)
    want_c, want_b = _jax_select(scores.numpy(), mask.numpy(),
                                 np.asarray(jp.seed))
    assert np.array_equal(c.numpy(), want_c) and np.array_equal(b.numpy(), want_b)


def _jax_table(cls, port_table):
    """The JAX package's table holding the port table's columns."""
    return cls(**{k: jnp.asarray(v) for k, v in port_columns(port_table).items()})


@pytest.mark.parametrize("seed,n_nodes,n_pods", [(1, 200, 128), (2, 300, 8),
                                                 (3, 128, 256)])
def test_toleration_forms_match_jax(seed, n_nodes, n_pods):
    """Every toleration form of ``kernel_cases`` (Exists with the taint's
    key, Equal with an empty and a non-empty value, the wildcard, the
    NoExecute and PreferNoSchedule effects, other keys), slots past
    ``num_tols`` holding tolerations that would match, invalid rows, and
    pods and nodes without a numeric suffix: the port's
    ``tolerates_unschedulable`` and fused twin against the JAX package's
    and ``nodenumber_select_hosts(interpret=True)``."""
    nodes, pods = kernel_cases.toleration_cluster(seed, n_nodes, n_pods)
    tn, _ = ttables.build_node_table(nodes, device="cpu")
    tp, _ = ttables.build_pod_table(pods, device="cpu")
    tp = kernel_cases.garble(tp, seed)
    jn, jp = _jax_table(jtables.NodeTable, tn), _jax_table(jtables.PodTable, tp)
    got_tol = tolerates_unschedulable(tp).numpy()
    assert np.array_equal(got_tol, np.asarray(jax_tolerates_unschedulable(jp)))
    # the cases reach both answers, and garbage past num_tols is present
    assert got_tol.any() and not got_tol.all()
    past = np.arange(tp.tol_key.shape[1])[None, :] >= tp.num_tols.numpy()[:, None]
    assert (past & (tp.tol_key.numpy() != 0)).any()
    want_c, want_b = jax_nodenumber_select_hosts(jp, jn, interpret=True)
    got_c, got_b = kernels.nodenumber_select_hosts_plain(tp, tn)
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert np.array_equal(got_b.numpy(), np.asarray(want_b))


def test_toleration_forms_cover_every_form():
    """Each form of ``TOLERATION_FORMS`` tolerates the taint in the JAX
    package exactly when the port says so, one pod per form."""
    forms = list(kernel_cases.TOLERATION_FORMS)
    tp, _ = ttables.build_pod_table(
        [tobjects.make_pod(f"p{i}", tolerations=[kernel_cases.TOLERATION_FORMS[f]])
         for i, f in enumerate(forms)], device="cpu")
    got = tolerates_unschedulable(tp).numpy()[:len(forms)]
    want = np.asarray(jax_tolerates_unschedulable(
        _jax_table(jtables.PodTable, tp)))[:len(forms)]
    assert np.array_equal(got, want)
    assert dict(zip(forms, got.tolist())) == {
        f: i < 4 for i, f in enumerate(forms)}


def test_cuda_wrappers_refuse_cpu_tensors():
    scores, mask, seeds = _port(*_case(1, 8, 128, False))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.select_hosts_cuda(scores, mask, seeds)
    nodes, pods = _nodenumber_cluster(6, 20, 8)
    tn, _ = ttables.build_node_table(nodes, device="cpu")
    tp, _ = ttables.build_pod_table(pods, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.nodenumber_select_hosts_cuda(tp, tn)
    case = kernel_cases.commit_case(1, 8, 40, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        scan_commit.block_commit_cuda(*case.args(case.state()))
    assert kernels.launch_counts == {"select_hosts": 0,
                                     "nodenumber_select_hosts": 0,
                                     "block_commit": 0}
