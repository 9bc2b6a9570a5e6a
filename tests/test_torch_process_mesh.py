"""The port's mesh across processes (``parallel/distributed.py``) against
JAX's mesh.

JAX puts hosts on the pod axis (``minisched_tpu/parallel/sharding.py:
91-108``, ``:134-141``) and GSPMD runs its one-shot steps across them.
Here 2 and 4 processes (``distributed.spawn``: ``gloo``, a ``file://``
rendezvous) each build ``make_mesh(devices=[cpu] * L)`` under the group,
a W x L mesh of W processes, and run on the mixed cluster (every
cross-pod and volume feature of the full roster): the full-roster repair
wave with diagnostics, ``sharded_wave_step`` on the NodeNumber chain,
and the exact scan in the scan layout.  Every rank's choices, best
scores, rounds, unschedulable masks, final node tables and carried
volume planes are compared with ``==`` against every other rank's,
against JAX's single-process mesh of the same shape (on conftest's 8
host devices), against JAX's mesh-off step and against the port's
mesh-off path.  The factoring is held to JAX's rule for a table of
(L, W, pod_shards), and the refusals raise: a pinned pod axis that is
not a multiple of W, unequal device counts, a mesh across processes
handed to the engine.  A rank that raises mid-wave makes ``spawn`` raise
naming it, and a rank that hangs is killed at the deadline.

The children run ``tests/process_mesh_child.py``, which imports the port
alone; the JAX work of each case runs in this process while they do.
"""

from __future__ import annotations

import random
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import numpy as np
import pytest
import torch

from minisched_tpu.models import tables as jtables
from minisched_tpu.models.constraints import build_constraint_tables
from minisched_tpu.ops import fused as jfused
from minisched_tpu.ops import repair as jrepair
from minisched_tpu.ops import sequential as jseq
from minisched_tpu.ops.state import wave_step as jwave_step
from minisched_tpu.parallel import sharding as jsh
from minisched_tpu.plugins.nodenumber import NodeNumber as JNodeNumber
from minisched_tpu.plugins.nodeunschedulable import (
    NodeUnschedulable as JNodeUnschedulable,
)
from minisched_tpu.plugins.registry import build_plugins as jbuild_plugins
from minisched_tpu.service import config as jconfig

from minisched_tpu_torch.ops import repair as trepair
from minisched_tpu_torch.parallel import distributed, rank_steps
from minisched_tpu_torch.parallel import sharding as tsh
from minisched_tpu_torch.plugins.registry import build_plugins
from minisched_tpu_torch.service import config as tconfig

from tests import process_mesh_child as child
from tests.test_sequential import _mixed_cluster
from tests.test_torch_crosspod import by_node, jax_columns
from tests.test_torch_sequential import to_port

#: each spawn's deadline, seconds (a hang fails in bounded time)
DEADLINE_S = 100.0
#: (processes W, devices a process L) of the meshes under test
SHAPES = [(2, 2), (4, 1), (4, 2)]
#: (L, pinned pod_shards) each rank factors under its group
FACTORING = [(1, None), (2, None), (3, None), (4, None), (2, 2), (2, 4),
             (4, 8), (4, 4), (2, 1), (2, 3), (3, 6), (4, 16)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _full(mod):
    cfg = mod.default_full_roster_config()
    chains = (jbuild_plugins if mod is jconfig else build_plugins)(cfg)
    return (chains.filter, chains.pre_score, chains.score), cfg.score_weights()


def _nn_chain():
    nn = JNodeNumber()
    return (JNodeUnschedulable(),), (nn,), (nn,)


NN_CTX = jfused.BatchContext(weights=(("NodeNumber", 1),))


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The mixed cluster (160 nodes in 4 zones, 24 assigned and 250
    pending pods with every cross-pod and volume coupling) as JAX tables
    with scan planes, 256 node rows and 256 pod rows (whole rows on every
    axis under test; with two node shards the second holds 32 nodes and
    padding), the port's copies saved for the children, and the mesh-off
    references: JAX's repair wave, NodeNumber wave step and scan, and
    the port's repair wave (the carried volume planes)."""
    nodes, assigned, pods, pvcs, pvs = _mixed_cluster(random.Random(2024),
                                                      160, 24, 250)
    nodes = sorted(nodes, key=lambda n: n.metadata.name)
    jn, _ = jtables.build_node_table(nodes, by_node(assigned), capacity=256)
    jp, _ = jtables.build_pod_table(pods, capacity=256)
    je = build_constraint_tables(pods, nodes, assigned,
                                 pod_capacity=jp.capacity,
                                 node_capacity=jn.capacity, pvcs=pvcs,
                                 pvs=pvs, scan_planes=True)
    tn, tp, te = to_port(jn, jp, je)
    path = str(tmp_path_factory.mktemp("process-mesh") / "inputs.pt")
    rank_steps.save_inputs(path, repair=(tp, tn, te),
                           step=(tp, tn, None, "nodenumber"),
                           scan=(tp, tn, te))
    chains, weights = _full(jconfig)
    off = jrepair.RepairingEvaluator(*chains, weights=weights,
                                     with_diagnostics=True)(jp, jn, je)
    f, pre, sc = _nn_chain()
    step = jax.jit(partial(jwave_step, filter_plugins=f,
                           pre_score_plugins=pre, score_plugins=sc,
                           ctx=NN_CTX))(jn, jp)
    scan = jseq.SequentialScheduler(*chains, weights)(jp, jn, je)
    tchains, tweights = _full(tconfig)
    port_off = trepair.RepairingEvaluator(*tchains, weights=tweights,
                                          with_diagnostics=True)(tp, tn, te)
    choice = np.asarray(off[1])[:len(pods)]
    assert 0 < (choice >= 0).sum() < len(pods) and int(off[2]) > 1, (
        "the wave should take several rounds and leave some pod unplaced")
    assert (choice >= 128).any(), "some pod should land on node shard 1"
    return {"jax": (jn, jp, je), "port": (tn, tp, te), "path": path,
            "off": off, "step": step, "scan": scan, "port_off": port_off,
            "n_pods": len(pods)}


def _jax_mesh(W: int, L: int) -> jax.sharding.Mesh:
    n = W * L
    return jsh.make_mesh(n, W, devices=jax.devices()[:n])


def _jax_on_mesh(mixed, jmesh):
    """JAX's repair wave, NodeNumber wave step and scan on ``jmesh``."""
    jn, jp, je = mixed["jax"]
    chains, weights = _full(jconfig)
    repair = jrepair.RepairingEvaluator(*chains, weights=weights,
                                        with_diagnostics=True,
                                        mesh=jmesh)(jp, jn, je)
    jp_s, jn_s = jsh.shard_tables(jmesh, jp, jn)
    step = jsh.sharded_wave_step(jmesh, *_nn_chain(), NN_CTX)(jn_s, jp_s)
    scan = jseq.SequentialScheduler(*chains, weights, mesh=jmesh)(jp, jn, je)
    return repair, step, scan


def assert_columns(got: dict, want_jax_table) -> None:
    want = jax_columns(want_jax_table)
    assert set(got) <= set(want)
    for name, col in got.items():
        np.testing.assert_array_equal(col.numpy(), want[name], err_msg=name)


def assert_same_result(a, b, path="") -> None:
    """Two ranks' results, equal field by field (tensors with ==)."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            if k not in ("wall_s", "gather_s", "gather_wait_s", "rank", "rows",
                         "engine_refusal", "factoring"):
                assert_same_result(a[k], b[k], f"{path}/{k}")
    else:
        assert a == b, path


def _hold_against(r, want_repair, want_step, want_scan, n_pods) -> None:
    """One rank's results against a JAX run (mesh-off or on a mesh)."""
    rep = r["repair"]
    np.testing.assert_array_equal(rep["choice"].numpy(),
                                  np.asarray(want_repair[1]))
    assert rep["rounds"] == int(want_repair[2])
    np.testing.assert_array_equal(rep["unschedulable"].numpy(),
                                  np.asarray(want_repair[3]))
    assert_columns(rep["node_table"], want_repair[0])
    st = r["step"]
    np.testing.assert_array_equal(st["choice"].numpy(), np.asarray(want_step[1]))
    np.testing.assert_array_equal(st["best"].numpy(), np.asarray(want_step[2]))
    assert_columns(st["node_table"], want_step[0])
    sc = r["scan"]
    np.testing.assert_array_equal(sc["choice"].numpy(), np.asarray(want_scan[1]))
    np.testing.assert_array_equal(sc["best"].numpy(), np.asarray(want_scan[2]))
    assert_columns(sc["node_table"], want_scan[0])
    assert int((sc["choice"][:n_pods] >= 0).sum()) > 0


@pytest.mark.parametrize("W, L", SHAPES, ids=[f"{w}x{n}" for w, n in SHAPES])
def test_steps_across_processes_equal_jax(W, L, mixed):
    """W processes of L devices each: a W x L mesh, one pod shard a
    process; each rank's steps bit-identical to every other rank's, to
    JAX's mesh of the same shape, to JAX's mesh-off steps and to the
    port's mesh-off wave; the factoring and the refusals as JAX's rule
    says."""
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(distributed.spawn, W, child.factor_and_run,
                          (mixed["path"], L, FACTORING), DEADLINE_S)
        on_mesh = _jax_on_mesh(mixed, _jax_mesh(W, L))
        ranks = fut.result()
    n_pods = mixed["n_pods"]
    for rank, r in enumerate(ranks):
        assert (r["rank"], r["processes"]) == (rank, W)
        assert r["shape"] == (W, L) and r["rows"] == [rank]
        assert "spans processes" in r["engine_refusal"]
        assert_same_result(r, ranks[0], f"rank {rank}")
        _hold_against(r, mixed["off"], mixed["step"], mixed["scan"], n_pods)
        _hold_against(r, *on_mesh, n_pods)
        port_off = mixed["port_off"]
        rep = r["repair"]
        assert torch.equal(rep["choice"], port_off.choice)
        for name in rank_steps.CARRIED:
            assert torch.equal(rep["carried"][name],
                               getattr(port_off.extra, name)), name
        # this process's tiles only, on the CPU twins; one gather a round
        # and one for the diagnostics
        diag = int(bool((port_off.choice[:n_pods] < 0).any()))
        evaluations = rep["rounds"] + diag
        assert rep["plain"] == L * evaluations and rep["launches"] == 0
        assert rep["gather_calls"] == evaluations
        assert r["step"]["plain"] == L and r["step"]["gather_calls"] == 2
        assert r["scan"]["gather_calls"] == 0
        _hold_factoring(r, W, rank)


def _hold_factoring(r, W: int, rank: int) -> None:
    """Each (L, pin) of ``FACTORING`` under W processes: JAX's rule
    (``default_pod_shards(W * L, W)`` rows by default), the rows of this
    rank a block of the host-major grid, a pin that is not a multiple of
    W refused."""
    for (L, pin), got in zip(FACTORING, r["factoring"]):
        n = W * L
        rows = pin if pin is not None else jsh.default_pod_shards(n, W)
        if rows % W or n % rows:
            assert got[0] == "ValueError", (L, pin, got)
            continue
        assert got[0] == (rows, n // rows), (L, pin, got)
        per = rows // W
        assert got[1] == list(range(rank * per, (rank + 1) * per))
        if n <= len(jax.devices()):
            # JAX's grid over W * L host-major devices, device k on
            # process k // L: each row on one process, this rank's rows
            grid = np.asarray(jsh.make_mesh(n, rows,
                                            devices=jax.devices()[:n])
                              .device_ids)
            owner = grid // L
            assert (owner == owner[:, :1]).all()
            assert list(np.flatnonzero(owner[:, 0] == rank)) == got[1]
    assert "same device count" in r["unequal"]


@pytest.mark.parametrize("pod_shards, node_shards",
                         [(1, 2), (2, 2), (1, 4), (2, 1)])
def test_mesh_carries_the_volume_planes_as_mesh_off(pod_shards, node_shards,
                                                    mixed):
    """One process's mesh: the carried volume planes (the dummy row too,
    which takes every mount slot that commits nothing) equal mesh-off's,
    node shards of 128 and of 64 rows, the last of them padding."""
    tn, tp, te = mixed["port"]
    chains, weights = _full(tconfig)
    n = pod_shards * node_shards
    mesh = tsh.make_mesh(n, pod_shards, devices=[torch.device("cpu")] * n)
    off = trepair.RepairingEvaluator(*chains, weights=weights)(tp, tn, te)
    got = trepair.RepairingEvaluator(*chains, weights=weights,
                                     mesh=mesh)(tp, tn, te)
    assert torch.equal(got.choice, off.choice)
    for name in rank_steps.CARRIED:
        assert torch.equal(getattr(got.extra, name),
                           getattr(off.extra, name)), name


def test_make_mesh_off_a_group_is_one_process():
    """Without a group the mesh is this process's, every row its own, and
    ``local`` changes nothing; ``gather_pod_rows`` concatenates."""
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    for local in (False, True):
        mesh = tsh.make_mesh(8, devices=[torch.device("cpu")] * 8,
                             local=local)
        assert mesh.shape == {"pods": 2, "nodes": 4}
        assert mesh.rows == [0, 1] and not mesh.spans_processes
        assert mesh.lead == mesh.node_device(3) == torch.device("cpu")
    parts = [torch.arange(3), torch.arange(3, 6)]
    assert torch.equal(distributed.gather_pod_rows(mesh, parts, "cpu"),
                       torch.arange(6))
    assert distributed.all_gather_objects("x") == ["x"]


def test_engine_refuses_a_mesh_across_processes():
    """The live engine is one process, as JAX's: a mesh that spans
    processes raises before anything starts."""
    from minisched_tpu_torch.engine.device_scheduler import (
        new_device_scheduler,
    )

    cpu = torch.device("cpu")
    mesh = tsh.Mesh([[cpu, cpu], [cpu, cpu]], group=object(), rows=[1])
    assert mesh.spans_processes and mesh.process_count == 2
    assert mesh.lead == cpu
    with pytest.raises(ValueError, match="spans processes"):
        new_device_scheduler(None, None, device="cpu", mesh=mesh)


def test_initialize_needs_a_rendezvous(monkeypatch):
    for var in distributed.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="RANK"):
        distributed.initialize()
    with pytest.raises(ValueError, match="world_size"):
        distributed.initialize(init_method="file:///nonexistent/x")
    assert not distributed.is_initialized()


@pytest.mark.parametrize("how, deadline", [("raise", DEADLINE_S),
                                           ("hang", 12.0)])
def test_a_failing_rank_fails_the_spawn_in_bounded_time(how, deadline, mixed):
    """Rank 1 raises (or never returns) inside a tile of the wave's
    first round while rank 0 waits at the round's gather: ``spawn``
    kills what still runs and raises naming rank 1, with its traceback;
    a hang is killed at the deadline."""
    t0 = time.monotonic()
    with pytest.raises(distributed.SpawnError) as info:
        distributed.spawn(2, child.fail_mid_wave, (mixed["path"], 2, how),
                          deadline)
    took = time.monotonic() - t0
    err = info.value
    if how == "raise":
        assert err.ranks[1] == 1
        assert "rank 1 fails mid-wave" in err.tracebacks[1]
        assert "rank 1: exit code 1" in str(err)
        # rank 0 waited at the gather: killed, or failed there when its
        # peer's connection closed
        assert err.ranks[0] in (None, 1)
        assert took < deadline
    else:
        assert err.ranks == {0: None, 1: None}
        assert "deadline" in str(err)
        assert deadline <= took < deadline + 15
