"""The port's hand-written kernels on the card, against their twins.

Every test here needs a CUDA card and skips without one (the kernels
have no CPU mode).  The file imports no JAX, so it also runs on a
machine that has PyTorch and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX.)  Comparisons are
exact: the outputs are integers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from minisched_tpu_torch.api.objects import Toleration, make_node, make_pod
from minisched_tpu_torch.engine.oracle import headline_oracle
from minisched_tpu_torch.headline import mk_cluster, schedule_waves
from minisched_tpu_torch.models import tables
from minisched_tpu_torch.ops import fused, kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev() -> torch.device:
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _planes(seed: int, P: int, N: int, dev, tie_heavy: bool):
    rng = np.random.default_rng(seed)
    scores = (rng.choice(np.array([0, 10], np.int32), size=(P, N)) if tie_heavy
              else rng.integers(-50, 500, size=(P, N), dtype=np.int32))
    mask = rng.random((P, N)) < 0.7
    mask[0] = False
    seeds = rng.integers(0, 1 << 32, size=P, dtype=np.uint64).astype(np.uint32)
    seeds[-1] = 0xFFFFFFFF
    return (torch.from_numpy(scores).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(seeds.view(np.int32)).to(dev))


def _cluster(seed: int, n_nodes: int, n_pods: int):
    rng = np.random.default_rng(seed)
    nodes = [make_node(f"node{i}", unschedulable=rng.random() < 0.4)
             for i in range(n_nodes)]
    tol = Toleration(key="node.kubernetes.io/unschedulable", operator="Exists")
    pods = [make_pod(f"pod{i}", tolerations=[tol] if rng.random() < 0.3 else [])
            for i in range(n_pods)]
    return nodes, pods


SHAPES = [(1, 1), (1, 300), (7, 33), (17, 300), (128, 256), (1000, 4097)]


@pytest.mark.parametrize("P,N", SHAPES)
@pytest.mark.parametrize("tie_heavy", [False, True])
def test_select_hosts_kernel_matches_twin(P, N, tie_heavy, dev):
    scores, mask, seeds = _planes(P * 7919 + N, P, N, dev, tie_heavy)
    before = kernels.launch_counts["select_hosts"]
    got = fused.select_hosts(scores, mask, seeds)  # the CUDA route
    assert kernels.launch_counts["select_hosts"] == before + 1
    want = kernels.select_hosts_plain(scores, mask, seeds)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("P,N", SHAPES)
def test_nodenumber_kernel_matches_twin(P, N, dev):
    nodes, pods = _cluster(P + N, N, P)
    nt, _ = tables.build_node_table(nodes, capacity=N, device=dev)
    pt, _ = tables.build_pod_table(pods, capacity=P, device=dev)
    before = kernels.launch_counts["nodenumber_select_hosts"]
    got = kernels.nodenumber_select_hosts(pt, nt)  # the CUDA route
    assert kernels.launch_counts["nodenumber_select_hosts"] == before + 1
    want = kernels.nodenumber_select_hosts_plain(pt, nt)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    scores, mask, seeds = _planes(1, 8, 64, dev, False)
    with pytest.raises(TypeError):
        kernels.select_hosts_cuda(scores.long(), mask, seeds)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.select_hosts_cuda(scores.t().contiguous().t(), mask, seeds)
    with pytest.raises(ValueError, match="shape"):
        kernels.select_hosts_cuda(scores, mask, seeds[:4])
    with pytest.raises(ValueError):
        kernels.select_hosts_cuda(scores, mask.cpu(), seeds)


@pytest.mark.parametrize("route", ["fused", "generic"])
def test_schedule_waves_on_card_matches_oracle(route, dev):
    nodes, pods = mk_cluster(1000, 5000)
    run = schedule_waves(nodes, pods, wave=1024, route=route)
    assert run.node_table.valid.device.type == "cuda"
    assert np.array_equal(run.choices, headline_oracle(pods, nodes))
    cpu = schedule_waves(nodes, pods, wave=1024, route=route, device="cpu")
    for name, col in tables.table_columns(run.node_table).items():
        assert torch.equal(col.cpu(), getattr(cpu.node_table, name)), name
