"""The headline wave path: many pod waves against one resident NodeTable.

Counterpart of the flow of ``bench.py`` ``bench_headline``: the reference
scheduler's default chain (the NodeUnschedulable filter, NodeNumber
pre-score and score) schedules every pending pod in waves of ``wave``
pods against a NodeTable that stays on the device; each wave's
placements are committed into the table before the next wave.

Two routes, bit-identical in choices and final tables:

* ``"fused"``: ``nodenumber_select_hosts`` (the whole chain in one kernel,
  reading table columns only) plus ``apply_placements``;
* ``"generic"``: ``ops.state.wave_step`` with the plugin chain, whose
  (P, N) planes end in ``fused.select_hosts``.

Usage (on the card)::

    from minisched_tpu_torch.headline import mk_cluster, schedule_waves
    nodes, pods = mk_cluster()
    run = schedule_waves(nodes, pods)
    print(run.schedule_s, len(pods) / run.schedule_s)
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from minisched_tpu_torch import resolve_device
from minisched_tpu_torch.api.objects import make_node, make_pod
from minisched_tpu_torch.models.tables import (
    NodeTable,
    pack_node_table,
    pack_pod_table,
    pad_to,
)
from minisched_tpu_torch.ops.fused import BatchContext
from minisched_tpu_torch.ops.kernels import nodenumber_select_hosts
from minisched_tpu_torch.ops.state import apply_placements, wave_step
from minisched_tpu_torch.plugins.nodenumber import NodeNumber
from minisched_tpu_torch.plugins.nodeunschedulable import NodeUnschedulable
from minisched_tpu_torch.utils import build

ROUTES = ("fused", "generic")
WAVE = 8192  # pods per wave of the headline run


def mk_cluster(n_nodes: int = 10_000, n_pods: int = 100_000,
               seed: int = 1234) -> Tuple[List[Any], List[Any]]:
    """The headline cluster (a copy of ``bench.py`` ``_mk_cluster``):
    ``n_nodes`` nodes named ``node00000`` …, each cordoned with probability
    0.2 from ``random.Random(seed)``, and ``n_pods`` request-less pods
    ``pod0`` …"""
    rng = random.Random(seed)
    nodes = sorted(
        (
            make_node(f"node{i:05d}", unschedulable=rng.random() < 0.2)
            for i in range(n_nodes)
        ),
        key=lambda n: n.metadata.name,
    )
    pods = [make_pod(f"pod{i}") for i in range(n_pods)]
    return nodes, pods


def make_step(route: str) -> Callable:
    """``step(node_table, pod_table) -> (node_table, choice, best)``."""
    if route == "fused":
        def step(node_table, pod_table):
            choice, best = nodenumber_select_hosts(pod_table, node_table)
            return apply_placements(node_table, pod_table, choice), choice, best
        return step
    if route == "generic":
        nn = NodeNumber()
        filters, pre_scores, scores = (NodeUnschedulable(),), (nn,), (nn,)
        ctx = BatchContext(weights=(("NodeNumber", 1),))

        def step(node_table, pod_table):
            return wave_step(node_table, pod_table, filters, pre_scores,
                             scores, ctx)
        return step
    raise ValueError(f"unknown route {route!r}; expected one of {ROUTES}")


@dataclass
class WaveRun:
    """What ``schedule_waves`` returns.  Times are host wall seconds, each
    phase closed by a device synchronise on a card."""

    choices: np.ndarray  # int64[n_pods] node row per pod, -1 = unplaced
    best: np.ndarray  # int64[n_pods] winning score per pod (0 if unplaced)
    node_table: NodeTable  # the resident table after the last wave
    node_names: List[str]
    n_waves: int
    kernel_build_s: float  # nvcc build (or cache hit) of the kernels
    build_s: float  # host encoding of the node table and every pod wave
    h2d_s: float  # every table copied to the device
    warmup_s: float  # one step whose result is dropped (first launches)
    schedule_s: float  # every wave, node table resident


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_waves(step: Callable, node_table: NodeTable, pod_tables: Sequence[Any],
              n_live: Sequence[int]):
    """The wave loop: ``step`` each pod table against the resident node
    table, keeping the first ``n_live[k]`` rows of wave k's choices (the
    rest are padding).  Returns (node_table, choices, bests), the last two
    lists of device tensors; nothing here waits for the device."""
    choices, bests = [], []
    for pod_table, n in zip(pod_tables, n_live):
        node_table, choice, best = step(node_table, pod_table)
        choices.append(choice[:n])
        bests.append(best[:n])
    return node_table, choices, bests


def schedule_waves(nodes: Sequence[Any], pods: Sequence[Any],
                   wave: int = WAVE, route: str = "fused",
                   device=None) -> WaveRun:
    """Schedule ``pods`` against ``nodes`` in waves of ``wave`` pods.

    ``device=None`` means the card (and raises without one); pass
    ``device="cpu"`` to run the plain twins on the host.  The node table
    is built once; each wave's pod table has capacity ``max(wave, 128)``,
    as in the JAX flow."""
    device = resolve_device(device)
    step = make_step(route)

    t0 = time.monotonic()
    if device.type == "cuda":
        build.load_library()
    kernel_build_s = time.monotonic() - t0

    t0 = time.monotonic()
    node_host, node_names = pack_node_table(nodes, capacity=pad_to(len(nodes)))
    wave_hosts = [
        pack_pod_table(pods[start:start + wave], capacity=max(wave, 128))[0]
        for start in range(0, len(pods), wave)
    ]
    build_s = time.monotonic() - t0

    t0 = time.monotonic()
    node_table = node_host.to_device(device)
    pod_tables = [h.to_device(device) for h in wave_hosts]
    _sync(device)
    h2d_s = time.monotonic() - t0

    t0 = time.monotonic()
    if pod_tables:
        step(node_table, pod_tables[0])  # the step is pure: result dropped
    _sync(device)
    warmup_s = time.monotonic() - t0

    t0 = time.monotonic()
    n_live = [min(wave, len(pods) - start) for start in range(0, len(pods), wave)]
    node_table, choices, bests = run_waves(step, node_table, pod_tables, n_live)
    _sync(device)
    schedule_s = time.monotonic() - t0

    return WaveRun(
        choices=_concat(choices),
        best=_concat(bests),
        node_table=node_table,
        node_names=node_names,
        n_waves=len(pod_tables),
        kernel_build_s=kernel_build_s,
        build_s=build_s,
        h2d_s=h2d_s,
        warmup_s=warmup_s,
        schedule_s=schedule_s,
    )


def _concat(parts: List[torch.Tensor]) -> np.ndarray:
    if not parts:
        return np.zeros(0, np.int64)
    return torch.cat(parts).cpu().numpy().astype(np.int64)
