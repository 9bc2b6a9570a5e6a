"""The wave driver: many pod waves against one resident NodeTable.

Counterpart of the wave flows of ``bench.py``: every pending pod is
scheduled in waves of ``wave`` pods against a NodeTable that stays on the
device; each wave's placements are committed into the table before the
next wave.  A route is the step that schedules one wave:

* ``"fused"``: the headline chain (``bench_headline``: the
  NodeUnschedulable filter, NodeNumber pre-score and score) as
  ``nodenumber_select_hosts`` (the whole chain in one kernel, reading
  table columns only) plus ``apply_placements``;
* ``"generic"``: the same chain as ``ops.state.wave_step``, whose (P, N)
  planes end in ``fused.select_hosts``; bit-identical with ``"fused"`` in
  choices and final tables;
* ``"repair"``: the node-local roster (``service.config``: the full
  default roster without the plugins that read constraint tables) in
  evaluate-accept-commit rounds (``ops.repair.RepairingEvaluator``, with
  diagnostics), each round ending in ``fused.select_hosts``.  Config 5
  (``fullchain``) runs on it.

Usage (on the card)::

    from minisched_tpu_torch.headline import mk_cluster, schedule_waves
    nodes, pods = mk_cluster()
    run = schedule_waves(nodes, pods)
    print(run.schedule_s, len(pods) / run.schedule_s)
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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
from minisched_tpu_torch.ops.repair import RepairingEvaluator
from minisched_tpu_torch.ops.state import apply_placements, wave_step
from minisched_tpu_torch.plugins.nodenumber import NodeNumber
from minisched_tpu_torch.plugins.nodeunschedulable import NodeUnschedulable
from minisched_tpu_torch.plugins.registry import build_plugins
from minisched_tpu_torch.service.config import node_local_roster_config
from minisched_tpu_torch.utils import build

ROUTES = ("fused", "generic")  # the headline chain's two routes
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


@dataclass
class WaveOut:
    """What a step gives for one wave (device tensors, P rows)."""

    node_table: NodeTable  # the table with the wave's commits
    choice: torch.Tensor  # i32[P] node row per pod, -1 = unplaced
    best: Optional[torch.Tensor] = None  # i32[P] winning score (not repair)
    rounds: int = 1  # evaluate-commit rounds the wave took
    #: repair: filter name → bool[P], a first-failing filter of an
    #: unplaced pod against the wave's final table
    unschedulable: Dict[str, torch.Tensor] = field(default_factory=dict)


def repair_evaluator() -> RepairingEvaluator:
    """The repair route's evaluator: the node-local roster at its weights,
    with diagnostics."""
    cfg = node_local_roster_config()
    chains = build_plugins(cfg)
    return RepairingEvaluator(chains.filter, chains.pre_score, chains.score,
                              weights=cfg.score_weights(),
                              with_diagnostics=True)


def repair_step(evaluator: RepairingEvaluator) -> Callable:
    """The repair route's step around ``evaluator`` (one built with
    ``with_diagnostics``)."""
    names = [pl.name() for pl in evaluator.filter_plugins]

    def step(node_table, pod_table):
        node_table, choice, rounds, unsched = evaluator(pod_table, node_table)
        return WaveOut(node_table, choice, rounds=rounds,
                       unschedulable=dict(zip(names, unsched)))
    return step


def make_step(route: str) -> Callable:
    """``step(node_table, pod_table) -> WaveOut``; a step is pure."""
    if route == "fused":
        def step(node_table, pod_table):
            choice, best = nodenumber_select_hosts(pod_table, node_table)
            return WaveOut(apply_placements(node_table, pod_table, choice),
                           choice, best)
        return step
    if route == "generic":
        nn = NodeNumber()
        filters, pre_scores, scores = (NodeUnschedulable(),), (nn,), (nn,)
        ctx = BatchContext(weights=(("NodeNumber", 1),))

        def step(node_table, pod_table):
            return WaveOut(*wave_step(node_table, pod_table, filters,
                                      pre_scores, scores, ctx))
        return step
    if route == "repair":
        return repair_step(repair_evaluator())
    raise ValueError(f"unknown route {route!r}; expected one of "
                     f"{ROUTES + ('repair',)}")


@dataclass
class WaveRun:
    """What ``schedule_waves`` returns.  Times are host wall seconds, each
    phase closed by a device synchronise on a card."""

    choices: np.ndarray  # int64[n_pods] node row per pod, -1 = unplaced
    best: Optional[np.ndarray]  # int64[n_pods] winning score; None on repair
    rounds: List[int]  # rounds of each wave (always 1 but on repair)
    #: repair: filter name → bool[n_pods] (``WaveOut.unschedulable``)
    unschedulable: Dict[str, np.ndarray]
    node_table: NodeTable  # the resident table after the last wave
    node_names: List[str]
    kernel_build_s: float  # nvcc build (or cache hit) of the kernels
    build_s: float  # host encoding of the node table and every pod wave
    h2d_s: float  # every table copied to the device
    warmup_s: float  # one step whose result is dropped (first launches)
    schedule_s: float  # every wave, node table resident

    @property
    def n_waves(self) -> int:
        return len(self.rounds)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_waves(step: Callable, node_table: NodeTable,
              pod_tables: Sequence[Any]) -> Tuple[NodeTable, List[WaveOut]]:
    """The wave loop: ``step`` each pod table against the resident node
    table.  Returns the final table and each wave's ``WaveOut``; nothing
    here waits for the device but what the step itself reads."""
    outs = []
    for pod_table in pod_tables:
        out = step(node_table, pod_table)
        node_table = out.node_table
        outs.append(out)
    return node_table, outs


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
    starts = range(0, len(pods), wave)
    wave_hosts = [pack_pod_table(pods[s:s + wave], capacity=max(wave, 128))[0]
                  for s in starts]
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
    node_table, outs = run_waves(step, node_table, pod_tables)
    _sync(device)
    schedule_s = time.monotonic() - t0

    # the first n_live rows of each wave; the rest are padding
    n_live = [min(wave, len(pods) - s) for s in starts]
    names = outs[0].unschedulable if outs else {}
    return WaveRun(
        choices=_concat([o.choice[:n] for o, n in zip(outs, n_live)]),
        best=(None if outs and outs[0].best is None else
              _concat([o.best[:n] for o, n in zip(outs, n_live)])),
        rounds=[o.rounds for o in outs],
        unschedulable={
            name: torch.cat([o.unschedulable[name][:n]
                             for o, n in zip(outs, n_live)]).cpu().numpy()
            for name in names},
        node_table=node_table,
        node_names=node_names,
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
