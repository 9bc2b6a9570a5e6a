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
* ``"repair"``: a roster (``cfg``, by default the full default roster
  ``service.config.default_full_roster_config``) in
  evaluate-accept-commit rounds (``ops.repair.RepairingEvaluator``, with
  diagnostics), each round ending in ``fused.select_hosts``.  Config 5
  (``fullchain``) runs on it.  A roster with plugins that
  read constraint tables gets each wave's tables built on the host
  (``ConstraintFeed``): the assigned pods are the caller's plus every pod
  an earlier wave placed, as the live engine counts its assumed binds.
  That takes one read of each wave's choices before the next wave's
  build.  A wave with gang members gets their gang's placed members the
  same way (``engine.gang.PlacedGangs``): its pod table's gang columns
  are rewritten after the previous wave's commit.

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
from minisched_tpu_torch.engine.gang import GangAgg, PlacedGangs
from minisched_tpu_torch.models.constraint_index import ConstraintIndex
from minisched_tpu_torch.models.constraints import (
    ConstraintTables,
    build_constraint_tables,
)
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
from minisched_tpu_torch.service.config import (
    SchedulerConfig,
    default_full_roster_config,
)
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
    #: repair with constraint tables: the wave's tables with the volume
    #: state committed by its last round
    extra: Optional[ConstraintTables] = None


def repair_evaluator(cfg: Optional[SchedulerConfig] = None) -> RepairingEvaluator:
    """The repair route's evaluator: the roster of ``cfg`` (by default the
    full default roster) at its weights, with diagnostics."""
    cfg = cfg or default_full_roster_config()
    chains = build_plugins(cfg)
    return RepairingEvaluator(chains.filter, chains.pre_score, chains.score,
                              weights=cfg.score_weights(),
                              with_diagnostics=True)


class RepairStep:
    """The repair route's step around ``evaluator`` (one built with
    ``with_diagnostics``): ``step(node_table, pod_table, extra=None)``,
    ``extra`` being the wave's constraint tables when the roster reads
    them (``needs_extra``)."""

    def __init__(self, evaluator: RepairingEvaluator):
        self.evaluator = evaluator
        self.needs_extra = evaluator.needs_extra
        self._names = [pl.name() for pl in evaluator.filter_plugins]

    def __call__(self, node_table: NodeTable, pod_table: Any,
                 extra: Optional[ConstraintTables] = None) -> WaveOut:
        out = self.evaluator(pod_table, node_table, extra)
        return WaveOut(out.node_table, out.choice, rounds=out.rounds,
                       unschedulable=dict(zip(self._names, out.unschedulable)),
                       extra=out.extra)


def make_step(route: str, cfg: Optional[SchedulerConfig] = None) -> Callable:
    """``step(node_table, pod_table) -> WaveOut``; a step is pure.  ``cfg``
    is the repair route's roster (``repair_evaluator``); the fixed routes
    ignore it."""
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
        return RepairStep(repair_evaluator(cfg))
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
    #: one step whose result is dropped (first launches; the card only)
    warmup_s: float
    schedule_s: float  # every wave, node table resident
    #: the part of ``schedule_s`` spent building constraint tables on the
    #: host (0 for a roster that reads none)
    constraint_build_s: float = 0.0
    #: repair with constraint tables, per wave: the carried volume planes
    #: after its last round (``node_vols_fam``, ``vol_any``, ``vol_rw``)
    volumes: List[Dict[str, np.ndarray]] = field(default_factory=list)
    #: with gang members, per wave: the gang view its pod table was given
    #: (gang key → placed aggregate; empty without gang members)
    gang_views: List[Dict[str, GangAgg]] = field(default_factory=list)
    #: the part of ``schedule_s`` spent on the gang views and their columns
    gang_view_s: float = 0.0

    @property
    def n_waves(self) -> int:
        return len(self.rounds)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _BoundSpec:
    """A pod spec with ``node_name`` set; its other fields are the
    original spec's."""

    __slots__ = ("_spec", "node_name", "affinity", "volumes")

    def __init__(self, spec: Any, node_name: str):
        self._spec = spec
        self.node_name = node_name
        self.affinity = spec.affinity
        self.volumes = spec.volumes

    def __getattr__(self, name: str) -> Any:
        return getattr(self._spec, name)


class BoundPod:
    """A pending pod as an earlier wave placed it: its metadata, and its
    spec with ``node_name`` set.  The pod itself is not changed, and
    nothing is copied (a copy of each placed pod cost more than the rest
    of the wave's constraint build)."""

    __slots__ = ("metadata", "spec")

    def __init__(self, pod: Any, node_name: str):
        self.metadata = pod.metadata
        self.spec = _BoundSpec(pod.spec, node_name)


class ConstraintFeed:
    """The constraint tables of one batch of pods after another (each
    wave, each scan chunk), built on the host from the objects.  The
    assigned pods are ``assigned`` plus every pod committed since, held
    in one ``ConstraintIndex`` (fed once, then with each commit), so a
    build costs what the batch's own pods and the index's aggregates
    cost, not a walk of every assigned pod.  ``scan_planes`` picks the
    scan lanes' tables; False is the wave mode."""

    def __init__(self, nodes: Sequence[Any], node_names: Sequence[str],
                 assigned: Sequence[Any], pvcs: Sequence[Any],
                 pvs: Sequence[Any], node_capacity: int, device: torch.device,
                 scan_planes: bool = False):
        t0 = time.monotonic()
        self.nodes, self.node_names = nodes, node_names
        self.pvcs, self.pvs = pvcs, pvs
        self.node_capacity = node_capacity
        self.device = device
        self.scan_planes = scan_planes
        by_name = {n.metadata.name: n for n in nodes}
        self.index = ConstraintIndex(
            node_get=by_name.get,
            pvc_get={pvc.metadata.key: pvc for pvc in pvcs}.get,
            pv_get={pv.metadata.name: pv for pv in pvs}.get)
        self.index.add_pods(p for p in assigned if p.spec.node_name)
        #: host time in the index, ``tables`` and ``commit``
        self.build_s = time.monotonic() - t0

    @classmethod
    def for_step(cls, step: Callable, *args: Any,
                 **kw: Any) -> Optional["ConstraintFeed"]:
        """The feed of ``step`` (the constructor's arguments), or None
        when the step reads no constraint tables."""
        return cls(*args, **kw) if getattr(step, "needs_extra", False) else None

    def tables(self, pods: Sequence[Any], pod_capacity: int) -> ConstraintTables:
        t0 = time.monotonic()
        extra = build_constraint_tables(
            pods, self.nodes, (), pod_capacity=pod_capacity,
            node_capacity=self.node_capacity, pvcs=self.pvcs, pvs=self.pvs,
            scan_planes=self.scan_planes, device=self.device,
            index=self.index)
        self.build_s += time.monotonic() - t0
        return extra

    def commit(self, pods: Sequence[Any], rows: Sequence[int]) -> None:
        """The pods of ``pods`` placed on node row ``rows`` (row >= 0)
        join the assigned pods."""
        t0 = time.monotonic()
        self.index.add_pods(BoundPod(pod, self.node_names[c])
                            for pod, c in zip(pods, rows) if c >= 0)
        self.build_s += time.monotonic() - t0


def commit(pods: Sequence[Any], rows: Sequence[int], *sinks: Any) -> None:
    """The placements ``rows`` of ``pods`` into each sink given (a
    ``ConstraintFeed``, a ``PlacedGangs``; None is skipped)."""
    for sink in sinks:
        if sink is not None:
            sink.commit(pods, rows)


def run_waves(step: Callable, node_table: NodeTable,
              pod_tables: Sequence[Any],
              feed: Optional[ConstraintFeed] = None,
              waves: Sequence[Sequence[Any]] = (),
              gangs: Optional[PlacedGangs] = None
              ) -> Tuple[NodeTable, List[WaveOut]]:
    """The wave loop: ``step`` each pod table against the resident node
    table, with the constraint tables of its pods ``waves[i]`` from
    ``feed`` if given, and its gang columns rewritten from ``gangs`` if
    given (wave k's view holds wave k-1's placements, so the tables built
    up front cannot hold it).  Returns the final table and each wave's
    ``WaveOut``; nothing here waits for the device but what the step
    reads and the read of each wave's choices for the commits."""
    outs = []
    for i, pod_table in enumerate(pod_tables):
        if gangs is not None:
            pod_table = gangs.rewrite(pod_table, waves[i])
        if feed is None:
            out = step(node_table, pod_table)
        else:
            out = step(node_table, pod_table,
                       feed.tables(waves[i], pod_table.capacity))
        if feed is not None or gangs is not None:
            commit(waves[i], out.choice[: len(waves[i])].tolist(), feed,
                   gangs)
        node_table = out.node_table
        outs.append(out)
    return node_table, outs


def pods_by_node(assigned: Sequence[Any]) -> Dict[str, List[Any]]:
    """``assigned`` pods grouped by ``spec.node_name``."""
    out: Dict[str, List[Any]] = {}
    for p in assigned:
        out.setdefault(p.spec.node_name, []).append(p)
    return out


def schedule_waves(nodes: Sequence[Any], pods: Sequence[Any],
                   wave: int = WAVE, route: str = "fused", device=None,
                   cfg: Optional[SchedulerConfig] = None,
                   assigned: Sequence[Any] = (), pvcs: Sequence[Any] = (),
                   pvs: Sequence[Any] = ()) -> WaveRun:
    """Schedule ``pods`` against ``nodes`` in waves of ``wave`` pods.

    ``device=None`` means the card (and raises without one); pass
    ``device="cpu"`` to run the plain twins on the host.  The node table
    is built once, holding the ``assigned`` pods (each with
    ``spec.node_name`` set); each wave's pod table has capacity
    ``max(wave, 128)``, as in the JAX flow.  ``cfg`` is the repair
    route's roster; ``pvcs`` and ``pvs`` feed its constraint tables."""
    device = resolve_device(device)
    step = make_step(route, cfg)

    t0 = time.monotonic()
    if device.type == "cuda":
        build.load_library()
    kernel_build_s = time.monotonic() - t0

    t0 = time.monotonic()
    node_cap, pod_cap = pad_to(len(nodes)), max(wave, 128)
    node_host, node_names = pack_node_table(nodes, pods_by_node(assigned),
                                            capacity=node_cap)
    starts = range(0, len(pods), wave)
    wave_pods = [pods[s:s + wave] for s in starts]
    wave_hosts = [pack_pod_table(batch, capacity=pod_cap)[0]
                  for batch in wave_pods]
    build_s = time.monotonic() - t0

    t0 = time.monotonic()
    node_table = node_host.to_device(device)
    pod_tables = [h.to_device(device) for h in wave_hosts]
    synchronize(device)
    h2d_s = time.monotonic() - t0

    def feeds() -> Tuple[Optional[ConstraintFeed], Optional[PlacedGangs]]:
        return (ConstraintFeed.for_step(step, nodes, node_names, assigned,
                                        pvcs, pvs, node_cap, device),
                PlacedGangs.for_pods(pods, nodes, assigned))

    t0 = time.monotonic()
    if pod_tables and device.type == "cuda":  # the step is pure: dropped
        warm_feed, warm_gangs = feeds()
        run_waves(step, node_table, pod_tables[:1], warm_feed, wave_pods,
                  warm_gangs)
    synchronize(device)
    warmup_s = time.monotonic() - t0

    t0 = time.monotonic()
    timed_feed, gangs = feeds()
    node_table, outs = run_waves(step, node_table, pod_tables, timed_feed,
                                 wave_pods, gangs)
    synchronize(device)
    schedule_s = time.monotonic() - t0

    # the first n_live rows of each wave; the rest are padding
    n_live = [len(batch) for batch in wave_pods]
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
        constraint_build_s=timed_feed.build_s if timed_feed else 0.0,
        volumes=[{name: getattr(o.extra, name).cpu().numpy()
                  for name in ("node_vols_fam", "vol_any", "vol_rw")}
                 for o in outs if o.extra is not None],
        gang_views=gangs.views if gangs else [],
        gang_view_s=gangs.view_s if gangs else 0.0,
    )


def _concat(parts: List[torch.Tensor]) -> np.ndarray:
    if not parts:
        return np.zeros(0, np.int64)
    return torch.cat(parts).cpu().numpy().astype(np.int64)
