"""The fused (pods × nodes) evaluator in PyTorch.

Counterpart of ``minisched_tpu/ops/fused.py``: every registered plugin
evaluates as a tensor predicate or score over the struct-of-arrays
tables, and the chain

    filter → pre-score → score → normalize → weighted-sum → masked-argmax

ends in ``select_hosts`` (from ``ops.kernels``), the seeded masked argmax
(bit-exact with the scalar ``engine.tiebreak.select_host``).

There is no routing flag: ``select_hosts`` takes the plain twin for a CPU
tensor and the hand-written kernel for a CUDA tensor, at any shape.
Under a device mesh (``parallel/sharding.py``) ``evaluate`` runs on one
(pod shard, node shard) tile: the kernel gets the tile's node-index base
and the node shards' partials merge into the whole rows' argmax, as do
the feasible count and the diagnostics' ``any``; off a mesh each merge is
the identity.

``precompute_static`` and ``evaluate(static=)`` split a repair wave's
chain into the round-invariant half (computed once) and the plugins that
read committed state (every round); ``with_diagnostics`` keeps every
filter's mask and every scorer's raw and weighted planes. Plugins that
read the wave's constraint tables (``needs_extra``: the volume and
cross-pod plugins) get them as the ``extra`` argument
(``models/constraints.ConstraintTables``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from minisched_tpu_torch.framework.plugin import implements_batch
from minisched_tpu_torch.ops.kernels import mix32_plain as mix32
from minisched_tpu_torch.ops.kernels import select_hosts
from minisched_tpu_torch.parallel import sharding

__all__ = [
    "BatchContext",
    "FusedEvaluator",
    "PlacementResult",
    "StaticWavePlanes",
    "evaluate",
    "mix32",
    "precompute_static",
    "select_hosts",
    "unschedulable_plugin_masks",
    "wave_planes",
]


@dataclass(frozen=True)
class BatchContext:
    """Per-evaluator configuration handed to the batch plugins."""

    weights: Tuple[Tuple[str, int], ...] = ()
    #: True only inside the sequential scan lanes (``ops/sequential.py``):
    #: InterPodAffinity then also applies the anti-affinity of pods
    #: committed earlier in the scan (``combo_excl``)
    in_scan: bool = False

    def weight_of(self, name: str) -> int:
        for n, w in self.weights:
            if n == name:
                return w
        return 1


@dataclass
class PlacementResult:
    """Result of one fused evaluation."""

    choice: torch.Tensor  # i32[P] node index, -1 = unschedulable
    best_score: torch.Tensor  # i32[P]
    feasible_count: torch.Tensor  # i32[P]
    #: bool[K, P, N] per-filter-plugin pass masks (``with_diagnostics``)
    filter_masks: Optional[torch.Tensor] = None
    #: i32[K, P, N] per-score-plugin normalized and weighted planes
    #: (``with_diagnostics``)
    score_matrices: Optional[torch.Tensor] = None
    #: i32[K, P, N] per-score-plugin raw planes, before normalize and
    #: weight (``with_diagnostics``)
    raw_score_matrices: Optional[torch.Tensor] = None


@dataclass
class StaticWavePlanes:
    """Round-invariant planes shared by every round of a repair wave.

    Filters and scores of plugins with ``reads_committed_state`` False
    give the same mask and RAW score in every round; the repair loop
    computes them once and per round re-evaluates only the committed-state
    plugins, then re-normalizes the cached raw scores against the round's
    full mask: bit-identical to evaluating the whole chain every round."""

    static_mask: torch.Tensor  # bool[P, N] conjunction of static filter masks
    static_names: frozenset  # names of the filters folded into static_mask
    aux: Dict[str, Dict[str, Any]]  # pre-score aux (static plugins only)
    raw_scores: Dict[str, torch.Tensor]  # plugin name → i32[P, N] raw score


def _is_dynamic(pl: Any) -> bool:
    return bool(getattr(pl, "reads_committed_state", False))


def _needs_extra(pl: Any) -> bool:
    return bool(getattr(pl, "needs_extra", False))


def chains_need_extra(*chains: Sequence[Any]) -> bool:
    """Some plugin of ``chains`` reads the constraint tables."""
    return any(_needs_extra(pl) for chain in chains for pl in chain)


def run_filter(pl: Any, ctx: BatchContext, pods: Any, nodes: Any,
               extra: Any) -> torch.Tensor:
    """``pl.batch_filter``, with the constraint tables if it reads them."""
    if _needs_extra(pl):
        return pl.batch_filter(ctx, pods, nodes, extra)
    return pl.batch_filter(ctx, pods, nodes)


def run_score(pl: Any, ctx: BatchContext, pods: Any, nodes: Any,
              aux: Dict[str, Any], extra: Any) -> torch.Tensor:
    """``pl.batch_score``, with the constraint tables if it reads them."""
    if _needs_extra(pl):
        return pl.batch_score(ctx, pods, nodes, aux, extra)
    return pl.batch_score(ctx, pods, nodes, aux)


def precompute_static(pods: Any, nodes: Any, filter_plugins: Sequence[Any],
                      pre_score_plugins: Sequence[Any],
                      score_plugins: Sequence[Any],
                      ctx: BatchContext, extra: Any = None,
                      extra_dynamic: frozenset = frozenset()
                      ) -> StaticWavePlanes:
    """Evaluate the round-invariant half of the chain once.

    ``extra_dynamic``: names of plugins to treat as round-varying besides
    those with ``reads_committed_state``: the blocked scan lane passes the
    plugins whose carried coupling planes change from block to block."""

    def static(pl: Any) -> bool:
        return not _is_dynamic(pl) and pl.name() not in extra_dynamic

    mask = pods.valid[:, None] & nodes.valid[None, :]
    names = []
    for pl in filter_plugins:
        if static(pl):
            names.append(pl.name())
            mask = mask & run_filter(pl, ctx, pods, nodes, extra)
    aux = {pl.name(): pl.batch_pre_score(ctx, pods, nodes)
           for pl in pre_score_plugins if static(pl)}
    raw = {pl.name(): run_score(pl, ctx, pods, nodes, aux.get(pl.name(), {}),
                                extra)
           for pl in score_plugins if static(pl)}
    return StaticWavePlanes(mask, frozenset(names), aux, raw)


@dataclass
class WavePlanes:
    """The (P, N) planes one evaluation hands to ``select_hosts``."""

    totals: torch.Tensor  # i32[P, N] weighted score sum
    mask: torch.Tensor  # bool[P, N] feasibility
    per_filter: List[torch.Tensor]  # diagnostics only
    per_score: List[torch.Tensor]  # diagnostics only: weighted planes
    per_raw: List[torch.Tensor]  # diagnostics only: raw planes


def wave_planes(pods: Any, nodes: Any, filter_plugins: Sequence[Any],
                pre_score_plugins: Sequence[Any],
                score_plugins: Sequence[Any], ctx: BatchContext,
                with_diagnostics: bool = False,
                static: Optional[StaticWavePlanes] = None,
                extra: Any = None) -> WavePlanes:
    """The filter conjunction and the weighted score sum of one
    evaluation (``evaluate`` without its argmax)."""
    mask = pods.valid[:, None] & nodes.valid[None, :]
    run_filters = list(filter_plugins)
    if static is not None:
        if with_diagnostics:
            raise ValueError("diagnostics need the unsplit chain")
        mask &= static.static_mask
        run_filters = [pl for pl in filter_plugins
                       if pl.name() not in static.static_names]
    per_filter = []
    for pl in run_filters:
        m = run_filter(pl, ctx, pods, nodes, extra)
        if with_diagnostics:
            per_filter.append(m)
        mask &= m

    aux: Dict[str, Dict[str, Any]] = dict(static.aux) if static else {}
    for pl in pre_score_plugins:
        if pl.name() not in aux:
            aux[pl.name()] = pl.batch_pre_score(ctx, pods, nodes)

    totals = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    per_score, per_raw = [], []
    for pl in score_plugins:
        if static is not None and pl.name() in static.raw_scores:
            s = static.raw_scores[pl.name()]
        else:
            s = run_score(pl, ctx, pods, nodes, aux.get(pl.name(), {}), extra)
        if with_diagnostics:
            per_raw.append(s.to(torch.int32))
        s = pl.batch_normalize(ctx, s, mask).to(torch.int32)
        weight = ctx.weight_of(pl.name())
        if with_diagnostics:
            per_score.append(s * weight)
        # int32: wraps as jnp's sum does
        totals.add_(s, alpha=weight)
    return WavePlanes(totals, mask, per_filter, per_score, per_raw)


def evaluate(
    pods: Any,
    nodes: Any,
    filter_plugins: Sequence[Any],
    pre_score_plugins: Sequence[Any],
    score_plugins: Sequence[Any],
    ctx: BatchContext,
    with_diagnostics: bool = False,
    static: Optional[StaticWavePlanes] = None,
    extra: Any = None,
) -> PlacementResult:
    """One fused scheduling evaluation: the conjunction of the filter
    masks, per-plugin pre-score aux tensors, normalized and weighted
    scores summed, then ``select_hosts``.

    ``static``: precomputed round-invariant planes; static filters enter
    through ``static_mask`` and static scorers reuse their cached RAW
    matrices (normalized against THIS call's full mask).  Incompatible
    with ``with_diagnostics``, whose per-plugin masks need every filter.
    ``extra``: the wave's ConstraintTables, for the plugins that read them."""
    planes = wave_planes(pods, nodes, filter_plugins, pre_score_plugins,
                         score_plugins, ctx, with_diagnostics, static, extra)
    choice, best = sharding.merge_select(
        *select_hosts(planes.totals, planes.mask, pods.seed,
                      sharding.node_base()), pods.seed)

    def stacked(planes_: List[torch.Tensor]) -> Optional[torch.Tensor]:
        return torch.stack(planes_) if planes_ else None

    return PlacementResult(
        choice=choice,
        best_score=best,
        feasible_count=sharding.node_sum(
            planes.mask.sum(dim=1, dtype=torch.int32)),
        filter_masks=stacked(planes.per_filter),
        score_matrices=stacked(planes.per_score),
        raw_score_matrices=stacked(planes.per_raw),
    )


def unschedulable_plugin_masks(filter_masks: torch.Tensor,
                               valid: torch.Tensor) -> torch.Tensor:
    """bool[K, P]: filter plugin k is a FIRST-failing plugin for pod p on
    some node: per node only the first plugin in chain order that rejects
    is recorded, and a pod's set is the union over nodes.

    ``filter_masks`` bool[K, P, N] per-plugin pass masks; ``valid``
    bool[P, N] the pod × node validity mask."""
    prefix = valid
    out = []
    for k in range(filter_masks.shape[0]):
        m = filter_masks[k]
        out.append(sharding.node_any((prefix & ~m).any(dim=1)))
        prefix = prefix & m
    return torch.stack(out)


def validate_batch_chains(*chains: Sequence[Any]) -> None:
    """Every plugin of a device chain must implement the batch protocol."""
    for chain in chains:
        for pl in chain:
            if not implements_batch(pl):
                raise TypeError(
                    f"plugin {pl.name()} has no batch form; "
                    "scalar-only plugins must run through the engine"
                )


class FusedEvaluator:
    """Plugin chains fixed at construction; tables vary per call."""

    def __init__(
        self,
        filter_plugins: Sequence[Any],
        pre_score_plugins: Sequence[Any],
        score_plugins: Sequence[Any],
        weights: Optional[Dict[str, int]] = None,
        with_diagnostics: bool = False,
    ):
        validate_batch_chains(filter_plugins, pre_score_plugins, score_plugins)
        self.filter_plugins = tuple(filter_plugins)
        self.pre_score_plugins = tuple(pre_score_plugins)
        self.score_plugins = tuple(score_plugins)
        self.ctx = BatchContext(weights=tuple(sorted((weights or {}).items())))
        self.with_diagnostics = with_diagnostics

    def __call__(self, pods: Any, nodes: Any,
                 extra: Any = None) -> PlacementResult:
        return evaluate(
            pods, nodes, self.filter_plugins, self.pre_score_plugins,
            self.score_plugins, self.ctx,
            with_diagnostics=self.with_diagnostics, extra=extra,
        )
