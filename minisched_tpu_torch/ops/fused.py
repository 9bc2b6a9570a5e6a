"""The fused (pods × nodes) evaluator in PyTorch.

Counterpart of ``minisched_tpu/ops/fused.py``: every registered plugin
evaluates as a tensor predicate or score over the struct-of-arrays
tables, and the chain

    filter → pre-score → score → normalize → weighted-sum → masked-argmax

ends in ``select_hosts`` (from ``ops.kernels``), the seeded masked argmax
(bit-exact with the scalar ``engine.tiebreak.select_host``).

There is no routing flag: ``select_hosts`` takes the plain twin for a CPU
tensor and the hand-written kernel for a CUDA tensor, at any shape.  The
JAX package's ``static=`` planes and diagnostics arrive with the repair
and diagnostics slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from minisched_tpu_torch.framework.plugin import implements_batch
from minisched_tpu_torch.ops.kernels import mix32_plain as mix32
from minisched_tpu_torch.ops.kernels import select_hosts

__all__ = [
    "BatchContext",
    "FusedEvaluator",
    "PlacementResult",
    "evaluate",
    "mix32",
    "select_hosts",
]


@dataclass(frozen=True)
class BatchContext:
    """Per-evaluator configuration handed to the batch plugins."""

    weights: Tuple[Tuple[str, int], ...] = ()

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


def evaluate(
    pods: Any,
    nodes: Any,
    filter_plugins: Sequence[Any],
    pre_score_plugins: Sequence[Any],
    score_plugins: Sequence[Any],
    ctx: BatchContext,
) -> PlacementResult:
    """One fused scheduling evaluation: the conjunction of the filter
    masks, per-plugin pre-score aux tensors, normalized and weighted
    scores summed, then ``select_hosts``."""
    mask = pods.valid[:, None] & nodes.valid[None, :]
    for pl in filter_plugins:
        mask = mask & pl.batch_filter(ctx, pods, nodes)

    aux: Dict[str, Dict[str, Any]] = {}
    for pl in pre_score_plugins:
        aux[pl.name()] = pl.batch_pre_score(ctx, pods, nodes)

    totals = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    for pl in score_plugins:
        s = pl.batch_score(ctx, pods, nodes, aux.get(pl.name(), {}))
        s = pl.batch_normalize(ctx, s, mask)
        totals = totals + s.to(torch.int32) * ctx.weight_of(pl.name())

    choice, best = select_hosts(totals, mask, pods.seed)
    return PlacementResult(
        choice=choice,
        best_score=best,
        feasible_count=mask.sum(dim=1, dtype=torch.int32),
    )


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
    ):
        validate_batch_chains(filter_plugins, pre_score_plugins, score_plugins)
        self.filter_plugins = tuple(filter_plugins)
        self.pre_score_plugins = tuple(pre_score_plugins)
        self.score_plugins = tuple(score_plugins)
        self.ctx = BatchContext(weights=tuple(sorted((weights or {}).items())))

    def __call__(self, pods: Any, nodes: Any) -> PlacementResult:
        return evaluate(
            pods, nodes, self.filter_plugins, self.pre_score_plugins,
            self.score_plugins, self.ctx,
        )
