"""The batch (device) plugin protocol.

A copy of ``BatchEvaluable`` from ``minisched_tpu/framework/plugin.py``:
methods take a ``BatchContext``, a ``PodTable`` and a ``NodeTable`` whose
columns are torch tensors, and return tensors.

Conventions:
  * mask tensors are bool ``(P, N)``; True = feasible.
  * score tensors are int32 ``(P, N)`` in [0, MAX_NODE_SCORE] after
    normalize; raw scores may exceed that before normalize.
  * ``batch_pre_score`` returns an aux dict of tensors, passed to
    ``batch_score`` — the tensor analog of writing CycleState.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

MAX_NODE_SCORE = 100


class BatchEvaluable:
    """Mixin declaring the vectorized form of a plugin."""

    has_batch = True
    #: plugins whose kernels read the constraint tables set this True;
    #: their batch_filter/batch_score take a trailing ``extra`` argument
    needs_extra = False
    #: the constraint-table planes a scan carries for such a plugin
    #: (``"combos"``, ``"volumes"``): each declares its own
    scan_carried_planes: Tuple[str, ...] = ()

    def name(self) -> str:
        raise NotImplementedError

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any):
        raise NotImplementedError

    def batch_pre_score(self, ctx: Any, pods: Any, nodes: Any) -> Dict[str, Any]:
        return {}

    def batch_score(self, ctx: Any, pods: Any, nodes: Any, aux: Dict[str, Any]):
        raise NotImplementedError

    def batch_normalize(self, ctx: Any, scores, mask):
        """Default: identity (plugins without ScoreExtensions)."""
        return scores


def implements_batch(p: Any) -> bool:
    # duck-typed, as the JAX package: delegating wrappers forward
    # ``has_batch`` without subclassing BatchEvaluable
    return bool(getattr(p, "has_batch", False))
