"""The plugin protocol: the batch (device) half and the host extension points.

A copy of ``minisched_tpu/framework/plugin.py``'s ``BatchEvaluable``,
``Plugin`` and capability probes.  The live engine runs the host points
(permit, reserve, post-filter) and reads each plugin's
``events_to_register`` (the cluster events that may make a pod the plugin
rejected schedulable again) for its event-gated requeue.  The scalar
per-(pod, node) filter and score halves are not ported.

``BatchEvaluable`` methods take a ``BatchContext``, a ``PodTable`` and a ``NodeTable`` whose
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


class Plugin:
    """Base of the host-only plugins (Coscheduling, DefaultPreemption):
    a stable name."""

    def name(self) -> str:
        return type(self).__name__


def implements_post_filter(p: Any) -> bool:
    return callable(getattr(p, "post_filter", None))


def implements_permit(p: Any) -> bool:
    return callable(getattr(p, "permit", None))


def implements_reserve(p: Any) -> bool:
    # both halves: a reserve without its rollback would crash the
    # unguarded unreserve path on the first permit or bind failure
    return callable(getattr(p, "reserve", None)) and callable(
        getattr(p, "unreserve", None)
    )


def implements_pre_filter(p: Any) -> bool:
    return callable(getattr(p, "pre_filter", None))


def implements_enqueue(p: Any) -> bool:
    return callable(getattr(p, "events_to_register", None))


def implements_batch(p: Any) -> bool:
    # duck-typed, as the JAX package: delegating wrappers forward
    # ``has_batch`` without subclassing BatchEvaluable
    return bool(getattr(p, "has_batch", False))
