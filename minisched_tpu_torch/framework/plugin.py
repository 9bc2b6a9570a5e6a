"""The plugin protocol: the scalar and batch halves and the host points.

A copy of ``minisched_tpu/framework/plugin.py``: the scalar protocol
(per-(pod, node) methods mirroring the upstream signatures, which the
scalar engine ``engine/scheduler.py`` and DefaultPreemption's dry run
call, one pod at a time), ``BatchEvaluable`` (the device half) and the
capability probes.  The live engines run the host points (permit,
reserve, post-filter) and read each plugin's ``events_to_register`` (the
cluster events that may make a pod the plugin rejected schedulable
again) for their event-gated requeue.

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

from typing import Any, Dict, List, Optional, Protocol, Tuple

from minisched_tpu_torch.framework.types import (
    MAX_NODE_SCORE,
    CycleState,
    NodeScoreList,
    Status,
)


class PreFilterPlugin(Protocol):
    """Once-per-pod prep before the per-node filter loop (cross-pod
    plugins aggregate cluster-wide state here)."""

    def pre_filter(self, state: CycleState, pod: Any,
                   node_infos: List[Any]) -> Status: ...


class FilterPlugin(Protocol):
    def filter(self, state: CycleState, pod: Any, node_info: Any) -> Status:
        """Reject or accept one (pod, node) pair."""
        ...


class PostFilterPlugin(Protocol):
    def post_filter(self, state: CycleState, pod: Any, node_infos: List[Any],
                    diagnosis: Any) -> Tuple[Optional[str], Status]:
        """Try to make the pod schedulable (by evicting victims): returns
        the nominated node or None, and a status.  An evicting plugin
        records the pods it deleted in ``last_victims``, reset at the
        start of each call."""
        ...


class PreScorePlugin(Protocol):
    def pre_score(self, state: CycleState, pod: Any,
                  nodes: List[Any]) -> Status: ...


class ScoreExtensions(Protocol):
    def normalize_score(self, state: CycleState, pod: Any,
                        scores: NodeScoreList) -> Status:
        """Rescale a plugin's raw node scores in place."""
        ...


class ScorePlugin(Protocol):
    def score(self, state: CycleState, pod: Any,
              node_name: str) -> Tuple[int, Status]: ...

    def score_extensions(self) -> Optional[ScoreExtensions]: ...


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


def implements_filter(p: Any) -> bool:
    return callable(getattr(p, "filter", None))


def implements_pre_score(p: Any) -> bool:
    return callable(getattr(p, "pre_score", None))


def implements_score(p: Any) -> bool:
    return callable(getattr(p, "score", None))


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
