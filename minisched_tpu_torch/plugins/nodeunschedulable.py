"""NodeUnschedulable, batch form: reject nodes with ``spec.unschedulable``
unless the pod tolerates the ``node.kubernetes.io/unschedulable`` taint.

Counterpart of ``minisched_tpu/plugins/nodeunschedulable.py:59-81``.
"""

from __future__ import annotations

from typing import Any

import torch

from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.models import tables
from minisched_tpu_torch.utils.hashing import fnv1a32

NAME = "NodeUnschedulable"

TAINT_NODE_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"
_UNSCHED_KEY_HASH = fnv1a32(TAINT_NODE_UNSCHEDULABLE)
_EMPTY_VALUE_HASH = fnv1a32("")


class NodeUnschedulable(BatchEvaluable):
    def name(self) -> str:
        return NAME

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any) -> torch.Tensor:
        """mask[p, n] = ~node.unschedulable | pod-tolerates-unschedulable."""
        return (~nodes.unschedulable)[None, :] | tolerates_unschedulable(pods)[
            :, None
        ]


def tolerates_unschedulable(pods: Any) -> torch.Tensor:
    """bool[P]: the pod tolerates the node.kubernetes.io/unschedulable
    taint — the pod-only half of the filter (also the prologue of the
    fused NodeNumber kernel)."""
    tol_slots = torch.arange(pods.tol_key.shape[1], device=pods.tol_key.device)
    in_range = tol_slots[None, :] < pods.num_tols[:, None]  # (P, T)
    effect_ok = (pods.tol_effect == tables.EFFECT_NONE) | (
        pods.tol_effect == tables.EFFECT_NO_SCHEDULE
    )
    key_matches = pods.tol_key == _UNSCHED_KEY_HASH
    exists = pods.tol_op == tables.TOLERATION_OP_EXISTS_CODE
    # Equal with an empty value tolerates (the taint's value is ""),
    # Exists always does
    value_ok = exists | (pods.tol_value == _EMPTY_VALUE_HASH)
    wildcard = pods.tol_empty_key & exists
    return torch.any(
        in_range & effect_ok & (wildcard | (key_matches & value_ok)), dim=1
    )
