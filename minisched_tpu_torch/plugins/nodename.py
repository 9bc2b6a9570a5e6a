"""NodeName: a pod pinned through ``spec.nodeName`` fits only that node.

Counterpart of ``minisched_tpu/plugins/nodename.py``: the scalar filter,
and the batch filter as one hash comparison against the node-name column.
"""

from __future__ import annotations

from typing import Any

import torch

from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.framework.types import CycleState, Status

NAME = "NodeName"


class NodeName(BatchEvaluable):
    def name(self) -> str:
        return NAME

    def filter(self, state: CycleState, pod: Any, node_info: Any) -> Status:
        node = node_info.node
        if node is None:
            return Status.unresolvable("node not found")
        if pod.spec.node_name and pod.spec.node_name != node.metadata.name:
            return Status.unresolvable(
                "node(s) didn't match the requested node name"
            ).with_plugin(NAME)
        return Status.success()

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any) -> torch.Tensor:
        pinned = pods.spec_node_name != 0
        match = pods.spec_node_name[:, None] == nodes.name_hash[None, :]
        return match | ~pinned[:, None]
