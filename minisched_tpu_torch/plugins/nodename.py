"""NodeName, batch form: a pod pinned through ``spec.nodeName`` fits only
that node.

Counterpart of ``minisched_tpu/plugins/nodename.py:35-38``: one hash
comparison against the node-name column.
"""

from __future__ import annotations

from typing import Any

import torch

from minisched_tpu_torch.framework.plugin import BatchEvaluable

NAME = "NodeName"


class NodeName(BatchEvaluable):
    def name(self) -> str:
        return NAME

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any) -> torch.Tensor:
        pinned = pods.spec_node_name != 0
        match = pods.spec_node_name[:, None] == nodes.name_hash[None, :]
        return match | ~pinned[:, None]
