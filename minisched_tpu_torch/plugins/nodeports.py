"""NodePorts: reject nodes where a requested host port is already
claimed by an assigned pod.

Counterpart of ``minisched_tpu/plugins/nodeports.py``: the scalar filter
over the node's pods, and the batch filter, unrolled over the pod's port
slots as there, so the largest intermediate is one
(P, N, Wn) compare, reduced over the node's slots by ``any_last_axis``
(torch's own reduce over 8 slots is the slow part).  Commits add ports
to ``used_port``, so the repair loop re-evaluates the filter every round.
"""

from __future__ import annotations

from typing import Any, List

import torch

from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.framework.types import CycleState, Status
from minisched_tpu_torch.utils.reduce import any_last_axis

NAME = "NodePorts"


def _pod_ports(pod: Any) -> List[int]:
    out: List[int] = []
    for c in pod.spec.containers:
        out.extend(c.ports)
    return out


class NodePorts(BatchEvaluable):
    reads_committed_state = True  # intra-wave commits change the verdict

    def events_to_register(self) -> List[ClusterEvent]:
        """The cluster events that may make a pod this plugin rejected
        schedulable again (the JAX plugin's registration)."""
        return [ClusterEvent(GVK.POD, ActionType.DELETE)]

    def name(self) -> str:
        return NAME

    def filter(self, state: CycleState, pod: Any, node_info: Any) -> Status:
        wanted = _pod_ports(pod)
        if not wanted:
            return Status.success()
        in_use = set()
        for p in node_info.pods:
            in_use.update(_pod_ports(p))
        if any(port in in_use for port in wanted):
            return Status.unschedulable(
                "node(s) didn't have free ports for the requested pod ports"
            ).with_plugin(NAME)
        return Status.success()

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any) -> torch.Tensor:
        P, Wp = pods.port.shape
        N, Wn = nodes.used_port.shape
        dev = pods.port.device
        want_in_range = torch.arange(Wp, device=dev)[None, :] < pods.num_ports[:, None]
        used_in_range = (torch.arange(Wn, device=dev)[None, :]
                         < nodes.num_used_ports[:, None])  # (N, Wn)
        clash = torch.zeros((P, N), dtype=torch.bool, device=dev)
        for j in range(Wp):
            eq = pods.port[:, j][:, None, None] == nodes.used_port[None, :, :]
            eq &= used_in_range[None, :, :]
            clash |= want_in_range[:, j][:, None] & any_last_axis(eq)
        return ~clash
