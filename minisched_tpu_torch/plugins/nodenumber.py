"""NodeNumber: favor nodes whose trailing digit equals the pod name's
(score 10 vs 0), and delay each bind by the chosen node's digit.

Counterpart of ``minisched_tpu/plugins/nodenumber.py``.  Scalar form:
PreScore writes the pod's digit into the CycleState (nothing without one,
and then Score errors, as the reference does).  Batch form (``:97-105``): the
pre-score state is the pod suffix column; the score is one compare.  Permit (``:77-91``) stays on the host: it answers Wait and
arms a timer that Allows the pod after {node suffix} × ``time_scale``
seconds, with a 10 s × ``time_scale`` timeout; ``h`` is the engine's
waiting-pod handle, injected by ``new_device_scheduler``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.framework.types import CycleState, Status

NAME = "NodeNumber"
PRE_SCORE_STATE_KEY = "PreScore" + NAME
MATCH_SCORE = 10
PERMIT_TIMEOUT_S = 10.0


def _suffix_number(name: str) -> Optional[int]:
    if name and name[-1].isdigit():
        return int(name[-1])
    return None


class NodeNumber(BatchEvaluable):
    def __init__(self, time_scale: float = 1.0):
        #: the engine's waiting-pod handle (``get_waiting_pod``)
        self.h: Any = None
        self.time_scale = time_scale

    def name(self) -> str:
        return NAME

    def pre_score(self, state: CycleState, pod: Any,
                  nodes: List[Any]) -> Status:
        num = _suffix_number(pod.metadata.name)
        if num is not None:  # success even without a digit suffix
            state.write(PRE_SCORE_STATE_KEY, num)
        return Status.success()

    def score(self, state: CycleState, pod: Any,
              node_name: str) -> Tuple[int, Status]:
        try:
            podnum = state.read(PRE_SCORE_STATE_KEY)
        except KeyError as e:
            # the reference errors when PreScore wrote nothing
            return 0, Status.from_error(e).with_plugin(NAME)
        nodenum = _suffix_number(node_name)
        if nodenum is not None and podnum == nodenum:
            return MATCH_SCORE, Status.success()
        return 0, Status.success()

    def score_extensions(self) -> None:
        return None

    def events_to_register(self) -> List[ClusterEvent]:
        """The cluster events that may make a pod this plugin rejected
        schedulable again (the JAX plugin's registration)."""
        return [ClusterEvent(GVK.NODE, ActionType.ADD)]

    def permit(self, state: CycleState, pod: Any,
               node_name: str) -> Tuple[Status, float]:
        nodenum = _suffix_number(node_name)
        if nodenum is None:
            return Status.success(), 0.0
        handle = self.h

        def _allow() -> None:
            wp = handle.get_waiting_pod(pod.metadata.uid) if handle else None
            if wp is not None:
                wp.allow(NAME)

        t = threading.Timer(nodenum * self.time_scale, _allow)
        t.daemon = True
        t.start()
        return Status.wait(), PERMIT_TIMEOUT_S * self.time_scale

    def batch_pre_score(self, ctx: Any, pods: Any, nodes: Any) -> Dict[str, Any]:
        return {"pod_suffix": pods.suffix}

    def batch_score(self, ctx: Any, pods: Any, nodes: Any,
                    aux: Dict[str, Any]) -> torch.Tensor:
        pod_suffix = aux["pod_suffix"]  # (P,)
        match = (pod_suffix[:, None] == nodes.suffix[None, :]) & (
            pod_suffix[:, None] >= 0
        ) & (nodes.suffix[None, :] >= 0)
        return torch.where(match, MATCH_SCORE, 0).to(torch.int32)
