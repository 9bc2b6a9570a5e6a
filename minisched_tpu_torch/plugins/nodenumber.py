"""NodeNumber, batch form: favor nodes whose trailing digit equals the
pod name's (score 10 vs 0).

Counterpart of ``minisched_tpu/plugins/nodenumber.py:97-105``.  The pre-
score state is the pod suffix column; the score is one compare.  The
Permit delays are host-side control-plane behavior and arrive with the
live engine.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from minisched_tpu_torch.framework.plugin import BatchEvaluable

NAME = "NodeNumber"
MATCH_SCORE = 10


class NodeNumber(BatchEvaluable):
    def name(self) -> str:
        return NAME

    def batch_pre_score(self, ctx: Any, pods: Any, nodes: Any) -> Dict[str, Any]:
        return {"pod_suffix": pods.suffix}

    def batch_score(self, ctx: Any, pods: Any, nodes: Any,
                    aux: Dict[str, Any]) -> torch.Tensor:
        pod_suffix = aux["pod_suffix"]  # (P,)
        match = (pod_suffix[:, None] == nodes.suffix[None, :]) & (
            pod_suffix[:, None] >= 0
        ) & (nodes.suffix[None, :] >= 0)
        return torch.where(match, MATCH_SCORE, 0).to(torch.int32)
