"""Min-max score normalization, scalar and batch forms.

Counterpart of ``minisched_tpu/plugins/normalize.py``: both cross-pod
plugins rescale raw scores to [0, MAX_NODE_SCORE] over the feasible
nodes; InterPodAffinity keeps the direction, PodTopologySpread reverses
it.  One implementation per form keeps the two plugins' rounding
identical.  The batch form is int32 throughout, wrapping and flooring as
``jnp`` does: rows with no feasible node (whose result no one reads)
come out the same too.
"""

from __future__ import annotations

import torch

from minisched_tpu_torch.framework.types import MAX_NODE_SCORE, NodeScoreList
from minisched_tpu_torch.parallel import sharding

_BIG = torch.iinfo(torch.int32).max


def minmax_normalize_scalar(scores: NodeScoreList, reverse: bool,
                            fill: int) -> None:
    """In-place min-max rescale of a NodeScoreList; all-equal → ``fill``."""
    if not scores:
        return
    lo = min(ns.score for ns in scores)
    hi = max(ns.score for ns in scores)
    for ns in scores:
        if hi == lo:
            ns.score = fill
        elif reverse:
            ns.score = MAX_NODE_SCORE * (hi - ns.score) // (hi - lo)
        else:
            ns.score = MAX_NODE_SCORE * (ns.score - lo) // (hi - lo)


def minmax_normalize_batch(scores: torch.Tensor, mask: torch.Tensor,
                           reverse: bool, fill: int) -> torch.Tensor:
    """Mask-aware min-max over each row's feasible nodes; floor division
    (``torch.div(..., rounding_mode="floor")``, as ``jnp``'s ``//``); a
    row whose feasible scores are all equal gets ``fill``."""
    scores = scores.to(torch.int32)
    lo = sharding.node_min(
        torch.where(mask, scores, _BIG).amin(dim=1, keepdim=True))
    hi = sharding.node_max(
        torch.where(mask, scores, -_BIG).amax(dim=1, keepdim=True))
    spread = hi - lo
    num = (hi - scores) if reverse else (scores - lo)
    out = torch.div(MAX_NODE_SCORE * num, spread.clamp(min=1),
                    rounding_mode="floor")
    return torch.where(spread > 0, out, fill).to(torch.int32)
