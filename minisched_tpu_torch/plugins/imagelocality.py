"""ImageLocality, batch form: favor nodes that already cache the pod's
container images.

Counterpart of ``minisched_tpu/plugins/imagelocality.py:88-115``, with the
same integer formula:

    scaled(image) = size_mb * nodes_with_image // total_nodes
    sum(p, n)     = Σ over the pod's containers whose image node n has
    score(p, n)   = clamp((sum - 23*C) * 100 // (1000*C - 23*C), 0, 100)

The JAX kernel broadcasts a (P, C, N, I) predicate that XLA fuses away;
eager PyTorch would write it out (5.3 G elements at 16,384 pods × 10,112
nodes).  Here the work is split so the largest intermediate is one
(P, N, I) compare, for one container slot at a time:

* the image's canonical size (the largest per-node sum of matching slot
  sizes) is a per-image quantity, computed once over the N × I node
  slots (sort, segment max) and looked up by each pod's image key;
* the has-image plane per container slot gives both the node count and
  the per-node sum.

Bit-identical to the JAX kernel, hash collisions included.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from minisched_tpu_torch.framework.plugin import MAX_NODE_SCORE, BatchEvaluable
from minisched_tpu_torch.utils.reduce import any_last_axis

NAME = "ImageLocality"

MIN_THRESHOLD_MB = 23
MAX_THRESHOLD_MB = 1000


def _canonical_sizes(pod_keys: torch.Tensor, node_keys: torch.Tensor,
                     sizes: torch.Tensor) -> torch.Tensor:
    """i32[P, C]: for each pod image key, the max over nodes of the summed
    sizes of that node's slots holding the key (0 if no node holds it).

    ``node_keys`` i32[N, I] has dead slots set to 0, which no live pod key
    equals (a zero pod key is no image)."""
    # per slot: the summed sizes of its node's slots with the same key
    same = node_keys[:, :, None] == node_keys[:, None, :]  # (N, I, I)
    slot_sum = torch.where(same, sizes[:, None, :], 0).sum(dim=2, dtype=torch.int32)
    flat_key = node_keys.reshape(-1)
    order = torch.argsort(flat_key)
    skey = flat_key[order].contiguous()
    ssum = slot_sum.reshape(-1)[order]
    # the first position of each key's run; the max of the run lands there
    start = torch.searchsorted(skey, skey)
    run_max = torch.zeros_like(ssum).scatter_reduce(
        0, start, ssum, reduce="amax", include_self=True)
    q = pod_keys.reshape(-1).contiguous()
    pos = torch.searchsorted(skey, q).clamp(max=skey.numel() - 1)
    found = skey[pos] == q
    return torch.where(found, run_max[pos], 0).reshape(pod_keys.shape)


class ImageLocality(BatchEvaluable):
    def name(self) -> str:
        return NAME

    def batch_score(self, ctx: Any, pods: Any, nodes: Any,
                    aux: Dict[str, Any]) -> torch.Tensor:
        P, C = pods.image_key.shape
        N, I = nodes.image_key.shape
        dev = pods.image_key.device
        img_in_range = torch.arange(I, device=dev)[None, :] < nodes.num_images[:, None]
        c_in_range = (torch.arange(C, device=dev)[None, :]
                      < pods.num_containers[:, None]) & (pods.image_key != 0)
        node_keys = torch.where(img_in_range, nodes.image_key, 0)  # (N, I)
        size_at = _canonical_sizes(pods.image_key, node_keys,
                                   torch.where(img_in_range, nodes.image_size_mb, 0))
        total_nodes = nodes.valid.sum(dtype=torch.int32).clamp(min=1)
        sums = torch.zeros((P, N), dtype=torch.int32, device=dev)
        for c in range(C):
            # (P, N, I) compare, reduced over I at once; a dead slot (0)
            # never equals a live key
            has = any_last_axis(pods.image_key[:, c][:, None, None] == node_keys[None])
            has &= c_in_range[:, c][:, None] & nodes.valid[None, :]
            n_with = has.sum(dim=1, dtype=torch.int32)  # (P,)
            scaled = size_at[:, c] * n_with // total_nodes
            sums += torch.where(has, scaled[:, None], 0)
        lo = MIN_THRESHOLD_MB * pods.num_containers[:, None]
        hi = MAX_THRESHOLD_MB * pods.num_containers[:, None]
        score = (sums - lo) * MAX_NODE_SCORE // (hi - lo).clamp(min=1)
        score = torch.where(sums < lo, 0, score)
        score = torch.where(sums > hi, MAX_NODE_SCORE, score)
        return score.to(torch.int32)
