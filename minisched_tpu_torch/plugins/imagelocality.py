"""ImageLocality: favor nodes that already cache the pod's container
images.

Counterpart of ``minisched_tpu/plugins/imagelocality.py``, both halves,
with the same integer formula:

    scaled(image) = size_mb * nodes_with_image // total_nodes
    sum(p, n)     = Σ over the pod's containers whose image node n has
    score(p, n)   = clamp((sum - 23*C) * 100 // (1000*C - 23*C), 0, 100)

The scalar half aggregates each image's node count and canonical size
(the largest size any node advertises) in PreScore over the whole
snapshot, and Score sums over the pod's containers.  The JAX kernel
broadcasts a (P, C, N, I) predicate that XLA fuses away;
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

from typing import Any, Dict, List, Tuple

import torch

from minisched_tpu_torch.framework.nodeinfo import MIB
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.framework.types import (
    MAX_NODE_SCORE,
    CycleState,
    Status,
)
from minisched_tpu_torch.parallel import sharding
from minisched_tpu_torch.utils.reduce import any_last_axis

NAME = "ImageLocality"
STATE_KEY = "PreScore" + NAME

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


def _priority(sum_scores: int, num_containers: int) -> int:
    lo = MIN_THRESHOLD_MB * num_containers
    hi = MAX_THRESHOLD_MB * num_containers
    if sum_scores < lo:
        return 0
    if sum_scores > hi:
        return MAX_NODE_SCORE
    return (sum_scores - lo) * MAX_NODE_SCORE // (hi - lo)


class ImageLocality(BatchEvaluable):
    def name(self) -> str:
        return NAME

    def pre_score(self, state: CycleState, pod: Any,
                  nodes: List[Any]) -> Status:
        """Image → (node count, largest size in MiB) over the whole
        snapshot (not the feasible nodes ``nodes``, which is used only
        without a snapshot)."""
        try:
            all_nodes = [ni.node for ni in state.read("nodeinfos")]
        except KeyError:
            all_nodes = nodes
        spread: Dict[str, Tuple[int, int]] = {}
        for node in all_nodes:
            for img, size in node.status.images.items():
                count, max_size = spread.get(img, (0, 0))
                spread[img] = (count + 1, max(max_size, size // MIB))
        state.write(STATE_KEY, (spread, len(all_nodes)))
        return Status.success()

    def score(self, state: CycleState, pod: Any,
              node_name: str) -> Tuple[int, Status]:
        try:
            spread, total_nodes = state.read(STATE_KEY)
        except KeyError as e:
            return 0, Status.from_error(e).with_plugin(NAME)
        node_images = state.read("nodeinfo/" + node_name).node.status.images
        total = 0
        containers = pod.spec.containers
        for c in containers:
            if c.image and c.image in node_images:
                count, size_mb = spread[c.image]
                total += size_mb * count // max(total_nodes, 1)
        return _priority(total, len(containers)), Status.success()

    def score_extensions(self) -> None:
        return None

    def batch_score(self, ctx: Any, pods: Any, nodes: Any,
                    aux: Dict[str, Any]) -> torch.Tensor:
        P, C = pods.image_key.shape
        N, I = nodes.image_key.shape
        dev = pods.image_key.device
        img_in_range = torch.arange(I, device=dev)[None, :] < nodes.num_images[:, None]
        c_in_range = (torch.arange(C, device=dev)[None, :]
                      < pods.num_containers[:, None]) & (pods.image_key != 0)
        node_keys = torch.where(img_in_range, nodes.image_key, 0)  # (N, I)
        # the largest size and the node counts are over the whole roster
        size_at = sharding.node_max(_canonical_sizes(
            pods.image_key, node_keys,
            torch.where(img_in_range, nodes.image_size_mb, 0)))
        total_nodes = sharding.node_sum(
            nodes.valid.sum(dtype=torch.int32)).clamp(min=1)
        sums = torch.zeros((P, N), dtype=torch.int32, device=dev)
        for c in range(C):
            # (P, N, I) compare, reduced over I at once; a dead slot (0)
            # never equals a live key
            has = any_last_axis(pods.image_key[:, c][:, None, None] == node_keys[None])
            has &= c_in_range[:, c][:, None] & nodes.valid[None, :]
            n_with = sharding.node_sum(
                has.sum(dim=1, dtype=torch.int32))  # (P,)
            scaled = size_at[:, c] * n_with // total_nodes
            sums += torch.where(has, scaled[:, None], 0)
        lo = MIN_THRESHOLD_MB * pods.num_containers[:, None]
        hi = MAX_THRESHOLD_MB * pods.num_containers[:, None]
        score = (sums - lo) * MAX_NODE_SCORE // (hi - lo).clamp(min=1)
        score = torch.where(sums < lo, 0, score)
        score = torch.where(sums > hi, MAX_NODE_SCORE, score)
        return score.to(torch.int32)
