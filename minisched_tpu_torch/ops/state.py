"""Cluster-state updates on the device: apply placements to the NodeTable.

Counterpart of ``minisched_tpu/ops/state.py``.  Bind results are added to
the resident NodeTable with scatter-adds, so a run of many pod waves never
re-uploads cluster state: the host streams pod waves in and placements
out.  The functions are pure, as in the JAX package: they return a new
NodeTable and leave the one they were given untouched.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Tuple

import torch

from minisched_tpu_torch.models import tables
from minisched_tpu_torch.models.tables import NodeTable, PodTable
from minisched_tpu_torch.ops.fused import evaluate


def _commit_ports(nodes: NodeTable, pods: PodTable, placed: torch.Tensor,
                  choice: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append each placed pod's host ports to its node's ``used_port``
    slots: (used_port, num_used_ports).

    Two ports landing on one node take consecutive free slots, in pod
    order: the (node, port) pairs are sorted by node with a STABLE sort,
    and a pair's rank is its position minus its segment's start.  Ports
    past a node's MAX_PORTS slots are dropped, as JAX's ``mode="drop"``
    does: dropped pairs are aimed at an extra row N that is cut off
    afterwards, so no data-dependent shape (and no host sync) appears.
    """
    P, W = pods.port.shape
    N = nodes.valid.shape[0]
    dev = choice.device
    slot_in_range = torch.arange(W, device=dev)[None, :] < pods.num_ports[:, None]
    pair_live = placed[:, None] & slot_in_range  # (P, W)
    pair_node = torch.where(pair_live, choice[:, None], N).reshape(-1)  # K
    pair_port = torch.where(pair_live, pods.port, 0).reshape(-1)
    order = torch.argsort(pair_node, stable=True)  # dead pairs (N) sort last
    snode = pair_node[order].long()
    sport = pair_port[order]
    pos = torch.arange(snode.shape[0], device=dev)
    # a segment starts at the first position of its node in the sorted
    # pairs: one binary search each (the JAX code's cummax over segment
    # starts gives the same; torch's cummax is a slow scan on the card)
    rank = pos - torch.searchsorted(snode, snode)
    slot = nodes.num_used_ports[snode.clamp(max=N - 1)].long() + rank
    ok = (snode < N) & (slot < nodes.used_port.shape[1])
    tgt_node = torch.where(ok, snode, N)  # row N: the dropped pairs
    tgt_slot = torch.where(ok, slot, 0)
    used_port = torch.cat([nodes.used_port, nodes.used_port.new_zeros(1, W)])
    used_port.index_put_((tgt_node, tgt_slot), sport)
    num_used = torch.cat([nodes.num_used_ports,
                          nodes.num_used_ports.new_zeros(1)])
    num_used.index_add_(0, tgt_node, ok.to(num_used.dtype))
    return used_port[:N], num_used[:N]


def mount_slot_planes(extra: Any) -> Tuple[torch.Tensor, ...]:
    """Per-mount-slot volume planes of the repair loop's commits:
    (slot_cnt, slot_vol, slot_ro, slot_fam, slot_dup), all (P, V).
    slot_cnt is the counting row (−1 = empty slot), slot_vol the
    bound-volume row (−1 = unbound or empty), slot_dup marks later mounts
    of a volume the pod already mounts (they count once)."""
    V = extra.pod_claims.shape[1]
    slots = torch.arange(V, device=extra.pod_claims.device)
    in_range = slots[None, :] < extra.pod_n_vols[:, None]
    slot_valid = in_range & extra.pod_claim_valid
    claims = extra.pod_claims.long()
    slot_cnt = torch.where(slot_valid, extra.claim_cnt[claims], -1)
    slot_vol = torch.where(slot_valid, extra.claim_vol[claims], -1)
    slot_ro = extra.claim_ro[claims]
    slot_fam = extra.claim_family[claims]
    slot_dup = ((slot_cnt[:, :, None] == slot_cnt[:, None, :])
                & (slot_cnt[:, None, :] >= 0)
                & (slots[None, None, :] < slots[None, :, None])).any(dim=2)
    return slot_cnt, slot_vol, slot_ro, slot_fam, slot_dup


#: the NodeTable columns ``apply_placements`` changes (the rest describe
#: the nodes themselves and never change as pods commit)
COMMITTED_COLUMNS = ("req_cpu", "req_mem", "req_eph", "req_pods", "nzreq_cpu",
                     "nzreq_mem", "used_port", "num_used_ports")


def apply_placements(nodes: NodeTable, pods: PodTable,
                     choice: torch.Tensor) -> NodeTable:
    """Commit chosen placements: add each placed pod's requests to its
    node's ``req_*`` accounting and its host ports to the node's used-port
    slots.  choice: i32[P] node index per pod, -1 = unplaced."""
    placed = (choice >= 0) & pods.valid
    idx = torch.where(placed, choice, 0).long()

    def scatter(col: torch.Tensor, amount: torch.Tensor) -> torch.Tensor:
        amount = torch.where(placed, amount, 0).to(col.dtype)
        return col.index_add(0, idx, amount)

    used_port, num_used_ports = _commit_ports(nodes, pods, placed, choice)
    return replace(
        nodes,
        req_cpu=scatter(nodes.req_cpu, pods.req_cpu),
        req_mem=scatter(nodes.req_mem, pods.req_mem),
        req_eph=scatter(nodes.req_eph, pods.req_eph),
        req_pods=scatter(nodes.req_pods, torch.ones_like(pods.req_pods)),
        nzreq_cpu=scatter(
            nodes.nzreq_cpu,
            torch.where(pods.req_cpu == 0, tables.DEFAULT_NONZERO_CPU,
                        pods.req_cpu),
        ),
        nzreq_mem=scatter(
            nodes.nzreq_mem,
            torch.where(pods.req_mem == 0, tables.DEFAULT_NONZERO_MEM_MIB,
                        pods.req_mem),
        ),
        used_port=used_port,
        num_used_ports=num_used_ports,
    )


def wave_step(nodes: NodeTable, pods: PodTable, filter_plugins,
              pre_score_plugins, score_plugins,
              ctx) -> Tuple[NodeTable, Any, Any]:
    """One device step: evaluate a pod wave against the resident
    NodeTable, then commit the placements.

    Returns (updated NodeTable, choice i32[P], best_score i32[P])."""
    result = evaluate(pods, nodes, filter_plugins, pre_score_plugins,
                      score_plugins, ctx)
    nodes = apply_placements(nodes, pods, result.choice)
    return nodes, result.choice, result.best_score
