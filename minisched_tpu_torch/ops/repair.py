"""Wave scheduling with conflict repair: waves that never double-book.

Counterpart of ``minisched_tpu/ops/repair.py``.  Per round, every
uncommitted pod of the wave is evaluated against the node table; then
the conflict-free subset is ACCEPTED under a deterministic rule (per
node, pods in index order while their cumulative demand still fits, and
no same-round host-port collision), committed, and the rest is evaluated
again against the updated table.  Every round commits at least the
lowest-indexed contender of each contested node, so the loop converges;
a pod with no feasible node (choice -1) stays unplaced, since commits
only consume resources.

The JAX ``lax.while_loop`` is a host loop here, with the same round count
(the last round, which commits nothing new or leaves nothing to retry,
included).  Each round ends in one read of two flags from the card, the
loop's only wait on the device; the plugins branch on no device value.
The volume state of the JAX loop (its ``extra`` constraint tables) comes
with the constraint-table slice of the port (ROADMAP.md §1 item 6).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from minisched_tpu_torch.models.tables import NodeTable, PodTable
from minisched_tpu_torch.ops.fused import (
    BatchContext,
    evaluate,
    precompute_static,
    unschedulable_plugin_masks,
    validate_batch_chains,
)
from minisched_tpu_torch.ops.state import apply_placements

_INF32 = 2**31 - 1
MAX_ROUNDS = 16  # the round cap of a repair wave


def _segment_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Position of each element's segment start in an ascending key
    array: one binary search each (``lax.cummax`` over the start flags
    gives the same; torch's cummax is a slow scan on the card)."""
    return torch.searchsorted(sorted_keys, sorted_keys)


def accept_placements(
    nodes: NodeTable,
    pods: PodTable,
    choice: torch.Tensor,
    active: torch.Tensor,
    check_resources: bool = True,
    check_ports: bool = True,
) -> torch.Tensor:
    """bool[P]: which tentative placements commit this round.

    Pods are grouped by chosen node and taken in pod-index order while
    the node's remaining allocatable covers their cumulative demand (cpu,
    memory, ephemeral storage, pod count); among same-round claims of one
    host port on one node only the first pod survives.
    ``check_resources`` / ``check_ports`` mirror whether NodeResourcesFit
    / NodePorts are in the filter chain: acceptance enforces exactly what
    the chain enforces."""
    P = choice.shape[0]
    dev = choice.device
    live = active & (choice >= 0)
    if not check_resources and not check_ports:
        return live
    # node segments in pod-index order: a stable sort on the chosen node,
    # dead rows last (the JAX code's key, choice * (P + 1) + index, orders
    # the same way); a dead row's key is above every node index, so the
    # sorted keys are ascending and their segment starts a binary search
    node_key = torch.where(live, choice, _INF32 // (P + 1))
    order = torch.argsort(node_key, stable=True)
    s_choice = choice[order]
    s_live = live[order]

    if check_ports:
        W = pods.port.shape[1]
        slots = torch.arange(W, device=dev)
        slot_in_range = slots[None, :] < pods.num_ports[:, None]
        # a pod repeating one port across its own containers is a single
        # claim: drop the later slots so it cannot lose to itself
        dup_within = ((pods.port[:, :, None] == pods.port[:, None, :])
                      & (slots[None, None, :] < slots[None, :, None])
                      & slot_in_range[:, None, :]).any(dim=2)  # (P, W)
        pair_key = torch.where(live, choice, -1)[:, None] * 65536 + pods.port
        pair_live = live[:, None] & slot_in_range & ~dup_within
        flat_key = torch.where(pair_live, pair_key, _INF32).reshape(-1)
        # stable: pod-index order survives within equal (node, port) keys
        porder = torch.argsort(flat_key, stable=True)
        sflat = flat_key[porder]
        first = torch.ones_like(sflat, dtype=torch.bool)
        first[1:] = sflat[1:] != sflat[:-1]
        loses = torch.empty_like(first)
        loses[porder] = ~first & (sflat < _INF32)
        port_ok = ~loses.reshape(P, W).any(dim=1)
        eligible = s_live & port_ok[order]
    else:
        eligible = s_live
    if not check_resources:
        accept = torch.empty_like(eligible)
        accept[order] = eligible
        return accept & live

    seg = _segment_starts(torch.where(s_live, s_choice, _INF32))
    idx = torch.where(s_live, s_choice, 0).long()

    def prefix_fits(pod_amt, node_req, node_alloc):
        amt = torch.where(eligible, pod_amt[order], 0)
        incl = torch.cumsum(amt, dim=0, dtype=torch.int32)
        ex = incl - amt  # exclusive cumsum
        within_ex = ex - ex[seg]  # demand of earlier candidates on the node
        headroom = (node_alloc - node_req)[idx]
        # zero-demand pods always pass, as in the filters: a pod that asks
        # for nothing fits even an over-committed node
        return (amt == 0) | (within_ex + amt <= headroom)

    fits = (
        eligible
        & prefix_fits(pods.req_cpu, nodes.req_cpu, nodes.alloc_cpu)
        & prefix_fits(pods.req_mem, nodes.req_mem, nodes.alloc_mem)
        & prefix_fits(pods.req_eph, nodes.req_eph, nodes.alloc_eph)
        & prefix_fits(torch.ones_like(pods.req_pods), nodes.req_pods,
                      nodes.alloc_pods)
    )
    # an earlier candidate that does not fit still counts in the prefix:
    # it is rejected now and retried next round, so the prefix only ever
    # over-estimates what commits ahead of a pod (never over-commits)
    accept = torch.empty_like(fits)
    accept[order] = fits
    return accept & live


def repair_wave_step(
    nodes: NodeTable,
    pods: PodTable,
    filter_plugins: Sequence[Any],
    pre_score_plugins: Sequence[Any],
    score_plugins: Sequence[Any],
    ctx: BatchContext,
    max_rounds: int = MAX_ROUNDS,
    with_diagnostics: bool = False,
    split_static: bool = True,
) -> Tuple[Any, ...]:
    """Evaluate-accept-commit rounds until every pod is placed or has no
    feasible node, at most ``max_rounds``.

    Returns (updated NodeTable, choice i32[P] with -1 = unplaced, rounds
    used as an int); with ``with_diagnostics`` a fourth element, bool[K, P]
    per-filter first-failure masks of the UNPLACED pods against the final
    table (``unschedulable_plugin_masks``).

    ``split_static``: compute the round-invariant planes once per wave
    (``precompute_static``) and re-evaluate only the committed-state
    plugins each round; bit-identical either way."""
    P = pods.valid.shape[0]
    names = {pl.name() for pl in filter_plugins}
    check_resources = "NodeResourcesFit" in names
    check_ports = "NodePorts" in names
    static = (precompute_static(pods, nodes, filter_plugins,
                                pre_score_plugins, score_plugins, ctx)
              if split_static else None)

    committed = ~pods.valid  # padding rows never schedule
    final = torch.full((P,), -1, dtype=torch.int32, device=pods.valid.device)
    rounds = 0
    pending = True  # some valid pod is still uncommitted
    while rounds < max_rounds:
        active_pods = replace(pods, valid=pods.valid & ~committed)
        result = evaluate(active_pods, nodes, filter_plugins,
                          pre_score_plugins, score_plugins, ctx,
                          static=static)
        accept = accept_placements(nodes, active_pods, result.choice,
                                   active_pods.valid,
                                   check_resources=check_resources,
                                   check_ports=check_ports)
        nodes = apply_placements(nodes, active_pods,
                                 torch.where(accept, result.choice, -1))
        final = torch.where(accept, result.choice, final)
        committed = committed | accept
        rounds += 1
        # stop when nothing committed or no uncommitted pod is feasible
        retryable = active_pods.valid & (result.choice >= 0) & ~accept
        progress = accept.any() & retryable.any()
        flags = torch.stack([progress, (~committed).any()]).tolist()
        progress, pending = flags
        if not progress:
            break
    if not with_diagnostics:
        return nodes, final, rounds

    # one diagnostic evaluation of the unplaced remainder against the
    # FINAL table, filters only, and none when every pod placed
    K = len(filter_plugins)
    dev = pods.valid.device
    if K == 0 or not pending:
        return nodes, final, rounds, torch.zeros((K, P), dtype=torch.bool,
                                                 device=dev)
    losers = replace(pods, valid=pods.valid & ~committed)
    result = evaluate(losers, nodes, filter_plugins, (), (), ctx,
                      with_diagnostics=True)
    valid = losers.valid[:, None] & nodes.valid[None, :]
    return nodes, final, rounds, unschedulable_plugin_masks(
        result.filter_masks, valid)


class RepairingEvaluator:
    """Plugin chains fixed at construction (argument order as
    ``FusedEvaluator``); tables vary per call, each wave at most
    ``MAX_ROUNDS`` rounds.  With ``split_static`` the construction runs
    the static-classification guard (``ops/staticcheck.py``).  The JAX package's ``mesh`` (ROADMAP.md §1
    item 12) and ``call_packed`` (the live engine, item 10) are not
    ported."""

    def __init__(
        self,
        filter_plugins: Sequence[Any],
        pre_score_plugins: Sequence[Any],
        score_plugins: Sequence[Any],
        weights: Optional[Dict[str, int]] = None,
        with_diagnostics: bool = False,
        split_static: bool = True,
    ):
        validate_batch_chains(filter_plugins, pre_score_plugins, score_plugins)
        self.ctx = BatchContext(weights=tuple(sorted((weights or {}).items())))
        if split_static:
            from minisched_tpu_torch.ops.staticcheck import (
                verify_static_classification,
            )

            verify_static_classification(
                [pl for pl in filter_plugins
                 if not getattr(pl, "reads_committed_state", False)],
                [pl for pl in score_plugins
                 if not getattr(pl, "reads_committed_state", False)],
                self.ctx,
            )
        self.filter_plugins = tuple(filter_plugins)
        self.pre_score_plugins = tuple(pre_score_plugins)
        self.score_plugins = tuple(score_plugins)
        self.with_diagnostics = with_diagnostics
        self.split_static = split_static

    def __call__(self, pods: PodTable, nodes: NodeTable):
        return repair_wave_step(
            nodes, pods, self.filter_plugins, self.pre_score_plugins,
            self.score_plugins, self.ctx,
            with_diagnostics=self.with_diagnostics,
            split_static=self.split_static,
        )
