"""TaintToleration: filter on NoSchedule/NoExecute taints the pod does not
tolerate, score by intolerable PreferNoSchedule taints with a reversed
normalize.

Counterpart of ``minisched_tpu/plugins/tainttoleration.py``, both halves.
The scalar filter and score walk the node's taints.  In the batch form,
taint-by-toleration matching runs over the node TAINT PROFILES (Dp rows,
unrolled over the pod's toleration slots so the largest intermediate is
(P, Dp, Tn)) and expands to (P, N) with one gather through
``nodes.profile_id``.  Padded node rows point at profile 0, so the gather
stays in range.  Only the toleration slots some pod of the wave fills
(``pods.use.tol_slots``, known on the host) are unrolled: an empty slot
tolerates nothing, and a wave without tolerations needs one row for all
its pods, (Dp, Tn).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from minisched_tpu_torch.api.objects import (
    TAINT_EFFECT_NO_EXECUTE,
    TAINT_EFFECT_NO_SCHEDULE,
    TAINT_EFFECT_PREFER_NO_SCHEDULE,
    Toleration,
)
from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.framework.types import (
    MAX_NODE_SCORE,
    CycleState,
    NodeScoreList,
    Status,
)
from minisched_tpu_torch.models import tables
from minisched_tpu_torch.parallel import sharding

NAME = "TaintToleration"


def _tolerated(taint: Any, tolerations: List[Toleration]) -> bool:
    return any(t.tolerates(taint) for t in tolerations)


class _Normalize:
    """DefaultNormalizeScore reversed: more intolerable taints, lower
    score; all-zero counts give every node MAX_NODE_SCORE."""

    def normalize_score(self, state: CycleState, pod: Any,
                        scores: NodeScoreList) -> Status:
        max_count = max((ns.score for ns in scores), default=0)
        for ns in scores:
            if max_count == 0:
                ns.score = MAX_NODE_SCORE
            else:
                ns.score = (MAX_NODE_SCORE
                            - ns.score * MAX_NODE_SCORE // max_count)
        return Status.success()


def _taint_in_range(nodes: Any) -> torch.Tensor:
    Tn = nodes.prof_taint_key.shape[1]
    slots = torch.arange(Tn, device=nodes.prof_taint_key.device)
    return slots[None, :] < nodes.prof_num_taints[:, None]  # (Dp, Tn)


def _per_node(per_profile: torch.Tensor, pods: Any,
              nodes: Any) -> torch.Tensor:
    """(P, Dp), or (Dp,) for every pod alike, → (P, N) through each
    node's profile row."""
    out = per_profile.index_select(-1, nodes.profile_id.long())
    if out.dim() == 1:
        out = out.expand(pods.valid.shape[0], -1).contiguous()
    return out


class TaintToleration(BatchEvaluable):
    def events_to_register(self) -> List[ClusterEvent]:
        """The cluster events that may make a pod this plugin rejected
        schedulable again (the JAX plugin's registration)."""
        return [ClusterEvent(GVK.NODE,
                             ActionType.ADD | ActionType.UPDATE_NODE_TAINT)]

    def name(self) -> str:
        return NAME

    def filter(self, state: CycleState, pod: Any, node_info: Any) -> Status:
        node = node_info.node
        if node is None:
            return Status.unresolvable("node not found")
        for taint in node.spec.taints:
            if taint.effect not in (TAINT_EFFECT_NO_SCHEDULE,
                                    TAINT_EFFECT_NO_EXECUTE):
                continue
            if not _tolerated(taint, pod.spec.tolerations):
                return Status.unresolvable(
                    f"node(s) had untolerated taint {{{taint.key}: "
                    f"{taint.value}}}").with_plugin(NAME)
        return Status.success()

    def score(self, state: CycleState, pod: Any,
              node_name: str) -> Tuple[int, Status]:
        ni = state.read("nodeinfo/" + node_name)
        # the tolerations that can cover PreferNoSchedule taints (effect ""
        # or PreferNoSchedule)
        tols = [t for t in pod.spec.tolerations
                if t.effect in ("", TAINT_EFFECT_PREFER_NO_SCHEDULE)]
        count = sum(1 for taint in ni.node.spec.taints
                    if taint.effect == TAINT_EFFECT_PREFER_NO_SCHEDULE
                    and not _tolerated(taint, tols))
        return count, Status.success()

    def score_extensions(self) -> _Normalize:
        return _Normalize()

    @staticmethod
    def _tolerates_matrix(pods: Any, nodes: Any,
                          tol_effect_ok: torch.Tensor) -> torch.Tensor:
        """bool[P, Dp, Tn]: pod p tolerates taint slot t of taint profile
        d.  ``tol_effect_ok`` bool[P, Tp] says which toleration slots are
        eligible (filter and score consider different effects)."""
        P, Tp = pods.tol_key.shape
        dev = pods.tol_key.device
        tol_in_range = torch.arange(Tp, device=dev)[None, :] < pods.num_tols[:, None]
        tol_ok = tol_in_range & tol_effect_ok  # (P, Tp)
        exists_all = pods.tol_op == tables.TOLERATION_OP_EXISTS_CODE
        out = torch.zeros((P,) + tuple(nodes.prof_taint_key.shape),
                          dtype=torch.bool, device=dev)  # (P, Dp, Tn)
        for t in range(min(pods.use.tol_slots, Tp)):
            # toleration effect "" matches every taint effect
            eff = pods.tol_effect[:, t][:, None, None]
            eff_match = (eff == tables.EFFECT_NONE) | (
                eff == nodes.prof_taint_effect[None, :, :])
            exists = exists_all[:, t]
            wildcard = (pods.tol_empty_key[:, t] & exists)[:, None, None]
            key_eq = pods.tol_key[:, t][:, None, None] == nodes.prof_taint_key[None]
            val_eq = (pods.tol_value[:, t][:, None, None]
                      == nodes.prof_taint_value[None])
            value_ok = exists[:, None, None] | val_eq
            covers = eff_match & (wildcard | (key_eq & value_ok))
            out |= covers & tol_ok[:, t][:, None, None]
        return out

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any) -> torch.Tensor:
        hard = (nodes.prof_taint_effect == tables.EFFECT_NO_SCHEDULE) | (
            nodes.prof_taint_effect == tables.EFFECT_NO_EXECUTE)  # (Dp, Tn)
        blocking = _taint_in_range(nodes) & hard  # (Dp, Tn)
        if pods.use.tol_slots:
            all_tols_ok = torch.ones(pods.tol_key.shape, dtype=torch.bool,
                                     device=pods.tol_key.device)
            tolerated = self._tolerates_matrix(pods, nodes, all_tols_ok)
            blocking = blocking[None] & ~tolerated  # (P, Dp, Tn)
        return _per_node(~blocking.any(dim=-1), pods, nodes)  # (P, N)

    def batch_score(self, ctx: Any, pods: Any, nodes: Any,
                    aux: Dict[str, Any]) -> torch.Tensor:
        prefer = nodes.prof_taint_effect == tables.EFFECT_PREFER_NO_SCHEDULE
        intolerable = _taint_in_range(nodes) & prefer  # (Dp, Tn)
        if pods.use.tol_slots:
            tol_eligible = (pods.tol_effect == tables.EFFECT_NONE) | (
                pods.tol_effect == tables.EFFECT_PREFER_NO_SCHEDULE)
            tolerated = self._tolerates_matrix(pods, nodes, tol_eligible)
            intolerable = intolerable[None] & ~tolerated  # (P, Dp, Tn)
        counts = intolerable.sum(dim=-1, dtype=torch.int32)  # (P, Dp) or (Dp,)
        return _per_node(counts, pods, nodes)

    def batch_normalize(self, ctx: Any, scores: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
        """DefaultNormalizeScore reversed: more intolerable taints, lower
        score; a pod whose feasible counts are all 0 scores 100 everywhere."""
        max_count = sharding.node_max(
            torch.where(mask, scores, 0).amax(dim=1, keepdim=True))
        normalized = MAX_NODE_SCORE - scores * MAX_NODE_SCORE // max_count.clamp(min=1)
        return torch.where(max_count == 0, MAX_NODE_SCORE,
                           normalized).to(torch.int32)
