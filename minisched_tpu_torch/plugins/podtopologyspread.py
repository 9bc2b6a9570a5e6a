"""PodTopologySpread: even spreading across topology domains.

Counterpart of ``minisched_tpu/plugins/podtopologyspread.py``, both
halves.  The scalar half counts matching assigned pods per domain in
PreFilter and PreScore and reads the counts per node; its status reasons
are the JAX strings.  Both halves:

* Filter (DoNotSchedule): domains are counted over the nodes that pass
  the pod's nodeSelector and required node affinity (eligible nodes);
  placing on node n must keep ``count(domain(n)) + 1 − min_domain_count
  ≤ max_skew``, where the minimum runs over the domains that hold an
  eligible node.  Keyless nodes are rejected, and with no eligible keyed
  node the constraint holds nowhere.  Zone-like keys (at most
  ``MAX_DOMAINS`` values) and hostname-like keys (one per node) both
  work.
* Score (ScheduleAnyway): the sum over the pod's constraints of the
  node's domain count (keyless nodes take the constraint's worst
  count), normalized min-max in reverse to [0, 100].

The JAX kernels skip a slot with no active row through ``lax.cond`` on a
device value; here the active slots come from the host
(``ConstraintTables.in_use``), and a skipped slot is exactly the all-pass
mask or zero score the JAX branch returns.

The per-domain sums are (P, N) × (N, K·D) products of counts and
one-hot planes.  They run in float64, whatever the TF32 settings of the
process: every entry is an integer count of assigned pods below 2^53, so
each partial sum is exact (TF32 would round any count above 2^11).  The
JAX kernel's second product expands the domain sums back over the nodes
through the same one-hot; here that is a gather by domain id, which is
the same integers without a product.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.framework.types import (
    MAX_NODE_SCORE,
    CycleState,
    NodeScoreList,
    Status,
)
from minisched_tpu_torch.models.constraints import TS_DO_NOT_SCHEDULE, _matches
from minisched_tpu_torch.parallel import sharding
from minisched_tpu_torch.plugins.nodeaffinity import (
    node_affinity_eligible,
    required_node_affinity_mask,
)
from minisched_tpu_torch.plugins.normalize import (
    minmax_normalize_batch,
    minmax_normalize_scalar,
)

NAME = "PodTopologySpread"
PRE_FILTER_KEY = "PreFilter" + NAME
PRE_SCORE_KEY = "PreScore" + NAME

REASON_SKEW = "node(s) didn't match pod topology spread constraints"
REASON_KEY = ("node(s) didn't match pod topology spread constraints "
              "(missing required label)")

_INF = 1 << 30


def _constraint_counts(constraint: Any, pod: Any, node_infos: List[Any],
                       eligible: Optional[Dict[str, bool]] = None
                       ) -> Dict[str, int]:
    """Assigned pods matching the constraint's selector (same namespace)
    per topology value; ``eligible`` (node name → passes the pod's node
    selector and required node affinity) restricts the count to those
    nodes, as the filter's counts are."""
    nss = (pod.metadata.namespace,)
    counts: Dict[str, int] = {}
    for ni in node_infos:
        val = ni.node.metadata.labels.get(constraint.topology_key)
        if val is None:
            continue
        if eligible is not None and not eligible.get(ni.name, False):
            continue
        n = sum(1 for p in ni.pods
                if _matches(constraint.label_selector, nss, p))
        if n:
            counts[val] = counts.get(val, 0) + n
    return counts


class _Normalize:
    """Reversed min-max: fewer co-located matching pods, higher score;
    all equal → MAX_NODE_SCORE."""

    def normalize_score(self, state: CycleState, pod: Any,
                        scores: NodeScoreList) -> Status:
        minmax_normalize_scalar(scores, reverse=True, fill=MAX_NODE_SCORE)
        return Status.success()


def _need(extra: Any) -> None:
    if extra is None:
        raise ValueError("PodTopologySpread batch kernels need the wave's "
                         "ConstraintTables (models/constraints.py) — pass "
                         "`extra`")


class PodTopologySpread(BatchEvaluable):
    needs_extra = True
    #: the coupling planes the sequential scan carries for this plugin
    #: (``ops/sequential.py``): the combo aggregates
    scan_carried_planes = ("combos",)

    def events_to_register(self) -> List[ClusterEvent]:
        """The cluster events that may make a pod this plugin rejected
        schedulable again (the JAX plugin's registration)."""
        return [
            ClusterEvent(GVK.POD, ActionType.ALL),
            ClusterEvent(GVK.NODE,
                         ActionType.ADD | ActionType.UPDATE_NODE_LABEL),
        ]

    def name(self) -> str:
        return NAME

    def pre_filter(self, state: CycleState, pod: Any,
                   node_infos: List[Any]) -> Status:
        hard = []  # (constraint, counts, min count or None)
        eligible = None
        if any(c.when_unsatisfiable == "DoNotSchedule"
               for c in pod.spec.topology_spread_constraints):
            # one eligibility verdict per node, shared by the constraints
            eligible = {ni.name: node_affinity_eligible(pod, ni.node)[0]
                        for ni in node_infos}
        for c in pod.spec.topology_spread_constraints:
            if c.when_unsatisfiable != "DoNotSchedule":
                continue
            counts = _constraint_counts(c, pod, node_infos, eligible=eligible)
            # min over the domains of the eligible nodes with the key
            min_count = None
            for ni in node_infos:
                if not eligible.get(ni.name, False):
                    continue
                val = ni.node.metadata.labels.get(c.topology_key)
                if val is None:
                    continue
                cnt = counts.get(val, 0)
                if min_count is None or cnt < min_count:
                    min_count = cnt
            hard.append((c, counts, min_count))
        state.write(PRE_FILTER_KEY, hard)
        return Status.success()

    def filter(self, state: CycleState, pod: Any, node_info: Any) -> Status:
        labels = node_info.node.metadata.labels
        for c, counts, min_count in state.read(PRE_FILTER_KEY):
            val = labels.get(c.topology_key)
            if val is None:
                return Status.unresolvable(REASON_KEY).with_plugin(NAME)
            if min_count is None:  # no eligible domain anywhere
                return Status.unschedulable(REASON_SKEW).with_plugin(NAME)
            if counts.get(val, 0) + 1 - min_count > c.max_skew:
                return Status.unschedulable(REASON_SKEW).with_plugin(NAME)
        return Status.success()

    def pre_score(self, state: CycleState, pod: Any,
                  nodes: List[Any]) -> Status:
        node_infos = state.read("nodeinfos")
        soft = []  # (topology key, counts, worst count)
        for c in pod.spec.topology_spread_constraints:
            if c.when_unsatisfiable != "ScheduleAnyway":
                continue
            counts = _constraint_counts(c, pod, node_infos)
            soft.append((c.topology_key, counts,
                         max(counts.values(), default=0)))
        state.write(PRE_SCORE_KEY, soft)
        return Status.success()

    def score(self, state: CycleState, pod: Any,
              node_name: str) -> Tuple[int, Status]:
        labels = state.read("nodeinfo/" + node_name).node.metadata.labels
        total = 0
        for topo_key, counts, worst in state.read(PRE_SCORE_KEY):
            val = labels.get(topo_key)
            total += counts.get(val, 0) if val is not None else worst
        return total, Status.success()

    def score_extensions(self) -> _Normalize:
        return _Normalize()

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any,
                     extra: Any) -> torch.Tensor:
        _need(extra)
        P, N = extra.ts_combo.shape[0], nodes.valid.shape[0]
        dev = nodes.valid.device
        out = torch.ones((P, N), dtype=torch.bool, device=dev)
        if not extra.in_use.ts_hard:
            return out
        elig = required_node_affinity_mask(pods, nodes) & nodes.valid[None, :]
        K, D, _ = extra.topo_onehot.shape
        onehot_t = extra.topo_onehot.reshape(K * D, N).t().double()  # (N, K·D)
        rows = torch.arange(P, device=dev)
        # exists[p, k, d]: some ELIGIBLE node sits in domain d of key k
        e_all = sharding.node_matmul(elig.double(), onehot_t).reshape(P, K, D) > 0
        for c in extra.in_use.ts_hard:
            active = (extra.ts_n > c) & (extra.ts_mode[:, c] == TS_DO_NOT_SCHEDULE)
            combo = extra.ts_combo[:, c].long()
            haskey = extra.combo_haskey.index_select(0, combo)  # (P, N)
            # domain sums over the pod's ELIGIBLE nodes only
            x = torch.where(elig, extra.combo_here.index_select(0, combo), 0)
            key = extra.combo_key[combo].long()  # (P,)
            unique = extra.topo_unique[key]  # (P,)
            a_all = sharding.node_matmul(x.double(), onehot_t).reshape(P, K, D)
            A = a_all[rows, key].to(torch.int32)  # (P, D) the pod's key row
            exists = e_all[rows, key]  # (P, D)
            # zone-like path: each node's domain sum, through its domain id
            # (keyless nodes read the zero column D; haskey masks them)
            dom = extra.topo_domain.index_select(0, key).long()  # (P, N)
            dsum_z = torch.cat([A, A.new_zeros(P, 1)], dim=1).gather(1, dom)
            m_z = torch.where(exists, A, _INF).amin(dim=1)
            # hostname-like path: every domain is one node
            m_u = sharding.node_min(
                torch.where(elig & haskey, x, _INF).amin(dim=1))
            dsum = torch.where(unique[:, None], x, dsum_z)
            m = torch.where(unique, m_u, m_z)
            ok = (haskey & (m < _INF)[:, None]
                  & (dsum + 1 - m[:, None] <= extra.ts_skew[:, c, None]))
            out &= ok | ~active[:, None]
        return out

    def batch_score(self, ctx: Any, pods: Any, nodes: Any,
                    aux: Dict[str, Any], extra: Any) -> torch.Tensor:
        _need(extra)
        P, N = extra.ts_combo.shape[0], nodes.valid.shape[0]
        total = torch.zeros((P, N), dtype=torch.int32, device=nodes.valid.device)
        if not extra.in_use.ts_soft:
            return total
        keyed = torch.where(extra.combo_haskey, extra.combo_dsum, 0)  # (C, N)
        # (C, 1) worst domain count
        worst = sharding.node_max(keyed.amax(dim=1, keepdim=True))
        # keyless nodes take the constraint's worst domain count
        plane = torch.where(extra.combo_haskey, extra.combo_dsum, worst)
        for c in extra.in_use.ts_soft:
            active = (extra.ts_n > c) & (extra.ts_mode[:, c] != TS_DO_NOT_SCHEDULE)
            contrib = plane.index_select(0, extra.ts_combo[:, c].long())
            total += torch.where(active[:, None], contrib, 0)
        return total

    def batch_normalize(self, ctx: Any, scores, mask):
        return minmax_normalize_batch(scores, mask, reverse=True,
                                      fill=MAX_NODE_SCORE)
