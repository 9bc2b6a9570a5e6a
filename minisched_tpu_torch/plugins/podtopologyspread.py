"""PodTopologySpread, batch form: even spreading across topology domains.

Counterpart of ``minisched_tpu/plugins/podtopologyspread.py:183-337``:

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

from typing import Any, Dict, List

import torch

from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import MAX_NODE_SCORE, BatchEvaluable
from minisched_tpu_torch.models.constraints import TS_DO_NOT_SCHEDULE
from minisched_tpu_torch.plugins.nodeaffinity import required_node_affinity_mask
from minisched_tpu_torch.plugins.normalize import minmax_normalize_batch

NAME = "PodTopologySpread"

_INF = 1 << 30


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
        e_all = (elig.double() @ onehot_t).reshape(P, K, D) > 0
        for c in extra.in_use.ts_hard:
            active = (extra.ts_n > c) & (extra.ts_mode[:, c] == TS_DO_NOT_SCHEDULE)
            combo = extra.ts_combo[:, c].long()
            haskey = extra.combo_haskey.index_select(0, combo)  # (P, N)
            # domain sums over the pod's ELIGIBLE nodes only
            x = torch.where(elig, extra.combo_here.index_select(0, combo), 0)
            key = extra.combo_key[combo].long()  # (P,)
            unique = extra.topo_unique[key]  # (P,)
            a_all = (x.double() @ onehot_t).reshape(P, K, D)
            A = a_all[rows, key].to(torch.int32)  # (P, D) the pod's key row
            exists = e_all[rows, key]  # (P, D)
            # zone-like path: each node's domain sum, through its domain id
            # (keyless nodes read the zero column D; haskey masks them)
            dom = extra.topo_domain.index_select(0, key).long()  # (P, N)
            dsum_z = torch.cat([A, A.new_zeros(P, 1)], dim=1).gather(1, dom)
            m_z = torch.where(exists, A, _INF).amin(dim=1)
            # hostname-like path: every domain is one node
            m_u = torch.where(elig & haskey, x, _INF).amin(dim=1)
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
        worst = keyed.amax(dim=1, keepdim=True)  # (C, 1) worst domain count
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
