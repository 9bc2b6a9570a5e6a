"""InterPodAffinity: required and preferred pod (anti-)affinity in both
directions.

Counterpart of ``minisched_tpu/plugins/interpodaffinity.py``, both
halves.  The scalar half counts matching assigned pods per topology
domain in PreFilter and PreScore (walking the snapshot's pods) and reads
the counts per node; its status reasons are the JAX strings.  The batch
half:

* The filter rejects a node when an ASSIGNED pod's required
  anti-affinity term matches the incoming pod and the node shares that
  pod's topology domain (``pod_matches_ex @ ex_domain``; inside a
  sequential scan also when a pod committed EARLIER IN THE SCAN holds such
  a term, ``pod_matches_combo @ combo_excl``), when one of the
  pod's own required anti-affinity terms has a matching assigned pod in
  the node's domain, or when a required affinity term has none (unless
  the pod matches its own term and no pod matches cluster-wide: then any
  node with the topology key qualifies).
* The score sums weight × matching pods in the node's domain over the
  pod's preferred terms (anti-affinity terms weigh negative), plus the
  symmetric direction ``pod_matches_combo @ rev_weight``; it normalizes
  min-max to [0, 100].

The JAX kernels gather (P, slots, N) planes (``combo_dsum[pa_combo]``
…) that XLA fuses away; here each slot folds into a (P, N) plane in turn,
and slots no pod of the wave uses are skipped (``ConstraintTables.in_use``).
The in-scan term runs only where the JAX filter compiles it (``ctx.in_scan``,
set by the scan lanes' schedulers) and only when some scanned pod has a
required anti-affinity term (``in_use.excl``, ``ops/sequential.py``): else
``combo_excl`` is all-False and the term passes every node.

CUDA has no integer matmul, so the three products run in floating point:

* the reverse anti-affinity products (assigned pods' terms, and in a scan
  the committed pods' ``combo_excl``) are only compared with 0; their
  terms are 0 or 1, so every partial sum is a non-negative count and no
  rounding in any float type (TF32 included) turns a positive sum into
  0: float32 is exact for that test;
* the symmetric score needs the exact signed sum.  It runs in float64:
  every product is an int32 ``rev_weight`` entry (``|w| < 2^31``) and a
  sum over C combos stays below 2^31·C < 2^53 for any C < 2^22, so every
  partial sum is an exact integer.  The JAX int32 ``einsum`` wraps past
  2^31; no real input gets there, since a node's ``rev_weight`` is a sum
  of term weights of 1 to 100 and would need over 21 million matching
  terms.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.framework.types import (
    CycleState,
    NodeScoreList,
    Status,
)
from minisched_tpu_torch.models.constraints import (
    _matches,
    _term_namespaces,
    rev_pref_terms_of,
)
from minisched_tpu_torch.plugins.normalize import (
    minmax_normalize_batch,
    minmax_normalize_scalar,
)

NAME = "InterPodAffinity"
PRE_FILTER_KEY = "PreFilter" + NAME
PRE_SCORE_KEY = "PreScore" + NAME

REASON_AFFINITY = "node(s) didn't match pod affinity rules"
REASON_ANTI = "node(s) didn't satisfy existing pods anti-affinity rules"


def _domain_counts(term: Any, pod_ns: str, node_infos: List[Any]):
    """(counts per topology value, global count) of the assigned pods
    matching the term's selector in the term's namespaces."""
    nss = _term_namespaces(term, pod_ns)
    counts: Dict[str, int] = {}
    total = 0
    for ni in node_infos:
        val = ni.node.metadata.labels.get(term.topology_key)
        for p in ni.pods:
            if _matches(term.label_selector, nss, p):
                total += 1
                if val is not None:
                    counts[val] = counts.get(val, 0) + 1
    return counts, total


class _Normalize:
    """Min-max to [0, 100]; all equal → 0."""

    def normalize_score(self, state: CycleState, pod: Any,
                        scores: NodeScoreList) -> Status:
        minmax_normalize_scalar(scores, reverse=False, fill=0)
        return Status.success()


def _rows(plane: torch.Tensor, combo: torch.Tensor) -> torch.Tensor:
    """(P, N) rows of a (C, N) combo plane, one per pod."""
    return plane.index_select(0, combo.long())


def _need(extra: Any) -> None:
    if extra is None:
        raise ValueError("InterPodAffinity batch kernels need the wave's "
                         "ConstraintTables (models/constraints.py) — pass "
                         "`extra`")


class InterPodAffinity(BatchEvaluable):
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
        ns = pod.metadata.namespace
        aff = pod.spec.affinity
        pa = aff.pod_affinity if aff is not None else None
        pan = aff.pod_anti_affinity if aff is not None else None
        aff_terms = []  # (term, counts, global count, self match)
        for term in pa.required if pa is not None else ():
            counts, total = _domain_counts(term, ns, node_infos)
            nss = _term_namespaces(term, ns)
            aff_terms.append(
                (term, counts, total, _matches(term.label_selector, nss, pod)))
        anti_terms = []  # (term, counts)
        for term in pan.required if pan is not None else ():
            counts, _ = _domain_counts(term, ns, node_infos)
            anti_terms.append((term, counts))
        # reverse direction: the assigned pods' required anti-affinity
        # terms that match the incoming pod forbid their (key, value)
        forbidden: set = set()
        for ni in node_infos:
            for q in ni.pods:
                qaff = q.spec.affinity
                qpan = qaff.pod_anti_affinity if qaff is not None else None
                for term in qpan.required if qpan is not None else ():
                    nss = _term_namespaces(term, q.metadata.namespace)
                    if not _matches(term.label_selector, nss, pod):
                        continue
                    val = ni.node.metadata.labels.get(term.topology_key)
                    if val is not None:
                        forbidden.add((term.topology_key, val))
        state.write(PRE_FILTER_KEY, (aff_terms, anti_terms, forbidden))
        return Status.success()

    def filter(self, state: CycleState, pod: Any, node_info: Any) -> Status:
        aff_terms, anti_terms, forbidden = state.read(PRE_FILTER_KEY)
        labels = node_info.node.metadata.labels
        for key, val in forbidden:
            if labels.get(key) == val:
                return Status.unresolvable(REASON_ANTI).with_plugin(NAME)
        for term, counts in anti_terms:
            val = labels.get(term.topology_key)
            if val is not None and counts.get(val, 0) > 0:
                return Status.unresolvable(REASON_ANTI).with_plugin(NAME)
        for term, counts, total, self_match in aff_terms:
            val = labels.get(term.topology_key)
            satisfied = val is not None and (
                counts.get(val, 0) > 0 or (total == 0 and self_match))
            if not satisfied:
                return Status.unschedulable(REASON_AFFINITY).with_plugin(NAME)
        return Status.success()

    def pre_score(self, state: CycleState, pod: Any,
                  nodes: List[Any]) -> Status:
        ns = pod.metadata.namespace
        node_infos = state.read("nodeinfos")
        aff = pod.spec.affinity
        weighted = []  # (topology key, counts, signed weight)
        if aff is not None and aff.pod_affinity is not None:
            for wt in aff.pod_affinity.preferred:
                counts, _ = _domain_counts(wt.term, ns, node_infos)
                weighted.append((wt.term.topology_key, counts, wt.weight))
        if aff is not None and aff.pod_anti_affinity is not None:
            for wt in aff.pod_anti_affinity.preferred:
                counts, _ = _domain_counts(wt.term, ns, node_infos)
                weighted.append((wt.term.topology_key, counts, -wt.weight))
        # symmetric direction: the assigned pods' preferred and required
        # affinity terms that match THIS pod score over their domain
        sym: Dict[Tuple[str, str], int] = {}  # (key, value) → Σ w
        for ni in node_infos:
            labels = ni.node.metadata.labels
            for q in ni.pods:
                for nss, sel, topo, w in rev_pref_terms_of(q):
                    if not _matches(sel, nss, pod):
                        continue
                    val = labels.get(topo)
                    if val is not None:
                        sym[(topo, val)] = sym.get((topo, val), 0) + w
        state.write(PRE_SCORE_KEY, (weighted, sym))
        return Status.success()

    def score(self, state: CycleState, pod: Any,
              node_name: str) -> Tuple[int, Status]:
        weighted, sym = state.read(PRE_SCORE_KEY)
        labels = state.read("nodeinfo/" + node_name).node.metadata.labels
        total = 0
        for topo_key, counts, w in weighted:
            val = labels.get(topo_key)
            if val is not None:
                total += w * counts.get(val, 0)
        for (topo_key, val), w in sym.items():
            if labels.get(topo_key) == val:
                total += w
        return total, Status.success()

    def score_extensions(self) -> _Normalize:
        return _Normalize()

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any,
                     extra: Any) -> torch.Tensor:
        _need(extra)
        use = extra.in_use
        P, N = extra.pod_matches_ex.shape[0], extra.combo_dsum.shape[1]
        ok = torch.ones((P, N), dtype=torch.bool, device=extra.vol_ok.device)
        if use.ex:  # reverse direction: assigned pods' anti-affinity
            hits = extra.pod_matches_ex.float() @ extra.ex_domain.float()
            ok &= ~(hits > 0)
        if getattr(ctx, "in_scan", False) and use.excl:
            # the same check against pods committed earlier in the scan
            hits = (extra.pod_matches_combo.float()
                    @ extra.combo_excl.float())
            ok &= ~(hits > 0)
        if use.pan or use.pa:
            occupied = extra.combo_dsum > 0  # (C, N)
        for j in range(use.pan):  # incoming required anti-affinity
            live = (extra.pan_n > j)[:, None]
            ok &= ~(_rows(occupied, extra.pan_combo[:, j]) & live)
        for j in range(use.pa):  # incoming required affinity + bootstrap
            combo = extra.pa_combo[:, j]
            bootstrap = (extra.combo_global[combo.long()] == 0) & extra.pa_self[:, j]
            sat = _rows(occupied, combo) | (bootstrap[:, None]
                                            & _rows(extra.combo_haskey, combo))
            ok &= sat | ~(extra.pa_n > j)[:, None]
        return ok

    def batch_score(self, ctx: Any, pods: Any, nodes: Any,
                    aux: Dict[str, Any], extra: Any) -> torch.Tensor:
        _need(extra)
        use = extra.in_use
        P, N = extra.ppa_combo.shape[0], extra.combo_dsum.shape[1]
        total = torch.zeros((P, N), dtype=torch.int32, device=extra.vol_ok.device)
        if use.ppa:
            keyed = torch.where(extra.combo_haskey, extra.combo_dsum, 0)
        for j in range(use.ppa):
            w = torch.where(extra.ppa_n > j, extra.ppa_w[:, j], 0)  # (P,)
            total += w[:, None] * _rows(keyed, extra.ppa_combo[:, j])  # wraps
        if use.rev:  # symmetric direction (float64: exact, see above)
            sym = (extra.pod_matches_combo.double()
                   @ extra.rev_weight.double())
            total += sym.to(torch.int64).to(torch.int32)
        return total

    def batch_normalize(self, ctx: Any, scores, mask):
        return minmax_normalize_batch(scores, mask, reverse=False, fill=0)
