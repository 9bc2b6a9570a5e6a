"""InterPodAffinity, batch form: required and preferred pod
(anti-)affinity in both directions.

Counterpart of ``minisched_tpu/plugins/interpodaffinity.py:212-289``:

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

from typing import Any, Dict, List

import torch

from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.plugins.normalize import minmax_normalize_batch

NAME = "InterPodAffinity"


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
