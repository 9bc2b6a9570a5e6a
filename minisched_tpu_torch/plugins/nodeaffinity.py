"""NodeAffinity: ``spec.nodeSelector`` and required node affinity as a
filter, weighted preferred terms as a score.

Counterpart of ``minisched_tpu/plugins/nodeaffinity.py``, both halves.
The scalar halves read the node's labels (``node_affinity_eligible`` is
also PodTopologySpread's eligibility rule).  In the batch form the
encoded expressions (``models/tables.py``: terms × requirements × values)
are evaluated against the node LABEL PROFILES (Dp rows) and expanded to
(P, N) with one gather through ``nodes.profile_id``.

The JAX package skips each selector slot, the required-affinity terms and
the preferred terms with ``lax.cond`` when no pod of the wave uses them.
Here the same skips follow ``pods.use`` (``models/tables.PodUse``), which
the host read from its own columns when it packed the table, so no
branch waits for the card; a skipped part equals its computed result
(all-true masks, zero scores).  The skips matter where the nodes carry
many distinct label sets, as they do when each node has its own
``kubernetes.io/hostname``: the term lookup is (P, T, R, Dp, L).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.framework.types import CycleState, Status
from minisched_tpu_torch.models import tables

NAME = "NodeAffinity"


def node_affinity_eligible(pod: Any, node: Any) -> Tuple[bool, str]:
    """Does ``node`` pass the pod's spec.nodeSelector and required node
    affinity?  (eligible, reason)."""
    labels = node.metadata.labels
    for k, v in pod.spec.node_selector.items():
        if labels.get(k) != v:
            return False, "node(s) didn't match Pod's node selector"
    aff = pod.spec.affinity
    na = aff.node_affinity if aff is not None else None
    if na is not None and na.required_terms is not None:
        if not any(term.matches(labels) for term in na.required_terms):
            return False, "node(s) didn't match Pod's node affinity"
    return True, ""


def _per_node(per_profile: torch.Tensor, nodes: Any) -> torch.Tensor:
    """(P, Dp) → (P, N) through each node's profile row."""
    return per_profile.index_select(1, nodes.profile_id.long())


def _label_in_range(nodes: Any) -> torch.Tensor:
    L = nodes.prof_label_key.shape[1]
    slots = torch.arange(L, device=nodes.prof_label_key.device)
    return slots[None, :] < nodes.prof_num_labels[:, None]  # (Dp, L)


def terms_match(prefix_arrays: Sequence[torch.Tensor], nodes: Any) -> torch.Tensor:
    """Encoded NodeSelectorTerms against the node label profiles.

    ``prefix_arrays``: (key, op, vals, nvals, numval, nreqs) of shapes
    (P,T,R), (P,T,R), (P,T,R,V), (P,T,R), (P,T,R), (P,T).  Returns
    bool[P, T, Dp]: term t of pod p matches label profile d."""
    key, op, vals, nvals, numval, nreqs = prefix_arrays
    P, T, R = key.shape
    dev = key.device
    # label lookup over (P,T,R,Dp,L), reduced at once over L: keys are
    # unique within a profile, so a masked sum selects the one slot's value
    present = (key[:, :, :, None, None] == nodes.prof_label_key[None, None, None]
               ) & _label_in_range(nodes)[None, None, None]  # (P,T,R,Dp,L)
    has_key = present.any(dim=4)  # (P,T,R,Dp)
    node_val = torch.where(present, nodes.prof_label_value[None, None, None],
                           0).sum(dim=4, dtype=torch.int32)
    num_ok = present & nodes.prof_label_num_ok[None, None, None]
    has_num = num_ok.any(dim=4)
    node_num = torch.where(num_ok, nodes.prof_label_numval[None, None, None],
                           0).sum(dim=4, dtype=torch.int32)
    V = vals.shape[3]
    v_in_range = torch.arange(V, device=dev)[None, None, None, :] < nvals[..., None]
    in_set = has_key & ((node_val[..., None] == vals[:, :, :, None, :])
                        & v_in_range[:, :, :, None, :]).any(dim=4)  # (P,T,R,Dp)
    numval_b = numval[..., None]
    num_gt = has_num & (node_num > numval_b)
    num_lt = has_num & (node_num < numval_b)
    op_b = op[..., None]
    req_ok = (
        ((op_b == tables.OP_IN) & in_set)
        | ((op_b == tables.OP_NOT_IN) & ~in_set)
        | ((op_b == tables.OP_EXISTS) & has_key)
        | ((op_b == tables.OP_DOES_NOT_EXIST) & ~has_key)
        | ((op_b == tables.OP_GT) & num_gt)
        | ((op_b == tables.OP_LT) & num_lt)
    )  # (P,T,R,Dp)
    req_in_range = torch.arange(R, device=dev)[None, None, :] < nreqs[:, :, None]
    return (req_ok | ~req_in_range[..., None]).all(dim=2)  # (P,T,Dp)


def required_node_affinity_mask(pods: Any, nodes: Any) -> torch.Tensor:
    """bool[P, N]: the node passes the pod's spec.nodeSelector (AND over
    its label pairs) and required node affinity (OR over terms)."""
    lab_in_range = _label_in_range(nodes)  # (Dp, L)
    sel_ok = None
    for s in range(min(pods.use.sel_slots, pods.sel_key.shape[1])):
        # selector slot s: the profile carries the exact label pair
        ok = ((pods.sel_key[:, s][:, None, None] == nodes.prof_label_key[None])
              & (pods.sel_value[:, s][:, None, None] == nodes.prof_label_value[None])
              & lab_in_range[None]).any(dim=2)  # (P, Dp)
        ok |= (pods.num_sel <= s)[:, None]
        sel_ok = ok if sel_ok is None else sel_ok & ok
    ok = sel_ok
    if pods.use.aff_required:
        term_match = terms_match(
            (pods.aff_key, pods.aff_op, pods.aff_vals, pods.aff_nvals,
             pods.aff_numval, pods.aff_nreqs), nodes)  # (P,T,Dp)
        T = pods.aff_key.shape[1]
        term_in_range = torch.arange(T, device=pods.aff_key.device)[None, :] < pods.aff_nterms[:, None]
        any_term = (term_match & term_in_range[:, :, None]).any(dim=1)  # (P, Dp)
        # a required affinity with an empty term list matches nothing; no
        # requirement passes every node
        aff_ok = any_term | ~pods.aff_required[:, None]
        ok = aff_ok if ok is None else ok & aff_ok
    if ok is None:  # no selector and no required affinity in the wave
        return torch.ones((pods.valid.shape[0], nodes.valid.shape[0]),
                          dtype=torch.bool, device=pods.valid.device)
    return _per_node(ok, nodes)


class NodeAffinity(BatchEvaluable):
    def events_to_register(self) -> List[ClusterEvent]:
        """The cluster events that may make a pod this plugin rejected
        schedulable again (the JAX plugin's registration)."""
        return [ClusterEvent(GVK.NODE,
                             ActionType.ADD | ActionType.UPDATE_NODE_LABEL)]

    def name(self) -> str:
        return NAME

    def filter(self, state: CycleState, pod: Any, node_info: Any) -> Status:
        node = node_info.node
        if node is None:
            return Status.unresolvable("node not found")
        ok, reason = node_affinity_eligible(pod, node)
        if not ok:
            return Status.unresolvable(reason).with_plugin(NAME)
        return Status.success()

    def score(self, state: CycleState, pod: Any,
              node_name: str) -> Tuple[int, Status]:
        labels = state.read("nodeinfo/" + node_name).node.metadata.labels
        aff = pod.spec.affinity
        na = aff.node_affinity if aff is not None else None
        if na is None:
            return 0, Status.success()
        return (sum(p.weight for p in na.preferred
                    if p.preference.matches(labels)), Status.success())

    def score_extensions(self) -> None:
        return None

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any) -> torch.Tensor:
        return required_node_affinity_mask(pods, nodes)

    def batch_score(self, ctx: Any, pods: Any, nodes: Any,
                    aux: Dict[str, Any]) -> torch.Tensor:
        """Sum of the weights of the pod's preferred terms the node's
        labels match."""
        if not pods.use.pref_terms:
            return torch.zeros((pods.valid.shape[0], nodes.valid.shape[0]),
                               dtype=torch.int32, device=pods.valid.device)
        term_match = terms_match(
            (pods.pref_key, pods.pref_op, pods.pref_vals, pods.pref_nvals,
             pods.pref_numval, pods.pref_nreqs), nodes)  # (P,T,Dp)
        T = pods.pref_key.shape[1]
        term_in_range = (torch.arange(T, device=pods.pref_key.device)[None, :]
                         < pods.pref_nterms[:, None])
        weights = torch.where(term_match & term_in_range[:, :, None],
                              pods.pref_weight[:, :, None], 0)
        return _per_node(weights.sum(dim=1, dtype=torch.int32), nodes)
