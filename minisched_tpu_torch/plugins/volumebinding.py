"""Volume scheduling plugins: VolumeBinding and NodeVolumeLimits.

Counterpart of ``minisched_tpu/plugins/volumebinding.py``, both halves:

* ``VolumeBinding``: every claim the pod mounts must exist; a BOUND claim
  restricts the pod to nodes carrying its PV's required node labels; an
  UNBOUND claim needs some free PV of sufficient capacity whose labels the
  node satisfies.  ``claim_node_mask`` is the one definition of that
  verdict, run on the host by the constraint-table build
  (``models/constraints.py``); the batch filter gathers its
  ``claim_mask[C2, N]`` rows, and the scalar filter reads the claims and
  PVs through the injected ``store_client``.
* ``NodeVolumeLimits``: the generic member of the volume-limit family
  (``plugins/volumelimits.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.framework.types import CycleState, Status
from minisched_tpu_torch.plugins.volumelimits import FAM_GENERIC, VolumeLimitsCore

BINDING_NAME = "VolumeBinding"
LIMITS_NAME = "NodeVolumeLimits"

REASON_UNBOUND = "pod has unbound immediate PersistentVolumeClaims"
REASON_CONFLICT = "node(s) had volume node affinity conflict"
REASON_NO_PV = "node(s) didn't find available persistent volumes to bind"


def _labels_ok(required: Dict[str, str], node: Any) -> bool:
    labels = node.metadata.labels
    return all(labels.get(k) == v for k, v in required.items())


def claim_node_mask(pvc: Any, pvs: Any, nodes: Any) -> List[bool]:
    """Which nodes can host a pod mounting ``pvc``.  A claim bound to a
    missing PV passes nowhere."""
    if pvc.spec.volume_name:
        pv_by_name = {pv.metadata.name: pv for pv in pvs}
        pv = pv_by_name.get(pvc.spec.volume_name)
        if pv is None:
            return [False] * len(nodes)
        return [_labels_ok(pv.spec.required_node_labels, n) for n in nodes]
    free = [pv for pv in pvs
            if not pv.spec.claim_ref and pv.spec.capacity >= pvc.spec.request]
    return [any(_labels_ok(pv.spec.required_node_labels, n) for pv in free)
            for n in nodes]


def claims_pass(extra: Any, per_claim: torch.Tensor) -> torch.Tensor:
    """bool[P, N]: every claim the pod mounts passes on the node, with
    ``per_claim`` the bool[C2, N] verdict of each claim row; a pod with a
    missing claim passes nowhere.  The JAX kernel's (P, V, N) gather is
    folded one mount slot at a time."""
    P, N = extra.pod_claims.shape[0], per_claim.shape[1]
    ok = extra.vol_ok[:, None].expand(P, N)
    for j in range(extra.in_use.vols):
        in_range = extra.pod_n_vols > j
        rows = per_claim.index_select(0, extra.pod_claims[:, j].long())
        ok = ok & (rows | ~in_range[:, None])
    return ok.contiguous()


class VolumeBinding(BatchEvaluable):
    needs_extra = True
    #: claim verdicts do not change as pods commit: nothing to carry
    scan_carried_planes = ()

    def __init__(self):
        self.store_client: Any = None  # injected by the engine's builder

    def events_to_register(self) -> List[ClusterEvent]:
        """The cluster events that may make a pod this plugin rejected
        schedulable again (the JAX plugin's registration)."""
        return [
            ClusterEvent(GVK.PERSISTENT_VOLUME,
                         ActionType.ADD | ActionType.UPDATE),
            ClusterEvent(GVK.PERSISTENT_VOLUME_CLAIM,
                         ActionType.ADD | ActionType.UPDATE),
            ClusterEvent(GVK.NODE,
                         ActionType.ADD | ActionType.UPDATE_NODE_LABEL),
        ]

    def name(self) -> str:
        return BINDING_NAME

    def filter(self, state: CycleState, pod: Any, node_info: Any) -> Status:
        if not pod.spec.volumes:
            return Status.success()
        if self.store_client is None:
            return Status.error(f"{BINDING_NAME}: no store client injected")
        store = self.store_client.store
        node = node_info.node
        pvs = None  # listed lazily: a pod of bound claims never lists PVs
        for vol in pod.spec.volumes:
            try:
                pvc = store.get("PersistentVolumeClaim",
                                pod.metadata.namespace, vol)
            except KeyError:
                return Status.unresolvable(REASON_UNBOUND).with_plugin(
                    BINDING_NAME)
            if pvc.spec.volume_name:
                try:
                    pv = store.get("PersistentVolume", "",
                                   pvc.spec.volume_name)
                except KeyError:
                    return Status.unresolvable(REASON_UNBOUND).with_plugin(
                        BINDING_NAME)
                if not _labels_ok(pv.spec.required_node_labels, node):
                    return Status.unschedulable(REASON_CONFLICT).with_plugin(
                        BINDING_NAME)
            else:
                if pvs is None:
                    pvs = store.list("PersistentVolume")
                if not any(not pv.spec.claim_ref
                           and pv.spec.capacity >= pvc.spec.request
                           and _labels_ok(pv.spec.required_node_labels, node)
                           for pv in pvs):
                    return Status.unschedulable(REASON_NO_PV).with_plugin(
                        BINDING_NAME)
        return Status.success()

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any,
                     extra: Any) -> torch.Tensor:
        if extra is None:
            raise ValueError("VolumeBinding batch kernel needs the wave's "
                             "ConstraintTables (built with pvcs/pvs) — pass "
                             "`extra`")
        return claims_pass(extra, extra.claim_mask)


class NodeVolumeLimits(VolumeLimitsCore):
    """The generic volume counter: every volume not bound to a named
    cloud family."""

    volume_family_index = FAM_GENERIC

    def name(self) -> str:
        return LIMITS_NAME

