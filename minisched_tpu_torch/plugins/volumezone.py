"""VolumeZone: a bound PV's zone and region labels must match the node.

Counterpart of ``minisched_tpu/plugins/volumezone.py``, both halves: for
every
claim the pod mounts that is bound to a PV, each zone/region label the PV
carries must be matched exactly by the node's labels; unbound claims pass
(VolumeBinding owns them) and a missing claim passes nowhere.
``pv_zone_ok`` runs in the scalar filter (claims and PVs read through the
injected ``store_client``) and on the host in the constraint-table build;
the batch filter gathers the ``claim_zone_ok[C2, N]`` rows.
"""

from __future__ import annotations

from typing import Any, List

import torch

from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.framework.types import CycleState, Status
from minisched_tpu_torch.plugins.volumebinding import claims_pass

NAME = "VolumeZone"

REASON_ZONE = "node(s) had no available volume zone"
REASON_UNBOUND = "pod has unbound immediate PersistentVolumeClaims"

#: the topology labels treated as zonal: the GA and the deprecated beta
#: spellings
ZONE_LABELS = (
    "topology.kubernetes.io/zone",
    "topology.kubernetes.io/region",
    "failure-domain.beta.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/region",
)


def pv_zone_ok(pv: Any, node: Any) -> bool:
    """PV ↔ node zone compatibility."""
    labels = node.metadata.labels
    for key in ZONE_LABELS:
        want = pv.metadata.labels.get(key)
        if want is not None and labels.get(key) != want:
            return False
    return True


class VolumeZone(BatchEvaluable):
    needs_extra = True
    #: zone verdicts do not change as pods commit: nothing to carry
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
        return NAME

    def filter(self, state: CycleState, pod: Any, node_info: Any) -> Status:
        if not pod.spec.volumes:
            return Status.success()
        if self.store_client is None:
            return Status.error(f"{NAME}: no store client injected")
        store = self.store_client.store
        for vol in pod.spec.volumes:
            try:
                pvc = store.get("PersistentVolumeClaim",
                                pod.metadata.namespace, vol)
            except KeyError:
                return Status.unresolvable(REASON_UNBOUND).with_plugin(NAME)
            if not pvc.spec.volume_name:
                continue  # unbound: VolumeBinding's concern
            try:
                pv = store.get("PersistentVolume", "", pvc.spec.volume_name)
            except KeyError:
                return Status.unresolvable(REASON_UNBOUND).with_plugin(NAME)
            if not pv_zone_ok(pv, node_info.node):
                return Status.unschedulable(REASON_ZONE).with_plugin(NAME)
        return Status.success()

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any,
                     extra: Any) -> torch.Tensor:
        if extra is None:
            raise ValueError("VolumeZone batch kernel needs the wave's "
                             "ConstraintTables — pass `extra`")
        return claims_pass(extra, extra.claim_zone_ok)
