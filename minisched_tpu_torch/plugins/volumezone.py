"""VolumeZone, batch form: a bound PV's zone and region labels must match
the node.

Counterpart of ``minisched_tpu/plugins/volumezone.py:35-113``: for every
claim the pod mounts that is bound to a PV, each zone/region label the PV
carries must be matched exactly by the node's labels; unbound claims pass
(VolumeBinding owns them) and a missing claim passes nowhere.
``pv_zone_ok`` runs on the host in the constraint-table build; the batch
filter gathers the ``claim_zone_ok[C2, N]`` rows.
"""

from __future__ import annotations

from typing import Any, List

import torch

from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.plugins.volumebinding import claims_pass

NAME = "VolumeZone"

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

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any,
                     extra: Any) -> torch.Tensor:
        if extra is None:
            raise ValueError("VolumeZone batch kernel needs the wave's "
                             "ConstraintTables — pass `extra`")
        return claims_pass(extra, extra.claim_zone_ok)
