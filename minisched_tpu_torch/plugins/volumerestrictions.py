"""VolumeRestrictions: single-attach volumes cannot share a node unless
every mount involved is read-only.

Counterpart of ``minisched_tpu/plugins/volumerestrictions.py``, both
halves.  The "same underlying disk" is two claims bound to one
PersistentVolume, and a mount's access intent is its claim's
``read_only`` flag.  The scalar filter resolves claims through the
injected ``store_client``.  In the batch form claim c conflicts on node n iff some mount of its volume there is writable, or
any mount exists there and c itself is writable; the repair loop
(``ops/repair.py``) carries the ``vol_any``/``vol_rw`` planes across
rounds, so pods committed earlier in the same wave count too.
"""

from __future__ import annotations

from typing import Any, List

import torch

from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.framework.types import CycleState, Status
from minisched_tpu_torch.plugins.volumebinding import claims_pass

NAME = "VolumeRestrictions"

REASON_CONFLICT = "node(s) had volume restrictions conflict"
REASON_UNBOUND = "pod has unbound immediate PersistentVolumeClaims"


def mounts_conflict(pvc: Any, other_pvc: Any) -> bool:
    """Two bound claims conflict iff they share a PV and either mount is
    writable."""
    return (bool(pvc.spec.volume_name)
            and pvc.spec.volume_name == other_pvc.spec.volume_name
            and not (pvc.spec.read_only and other_pvc.spec.read_only))


class VolumeRestrictions(BatchEvaluable):
    reads_committed_state = True  # intra-wave commits change the verdict
    needs_extra = True
    #: the repair loop's marker: carry per-volume mount state across
    #: rounds and dedup same-round mounts
    enforces_volume_restrictions = True
    #: the scan carries the committed mount planes for it
    scan_carried_planes = ("volumes",)

    def __init__(self):
        self.store_client: Any = None  # injected by the engine's builder

    def events_to_register(self) -> List[ClusterEvent]:
        """The cluster events that may make a pod this plugin rejected
        schedulable again (the JAX plugin's registration)."""
        return [
            ClusterEvent(GVK.POD, ActionType.DELETE),
            ClusterEvent(GVK.PERSISTENT_VOLUME_CLAIM,
                         ActionType.ADD | ActionType.UPDATE),
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
                continue  # unbound: no disk identity yet
            for other in node_info.pods:
                for ovol in other.spec.volumes:
                    try:
                        opvc = store.get("PersistentVolumeClaim",
                                         other.metadata.namespace, ovol)
                    except KeyError:
                        continue
                    if mounts_conflict(pvc, opvc):
                        return Status.unschedulable(
                            REASON_CONFLICT).with_plugin(NAME)
        return Status.success()

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any,
                     extra: Any) -> torch.Tensor:
        if extra is None:
            raise ValueError("VolumeRestrictions batch kernel needs the "
                             "wave's ConstraintTables — pass `extra`")
        cv = extra.claim_vol.clamp(min=0).long()
        bound = extra.claim_vol >= 0
        conflict = bound[:, None] & (
            extra.vol_rw.index_select(0, cv)
            | (extra.vol_any.index_select(0, cv) & ~extra.claim_ro[:, None])
        )  # (C2, N)
        return claims_pass(extra, ~conflict)
