"""VolumeRestrictions, batch form: single-attach volumes cannot share a
node unless every mount involved is read-only.

Counterpart of ``minisched_tpu/plugins/volumerestrictions.py:52-126``.
The "same underlying disk" is two claims bound to one PersistentVolume,
and a mount's access intent is its claim's ``read_only`` flag.  Claim c
conflicts on node n iff some mount of its volume there is writable, or
any mount exists there and c itself is writable; the repair loop
(``ops/repair.py``) carries the ``vol_any``/``vol_rw`` planes across
rounds, so pods committed earlier in the same wave count too.
"""

from __future__ import annotations

from typing import Any, List

import torch

from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.plugins.volumebinding import claims_pass

NAME = "VolumeRestrictions"


class VolumeRestrictions(BatchEvaluable):
    reads_committed_state = True  # intra-wave commits change the verdict
    needs_extra = True
    #: the repair loop's marker: carry per-volume mount state across
    #: rounds and dedup same-round mounts
    enforces_volume_restrictions = True
    #: the scan carries the committed mount planes for it
    scan_carried_planes = ("volumes",)

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
