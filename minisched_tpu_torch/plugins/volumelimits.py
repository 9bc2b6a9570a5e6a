"""Per-cloud volume attach limits: EBSLimits, GCEPDLimits,
AzureDiskLimits, and the shared counting core.

Counterpart of ``minisched_tpu/plugins/volumelimits.py``, both halves.
Each
plugin counts only the volumes of its own driver family against that
family's per-node limit; the generic counter (``NodeVolumeLimits``, every
volume no named cloud family claims) lives in ``plugins/volumebinding.py``
as in the JAX package.  A volume's family is the ``driver`` of the PV its
claim is bound to; unbound or unresolvable claims count as generic.  The
scalar filter resolves claims through the injected ``store_client`` (with
none injected every volume is generic, keyed by its claim).  For the
batch form the family resolution runs on the host (``models/constraints.py``); the batch
filter reads the ``pod_vols_fam``-side slot planes and the carried
``node_vols_fam``/``vol_any`` planes of the wave's ConstraintTables.

Default limits, as the JAX package: EBS 39, GCE PD 16, Azure Disk 16,
generic 16.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.framework.types import CycleState, Status

#: family axis of the pod_vols_fam/node_vols_fam constraint planes;
#: index 0 is the generic (non-cloud / CSI / unbound) family
FAMILIES = ("", "ebs", "gcepd", "azuredisk")
FAM_GENERIC, FAM_EBS, FAM_GCEPD, FAM_AZURE = range(len(FAMILIES))

REASON_LIMIT = "node(s) exceed max volume count"

DEFAULT_MAX_VOLUMES = 16  # generic / GCE PD / Azure Disk
DEFAULT_MAX_EBS = 39  # AWS attach limit


class _PVLookup:
    """``get(name)``: the PersistentVolume of that name from the store, or
    None, each name read once.  The JAX filter lists every PV per call;
    the port's store clones each object it returns, so the filter reads
    only the PVs its claims name (the same answers)."""

    def __init__(self, store: Any):
        self._store = store
        self._seen: dict = {}

    def get(self, name: str) -> Optional[Any]:
        if name not in self._seen:
            try:
                self._seen[name] = self._store.get("PersistentVolume", "",
                                                   name)
            except KeyError:
                self._seen[name] = None
        return self._seen[name]


def volume_family(pvc: Optional[Any], pv_by_name: Any) -> int:
    """Family index of one claim: its bound PV's driver, else generic."""
    if pvc is None or not pvc.spec.volume_name:
        return FAM_GENERIC
    pv = pv_by_name.get(pvc.spec.volume_name)
    if pv is None or pv.spec.driver not in FAMILIES:
        return FAM_GENERIC
    return FAMILIES.index(pv.spec.driver)


class VolumeLimitsCore(BatchEvaluable):
    """Shared counting core: the pod's NEW family-f attachments plus the
    node's attached family-f volumes must stay within ``max_volumes``."""

    reads_committed_state = True  # intra-wave commits change the verdict
    needs_extra = True
    #: the repair loop's marker for volume-limit plugins (ops/repair.py
    #: reads it with ``max_volumes``)
    volume_family_index = FAM_GENERIC
    #: the scan carries the committed attach counts and mounts for it
    scan_carried_planes = ("volumes",)

    def events_to_register(self) -> List[ClusterEvent]:
        """The cluster events that may make a pod this plugin rejected
        schedulable again (the JAX plugin's registration)."""
        return [ClusterEvent(GVK.POD, ActionType.DELETE)]

    def __init__(self, max_volumes: Optional[int] = None):
        self.max_volumes = (max_volumes if max_volumes is not None
                            else self.default_max())
        self.store_client: Any = None  # injected by the engine's builder

    @classmethod
    def default_max(cls) -> int:
        return DEFAULT_MAX_VOLUMES

    def _family_keys(self, pod: Any, store: Any, pv_by_name: Any):
        """(the counting keys of this family's volumes the pod mounts, the
        number of its unresolvable mounts).  A key names a VOLUME (the
        bound PV, or the claim while unbound), so mounts of one volume
        count once; an unresolvable mount has no identity and counts one
        (generic family)."""
        f = self.volume_family_index
        if store is None:
            # no control plane: every volume is generic, keyed by its claim
            if f != FAM_GENERIC:
                return set(), 0
            return {(pod.metadata.namespace, v) for v in pod.spec.volumes}, 0
        keys = set()
        missing = 0
        for vol in pod.spec.volumes:
            try:
                pvc = store.get("PersistentVolumeClaim",
                                pod.metadata.namespace, vol)
            except KeyError:
                missing += 1
                continue
            if volume_family(pvc, pv_by_name) != f:
                continue
            keys.add(("pv", pvc.spec.volume_name) if pvc.spec.volume_name
                     else ("pvc", f"{pod.metadata.namespace}/{vol}"))
        return keys, (missing if f == FAM_GENERIC else 0)

    def filter(self, state: CycleState, pod: Any, node_info: Any) -> Status:
        if not pod.spec.volumes:
            return Status.success()
        store = (self.store_client.store if self.store_client is not None
                 else None)
        # one PV lookup per call, shared by the pod and the node's pods
        pv_by_name = _PVLookup(store) if store is not None else {}
        pod_keys, pod_missing = self._family_keys(pod, store, pv_by_name)
        node_keys: set = set()
        node_missing = 0
        for p in node_info.pods:
            if not p.spec.volumes:
                continue
            k, m = self._family_keys(p, store, pv_by_name)
            node_keys |= k
            node_missing += m
        # only volumes not already attached to the node are new
        new = len(pod_keys - node_keys) + pod_missing
        if new == 0:
            return Status.success()
        if len(node_keys) + node_missing + new > self.max_volumes:
            return Status.unschedulable(REASON_LIMIT).with_plugin(self.name())
        return Status.success()

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any,
                     extra: Any) -> torch.Tensor:
        """The JAX kernel's (P, V, N) ``vol_any[cnt]`` gather, folded one
        mount slot at a time into the (P, N) count of new attachments."""
        if extra is None:
            raise ValueError(f"{self.name()} batch kernel needs the wave's "
                             "ConstraintTables — pass `extra`")
        f = self.volume_family_index
        P, N = pods.valid.shape[0], nodes.valid.shape[0]
        new = torch.zeros((P, N), dtype=torch.int32, device=nodes.valid.device)
        cnts, uses = [], []
        for j in range(extra.in_use.vols):
            # mount slot j of every pod: in range and a real claim
            live = (extra.pod_n_vols > j) & extra.pod_claim_valid[:, j]
            claim = extra.pod_claims[:, j].long()
            cnt = extra.claim_cnt[claim]  # (P,) counting row
            use = live & (extra.claim_family[claim] == f)
            # mounts sharing one volume within the pod count once
            dup = torch.zeros_like(use)
            for cnt_b, use_b in zip(cnts, uses):
                dup |= (cnt_b == cnt) & use_b
            cnts.append(cnt)
            uses.append(use)
            # a volume already attached to the node is no NEW attachment
            attached = extra.vol_any.index_select(0, cnt.long())  # (P, N)
            new += ((use & ~dup)[:, None] & ~attached).to(torch.int32)
        if f == FAM_GENERIC:
            new += extra.pod_missing[:, None]
        fits = extra.node_vols_fam[f][None, :] + new <= self.max_volumes
        return (new == 0) | fits


class EBSLimits(VolumeLimitsCore):
    volume_family_index = FAM_EBS

    @classmethod
    def default_max(cls) -> int:
        return DEFAULT_MAX_EBS

    def name(self) -> str:
        return "EBSLimits"


class GCEPDLimits(VolumeLimitsCore):
    volume_family_index = FAM_GCEPD

    def name(self) -> str:
        return "GCEPDLimits"


class AzureDiskLimits(VolumeLimitsCore):
    volume_family_index = FAM_AZURE

    def name(self) -> str:
        return "AzureDiskLimits"
