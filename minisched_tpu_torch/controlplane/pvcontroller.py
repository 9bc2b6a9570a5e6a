"""PersistentVolume controller: static binding and dynamic provisioning.

A copy of ``minisched_tpu/controlplane/pvcontroller.py``.  The reference
runs the upstream PV controller with dynamic provisioning on
(pvcontroller/pvcontroller.go:24-32) so PVC-binding scenarios work; this
controller does both halves:

* **static binding**: a pending claim binds to the first free PV of
  sufficient capacity;
* **dynamic provisioning**: a claim with a ``storage_class_name`` that no
  existing PV fits gets a fresh PV created and bound (a class naming a
  driver family of ``plugins/volumelimits.FAMILIES`` provisions that
  family's volumes).  A claim without a storage class never provisions:
  the upstream "static binding only" the reference scenario relies on.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any

from minisched_tpu_torch.api.objects import (
    ObjectMeta,
    PersistentVolume,
    PVSpec,
)
from minisched_tpu_torch.controlplane.client import KIND_PV, KIND_PVC, Client
from minisched_tpu_torch.controlplane.informer import (
    ResourceEventHandlers,
    SharedInformerFactory,
)
from minisched_tpu_torch.plugins.volumelimits import FAMILIES


class PVController:
    def __init__(self, client: Client, provisioning_enabled: bool = True):
        self._client = client
        self._provisioning_enabled = provisioning_enabled
        self._factory = SharedInformerFactory(client.store)
        self._lock = threading.Lock()
        self._factory.informer_for(KIND_PVC).add_event_handlers(
            ResourceEventHandlers(on_add=self._try_bind))
        self._factory.informer_for(KIND_PV).add_event_handlers(
            ResourceEventHandlers(on_add=lambda pv: self._rescan()))

    def start(self) -> "PVController":
        self._factory.start()
        if not self._factory.wait_for_cache_sync(timeout=300.0):
            raise RuntimeError("PV controller informer caches failed to sync")
        return self

    def stop(self) -> None:
        self._factory.shutdown()

    def _rescan(self) -> None:
        for pvc in self._client.store.list(KIND_PVC):
            self._try_bind(pvc)

    def _try_bind(self, pvc: Any) -> None:
        with self._lock:
            pvc = self._client.store.get(KIND_PVC, pvc.metadata.namespace,
                                         pvc.metadata.name)
            if pvc.spec.volume_name:
                return
            for pv in self._client.store.list(KIND_PV):
                if pv.spec.claim_ref or pv.spec.capacity < pvc.spec.request:
                    continue
                self._bind(pvc, pv)
                return
            if self._provisioning_enabled and pvc.spec.storage_class_name:
                self._bind(pvc, self._provision(pvc))

    def _bind(self, pvc: Any, pv: Any) -> None:
        pv.spec.claim_ref = pvc.metadata.key
        self._client.store.update(KIND_PV, pv)
        pvc.spec.volume_name = pv.metadata.name
        pvc.status.phase = "Bound"
        self._client.store.update(KIND_PVC, pvc)

    def _provision(self, pvc: Any) -> Any:
        """Create a fresh PV for the claim (upstream's provisioner path);
        the class name doubles as the driver family when it names one."""
        sc = pvc.spec.storage_class_name
        # upstream names provisioned PVs pvc-<uid>: unique even across a
        # delete and recreate of the claim (the old PV lingers bound)
        name = f"pvc-{pvc.metadata.uid or uuid.uuid4().hex[:12]}"
        if any(pv.metadata.name == name
               for pv in self._client.store.list(KIND_PV)):
            name = f"pvc-{uuid.uuid4().hex[:12]}"
        pv = PersistentVolume(
            metadata=ObjectMeta(
                name=name, namespace="",
                labels={"pv.kubernetes.io/provisioned-by": sc}),
            spec=PVSpec(capacity=max(pvc.spec.request, 1),
                        driver=sc if sc in FAMILIES else ""))
        return self._client.store.create(KIND_PV, pv)


def start_pv_controller(client: Client, provisioning_enabled: bool = True
                        ) -> PVController:
    """pvcontroller.go:16-44's StartPersistentVolumeController (dynamic
    provisioning on by default, pvcontroller.go:24-32)."""
    return PVController(client,
                        provisioning_enabled=provisioning_enabled).start()
