"""The port's PV controller: every case of ``tests/test_pvcontroller.py``
(static binding, dynamic provisioning, a pod that schedules only after
its claim is provisioned, on both engines), and the controller's PVs and
claims equal to the JAX controller's on one script."""

from __future__ import annotations

import time

import pytest

from minisched_tpu_torch.api.objects import (
    ObjectMeta,
    PersistentVolume,
    PersistentVolumeClaim,
    PVCSpec,
    PVSpec,
    make_node,
    make_pod,
)
from minisched_tpu_torch.controlplane.client import KIND_PV, KIND_PVC, Client
from minisched_tpu_torch.controlplane.pvcontroller import start_pv_controller

GI = 1024**3


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _pv(name, capacity):
    return PersistentVolume(
        metadata=ObjectMeta(name=name, namespace=""),
        spec=PVSpec(capacity=capacity),
    )


def _pvc(name, request):
    return PersistentVolumeClaim(
        metadata=ObjectMeta(name=name), spec=PVCSpec(request=request)
    )


def test_pvc_binds_to_sufficient_pv():
    client = Client()
    ctrl = start_pv_controller(client)
    try:
        client.store.create(KIND_PV, _pv("small", 1 * GI))
        client.store.create(KIND_PV, _pv("big", 10 * GI))
        client.store.create(KIND_PVC, _pvc("claim", 5 * GI))
        assert _wait(
            lambda: client.store.get(KIND_PVC, "default", "claim").status.phase
            == "Bound"
        )
        pvc = client.store.get(KIND_PVC, "default", "claim")
        assert pvc.spec.volume_name == "big"  # 1Gi PV too small
        pv = client.store.get(KIND_PV, "", "big")
        assert pv.spec.claim_ref == "default/claim"
    finally:
        ctrl.stop()


def test_pvc_waits_for_pv_created_later():
    """The reference scenario shape: a pending claim binds when a feasible
    PV appears (event-driven rescan)."""
    client = Client()
    ctrl = start_pv_controller(client)
    try:
        client.store.create(KIND_PVC, _pvc("claim", 2 * GI))
        time.sleep(0.1)
        assert (
            client.store.get(KIND_PVC, "default", "claim").status.phase
            == "Pending"
        )
        client.store.create(KIND_PV, _pv("late", 4 * GI))
        assert _wait(
            lambda: client.store.get(KIND_PVC, "default", "claim").spec.volume_name
            == "late"
        )
    finally:
        ctrl.stop()


def test_bound_pv_not_double_claimed():
    client = Client()
    ctrl = start_pv_controller(client)
    try:
        client.store.create(KIND_PV, _pv("only", 4 * GI))
        client.store.create(KIND_PVC, _pvc("first", 1 * GI))
        assert _wait(
            lambda: client.store.get(KIND_PVC, "default", "first").spec.volume_name
            == "only"
        )
        client.store.create(KIND_PVC, _pvc("second", 1 * GI))
        time.sleep(0.15)
        assert (
            client.store.get(KIND_PVC, "default", "second").spec.volume_name == ""
        )
    finally:
        ctrl.stop()


def test_dynamic_provisioning_for_storage_class_claim():
    """A claim naming a storage class with no fitting PV gets a fresh
    volume provisioned and bound (pvcontroller.go:24-32's enabled
    provisioning); a classless claim stays Pending."""
    client = Client()
    ctrl = start_pv_controller(client)
    try:
        client.store.create(
            KIND_PVC,
            PersistentVolumeClaim(
                metadata=ObjectMeta(name="dyn"),
                spec=PVCSpec(request=5 * GI, storage_class_name="standard"),
            ),
        )
        client.store.create(KIND_PVC, _pvc("static", 5 * GI))
        assert _wait(
            lambda: client.store.get(KIND_PVC, "default", "dyn").status.phase
            == "Bound"
        )
        pvc = client.store.get(KIND_PVC, "default", "dyn")
        assert pvc.spec.volume_name.startswith("pvc-")
        pv = client.store.get(KIND_PV, "", pvc.spec.volume_name)
        assert pv.spec.claim_ref == "default/dyn"
        assert pv.spec.capacity >= 5 * GI
        # no storage class → static binding only, stays pending
        assert client.store.get(KIND_PVC, "default", "static").status.phase != "Bound"
    finally:
        ctrl.stop()


def test_provisioned_class_maps_to_driver_family():
    client = Client()
    ctrl = start_pv_controller(client)
    try:
        client.store.create(
            KIND_PVC,
            PersistentVolumeClaim(
                metadata=ObjectMeta(name="disk"),
                spec=PVCSpec(request=GI, storage_class_name="ebs"),
            ),
        )
        assert _wait(
            lambda: client.store.get(KIND_PVC, "default", "disk").status.phase
            == "Bound"
        )
        vol = client.store.get(KIND_PVC, "default", "disk").spec.volume_name
        assert client.store.get(KIND_PV, "", vol).spec.driver == "ebs"
    finally:
        ctrl.stop()


def test_provisioning_disabled_leaves_claim_pending():
    client = Client()
    ctrl = start_pv_controller(client, provisioning_enabled=False)
    try:
        client.store.create(
            KIND_PVC,
            PersistentVolumeClaim(
                metadata=ObjectMeta(name="dyn"),
                spec=PVCSpec(request=GI, storage_class_name="standard"),
            ),
        )
        time.sleep(0.3)
        assert client.store.get(KIND_PVC, "default", "dyn").status.phase != "Bound"
    finally:
        ctrl.stop()


@pytest.mark.parametrize("device_mode", [False, True])
def test_pod_schedules_only_after_provisioning(device_mode):
    """A pod mounting a storage-class claim parks while no PV exists (the
    controller is down), then the controller starts and provisions, the
    PVC event requeues the pod, and it binds."""
    from minisched_tpu_torch.service.config import default_full_roster_config
    from minisched_tpu_torch.service.service import SchedulerService

    client = Client()
    svc = SchedulerService(client)
    cfg = default_full_roster_config(time_scale=0.01)
    cfg.queue_opts = {"initial_backoff_s": 0.05, "max_backoff_s": 0.2}
    svc.start_scheduler(cfg, device_mode=device_mode, device="cpu")
    ctrl = None
    try:
        client.nodes().create(make_node("node1"))
        client.store.create(
            KIND_PVC,
            PersistentVolumeClaim(
                metadata=ObjectMeta(name="data"),
                spec=PVCSpec(request=GI, storage_class_name="standard"),
            ),
        )
        client.pods().create(make_pod("pod1", volumes=["data"]))
        assert _wait(
            lambda: svc.scheduler.queue.stats()["unschedulable"] == 1, 10
        )
        assert client.pods().get("pod1").spec.node_name == ""
        ctrl = start_pv_controller(client)
        assert _wait(
            lambda: client.pods().get("pod1").spec.node_name == "node1", 15
        )
        assert svc.scheduler.loop_errors == 0
    finally:
        svc.shutdown_scheduler()
        if ctrl is not None:
            ctrl.stop()


def _controller_script(objs, client_mod, pv_mod):
    """Claims and PVs through a controller: (claims, volumes) as
    comparable tuples once every claim that can bind has."""
    client = client_mod.Client()
    ctrl = pv_mod.start_pv_controller(client)
    try:
        for name, cap in (("small", GI), ("big", 10 * GI), ("mid", 4 * GI)):
            client.store.create(client_mod.KIND_PV, objs.PersistentVolume(
                metadata=objs.ObjectMeta(name=name, namespace=""),
                spec=objs.PVSpec(capacity=cap)))
        claims = [("c1", 5 * GI, ""), ("c2", GI, ""), ("c3", 20 * GI, ""),
                  ("c4", 6 * GI, "ebs"), ("c5", 8 * GI, "standard"),
                  ("c6", 3 * GI, "standard")]
        for name, req, sc in claims:
            pvc = objs.PersistentVolumeClaim(
                metadata=objs.ObjectMeta(name=name),
                spec=objs.PVCSpec(request=req, storage_class_name=sc))
            pvc.metadata.uid = f"uid-{name}"
            client.store.create(client_mod.KIND_PVC, pvc)
            assert _wait(lambda: name == "c3" or client.store.get(
                client_mod.KIND_PVC, "default", name).spec.volume_name)
        got_claims = sorted(
            (c.metadata.name, c.spec.volume_name, c.status.phase)
            for c in client.store.list(client_mod.KIND_PVC))
        got_pvs = sorted(
            (v.metadata.name, v.spec.capacity, v.spec.claim_ref,
             v.spec.driver, tuple(sorted(v.metadata.labels.items())))
            for v in client.store.list(client_mod.KIND_PV))
        return got_claims, got_pvs
    finally:
        ctrl.stop()


def test_controller_equal_to_jax():
    """One script of claims (statically bound, provisioned for a driver
    family and for a plain class, and one that fits nothing) through both
    controllers: the same claims bound to the same volumes, the same
    provisioned PVs."""
    from minisched_tpu.api import objects as jobjs
    from minisched_tpu.controlplane import client as jclient
    from minisched_tpu.controlplane import pvcontroller as jpv

    from minisched_tpu_torch.api import objects as tobjs
    from minisched_tpu_torch.controlplane import client as tclient
    from minisched_tpu_torch.controlplane import pvcontroller as tpv

    got = _controller_script(tobjs, tclient, tpv)
    want = _controller_script(jobjs, jclient, jpv)
    assert got == want
    assert ("c4", "pvc-uid-c4", "Bound") in got[0]
    assert ("c6", "mid", "Bound") in got[0]  # a class, yet a PV fits
    assert ("c3", "", "Pending") in got[0]
    assert {v[3] for v in got[1] if v[0].startswith("pvc-")} == {"ebs", ""}
