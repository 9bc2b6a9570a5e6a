"""Storage-integrity chaos on the port's device engine, on the CPU.

The port's copy of JAX's ``tests/test_disk_chaos.py::test_disk_chaos_smoke``
(``:608``; its soak ``:666`` stays JAX's and ``slow``): the in-process
device engine (``device="cpu"``) over a WAL store converges under at
least 5% injected append refusals, one ENOSPC episode and one live
bit-flip; the exactly-once and capacity audits hold, and the flipped
record is convicted by the live scrub, by ``fsck`` and by a strict
replay, never silently applied.
"""

from __future__ import annotations

import pytest

from minisched_tpu_torch.api.objects import make_node, make_pod
from minisched_tpu_torch.controlplane.client import Client
from minisched_tpu_torch.controlplane.durable import DurableObjectStore
from minisched_tpu_torch.controlplane.fsck import fsck
from minisched_tpu_torch.controlplane.walio import WalCorrupt
from minisched_tpu_torch.faults import FaultFabric, wal_double_binds
from minisched_tpu_torch.observability import counters
from minisched_tpu_torch.service.config import default_full_roster_config
from minisched_tpu_torch.service.service import SchedulerService
from tests.test_torch_chaos_soak import (
    SEED,
    _audit_capacity,
    _drive_to_convergence,
    _wait_assume_drain,
)


def _seed_cluster(client, n_nodes, n_pods):
    client.nodes().create_many([
        make_node(f"node{i:03d}",
                  capacity={"cpu": "8", "memory": "16Gi", "pods": 110})
        for i in range(n_nodes)])
    client.pods().create_many([
        make_pod(f"dp{i:04d}", requests={"cpu": "500m", "memory": "64Mi"})
        for i in range(n_pods)])


def test_disk_chaos_smoke(tmp_path):
    """The in-process device engine converges under append refusals, an
    ENOSPC episode and a live bit-flip; the flipped record is detected by
    replay and fsck."""
    wal = str(tmp_path / "disk.wal")
    store = DurableObjectStore(wal, probe_interval_s=0.05)
    client = Client(store=store)
    n_nodes, n_pods = 8, 48
    _seed_cluster(client, n_nodes, n_pods)
    counters.reset()
    fabric = (
        FaultFabric(SEED)
        .on("wal.append", rate=0.05)           # at least 5% refusals
        .on("disk.enospc", rate=1.0, after=10, max_fires=4)  # one episode
        .on("wal.bitflip", rate=1.0, after=25, max_fires=1)  # one flip
    )
    store.faults = fabric
    svc = SchedulerService(client)
    sched = svc.start_scheduler(default_full_roster_config(),
                                device_mode=True, max_wave=8, device="cpu")
    sched.assume_ttl_s = 2.0
    try:
        bound = _drive_to_convergence(client, sched, n_pods, 120.0)
        assert len(bound) == n_pods, (
            f"only {len(bound)}/{n_pods} bound under disk chaos; "
            f"faults={fabric.stats()} counters={counters.snapshot()}")
        _wait_assume_drain(sched, timeout_s=8 * sched.assume_ttl_s)
        _audit_capacity(client, bound, 500, 8000)
    finally:
        svc.shutdown_scheduler()
        scrub = store.scrub()
        store.faults = None
        store.close()
    stats = fabric.stats()["fires"]
    assert stats.get("disk.enospc", 0) >= 1, stats
    assert stats.get("wal.bitflip", 0) == 1, stats
    assert counters.get("storage.degraded_enter") >= 1
    assert counters.get("storage.degraded_recovered") >= 1
    # the lenient audit still reads the whole (now rotten) history
    assert wal_double_binds(wal) == []
    # the live scrub saw the flipped frame, fsck convicts it offline, and
    # a strict replay refuses to apply it
    assert any("corrupt" in f.lower() for f in scrub["findings"]), scrub
    report = fsck(wal)
    assert not report["ok"]
    assert any("crc mismatch" in e for e in report["errors"]), report
    with pytest.raises(WalCorrupt):
        DurableObjectStore(wal)
