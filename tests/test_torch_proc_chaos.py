"""Process-level chaos of the port: SIGKILL the control plane mid-work,
on the CPU.

The port's copies of JAX's ``tests/test_proc_chaos.py`` ``:66`` and
``:117`` (its soak ``:221`` stays JAX's and ``slow``), under JAX's names:
a ``faults.proc.ServerSupervisor`` runs the port's REST façade as a
child over a ``file://`` WAL with periodic compaction, SIGKILLs it
mid-scheduling and restarts it on its port.  The port's device engine
(``device="cpu"``) over ``RemoteClient`` must converge anyway, and the
recovered WAL show every pod bound exactly once; concurrent bind batches
killed in their ack window are deduped on replay.  Every child is
stopped in a ``finally``; every wait has a deadline.
"""

from __future__ import annotations

import threading
import time

import pytest

from minisched_tpu_torch.api.objects import Binding, make_node, make_pod
from minisched_tpu_torch.controlplane.durable import DurableObjectStore
from minisched_tpu_torch.controlplane.remote import RemoteClient
from minisched_tpu_torch.faults import wal_double_binds
from minisched_tpu_torch.faults.proc import ServerSupervisor
from minisched_tpu_torch.observability import counters
from minisched_tpu_torch.service.config import default_full_roster_config
from minisched_tpu_torch.service.service import SchedulerService
from tests.test_torch_chaos_soak import (
    SEED,
    _audit_capacity,
    _drive_to_convergence,
    _wait_assume_drain,
)


def _boot_cluster(client, n_nodes: int, n_pods: int) -> None:
    client.nodes().create_many([
        make_node(f"node{i:03d}",
                  capacity={"cpu": "8", "memory": "16Gi", "pods": 110})
        for i in range(n_nodes)])
    client.pods().create_many([
        make_pod(f"kp{i:04d}", requests={"cpu": "500m", "memory": "64Mi"})
        for i in range(n_pods)])


def _bound_count(client) -> int:
    try:
        return sum(1 for p in client.pods().list() if p.spec.node_name)
    except Exception:
        return -1  # plane down: the caller polls again


def test_proc_kill_smoke(tmp_path):
    """One SIGKILL and restart of the control-plane process while the
    device engine schedules over the wire: convergence, recovery and the
    full-history audits."""
    wal = str(tmp_path / "proc.wal")
    sup = ServerSupervisor(wal, compact_every_s=0.25, archive_history=True)
    svc = None
    try:
        base = sup.start()
        n_nodes, n_pods = 8, 48
        client = RemoteClient(base, retries=10, backoff_initial_s=0.05,
                              retry_seed=SEED)
        _boot_cluster(client, n_nodes, n_pods)
        counters.reset()
        svc = SchedulerService(client)
        sched = svc.start_scheduler(default_full_roster_config(),
                                    device_mode=True, max_wave=8,
                                    device="cpu")
        sched.assume_ttl_s = 2.0
        # kill once the first waves landed (and usually before the last)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if _bound_count(client) >= 8:
                break
            time.sleep(0.05)
        sup.kill_and_restart()
        assert sup.kills == 1
        bound = _drive_to_convergence(client, sched, n_pods, 120.0)
        assert len(bound) == n_pods, (
            f"only {len(bound)}/{n_pods} bound across the restart; "
            f"queue={sched.queue.stats()} counters={counters.snapshot()}")
        _wait_assume_drain(sched, timeout_s=8 * sched.assume_ttl_s)
        _audit_capacity(client, bound, 500, 8000)
        # every informer stream died with the old process and came back
        assert counters.get("informer.reconnect") >= 1, counters.snapshot()
    finally:
        if svc is not None:
            svc.shutdown_scheduler()
        sup.stop()
    assert wal_double_binds(wal) == []
    re = DurableObjectStore(wal)
    try:
        assert sum(1 for p in re.list("Pod") if p.spec.node_name) == n_pods
    finally:
        re.close()


def test_proc_kill_ack_window_bind_batches(tmp_path):
    """SIGKILL the control-plane child (fsync on, group commit on) while
    concurrent bind batches are in flight, the window between a group's
    fsync and its HTTP acks included.  The clients retry across the
    restart; a batch whose first attempt committed is deduped on replay,
    so every pod ends bound once, on the node its writer asked for."""
    wal = str(tmp_path / "ackwin.wal")
    sup = ServerSupervisor(wal, compact_every_s=0.25, archive_history=True,
                           fsync=True)
    n_nodes = 8
    n_writers, batches_per, batch_sz = 8, 6, 3
    n_pods = n_writers * batches_per * batch_sz
    errs: list = []
    want: dict = {}  # pod name → the node its writer bound it to
    try:
        base = sup.start()
        seed_client = RemoteClient(base, retries=10, backoff_initial_s=0.05,
                                   retry_seed=SEED)
        seed_client.nodes().create_many([
            make_node(f"node{i:03d}",
                      capacity={"cpu": "64", "memory": "64Gi", "pods": 110})
            for i in range(n_nodes)])
        seed_client.pods().create_many([
            make_pod(f"ak{w}-{b}-{j}",
                     requests={"cpu": "100m", "memory": "64Mi"})
            for w in range(n_writers) for b in range(batches_per)
            for j in range(batch_sz)])
        counters.reset()

        def writer(w: int) -> None:
            client = RemoteClient(base, retries=12, backoff_initial_s=0.05,
                                  retry_seed=SEED + w)
            try:
                for b in range(batches_per):
                    node = f"node{(w * batches_per + b) % n_nodes:03d}"
                    binds = [Binding(f"ak{w}-{b}-{j}", "default", node)
                             for j in range(batch_sz)]
                    for bind, res in zip(binds,
                                         client.pods().bind_many(binds)):
                        if isinstance(res, BaseException):
                            errs.append(f"{bind.pod_name}: {res!r}")
                        else:
                            want[bind.pod_name] = node
            except Exception as e:
                errs.append(f"writer {w}: {e!r}")

        threads = [threading.Thread(target=writer, args=(w,),
                                    name=f"ackwin-{w}")
                   for w in range(n_writers)]
        for t in threads:
            t.start()
        # kill once the batches are in flight, restart on the same port
        time.sleep(0.3)
        sup.kill_and_restart()
        assert sup.kills == 1
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs[:5]
        assert len(want) == n_pods
        live = {p.metadata.name: p.spec.node_name
                for p in seed_client.pods().list()}
        assert live == want
    finally:
        sup.stop()
    # exactly once across the whole archived history
    assert wal_double_binds(wal) == []
    re = DurableObjectStore(wal, archive_compacted=True)
    try:
        assert {p.metadata.name: p.spec.node_name
                for p in re.list("Pod")} == want
    finally:
        re.close()


def _held_port(port: int):
    """A listening socket on ``port``: what a child that binds it meets
    when another socket took it between the pick and the bind."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", port))
    s.listen(1)
    return s


def test_supervisors_pick_a_taken_port_anew_before_the_first_start(
        tmp_path):
    """A port a supervisor picked itself and another socket took first:
    the child dies at boot saying so and the supervisor starts it again
    on a port picked anew (the façade's before its first start only, its
    restarts keep the port clients know; the engine child's metrics
    port); a port the caller gave is not replaced."""
    from minisched_tpu_torch.faults.proc import PortTaken
    from minisched_tpu_torch.ha.proc import EngineSupervisor

    sup = ServerSupervisor(str(tmp_path / "p.wal"))
    taken = _held_port(sup._port)
    eng = None
    try:
        base = sup.start()
        assert not base.endswith(f":{taken.getsockname()[1]}")
        eng = EngineSupervisor(base, "engine-0", device="cpu",
                               metrics_port=0)
        held = _held_port(eng._metrics_port)
        try:
            eng.start()
            assert eng.metrics_url != (
                f"http://127.0.0.1:{held.getsockname()[1]}/metrics")
            assert eng.kernel_counts()["launches"] == {
                "select_hosts": 0, "nodenumber_select_hosts": 0,
                "block_commit": 0}
        finally:
            held.close()
        fixed = ServerSupervisor(str(tmp_path / "q.wal"),
                                 port=taken.getsockname()[1])
        try:
            with pytest.raises(PortTaken):
                fixed.start()
        finally:
            fixed.stop()
    finally:
        taken.close()
        if eng is not None:
            eng.stop()
        sup.stop()
