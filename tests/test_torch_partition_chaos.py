"""Partition chaos on the port's replicated plane, on the CPU: cut links,
keep the data.

The port's copy of JAX's
``tests/test_partition_chaos.py::test_arbiter_partition_fences_leader_smoke``
(``:133``; the soak ``:196`` stays JAX's and ``slow``; the in-process
``NetFabric`` contract, ``:85``, is in ``test_torch_faults.py``): the
leader is cut from the arbiter majority over each replica child's
``/net/partition`` surface (its data links stay up) and must fence
itself within about two lease TTLs, before a follower wins the election,
with no acknowledged write lost; healed, the deposed replica rejoins
fenced and catches up.  The plane is stopped in a ``finally``.
"""

from __future__ import annotations

import time

from minisched_tpu_torch.api.objects import make_pod
from minisched_tpu_torch.controlplane.remote import RemoteClient
from minisched_tpu_torch.controlplane.replproc import ReplicatedPlane

TTL_S = 1.0


def _names(client) -> set:
    return {p.metadata.name for p in client.pods().list()}


def _partition_arbiter(leader, others) -> None:
    """A symmetric arbiter-channel partition between the leader and every
    other replica: each side cuts its own outbound edge."""
    for o in others:
        leader.net_control({"op": "cut", "src": leader.replica_id,
                            "dst": o.replica_id, "channel": "arbiter"})
        o.net_control({"op": "cut", "src": o.replica_id,
                       "dst": leader.replica_id, "channel": "arbiter"})


def _heal_all(plane) -> None:
    for r in plane.replicas:
        if r.alive():
            r.net_control({"op": "heal_all"})


def _wait_fenced(sup, timeout_s: float) -> float:
    """Block until ``sup`` is no longer an unfenced leader; the instant
    (time.monotonic) it was seen so."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        s = sup.status()
        if s is not None and (s.get("role") != "leader" or s.get("fenced")):
            return time.monotonic()
        time.sleep(0.05)
    raise AssertionError(f"{sup.replica_id} still an unfenced leader after "
                         f"{timeout_s}s (status: {sup.status()})")


def test_arbiter_partition_fences_leader_smoke(tmp_path):
    """One partition cycle: the leader loses the arbiter majority, fences
    itself within about two TTLs, a follower wins strictly after the
    fence, no acked write is lost; the healed ex-leader rejoins fenced
    and catches up to the live plane."""
    plane = ReplicatedPlane(str(tmp_path), n=3, fsync=True, ttl_s=TTL_S)
    try:
        url = plane.start()
        client = RemoteClient(url, timeout_s=10.0)
        acked = []
        for i in range(10):
            client.pods().create(make_pod(f"pre-{i:03d}"))
            acked.append(f"pre-{i:03d}")
        old = plane.leader()
        assert old is not None
        others = [r for r in plane.replicas if r is not old]
        t_cut = time.monotonic()
        _partition_arbiter(old, others)
        # the isolated leader must fence before anyone can be elected
        t_fenced = _wait_fenced(old, 2 * TTL_S + 1.0)
        assert t_fenced - t_cut <= 2 * TTL_S + 1.0
        won = plane.wait_for_leader(timeout_s=10 * TTL_S,
                                    exclude=old.replica_id)
        t_elected = time.monotonic()
        assert t_fenced <= t_elected, "election observed before the fence"
        s = old.status()
        assert s is not None and s.get("role") != "leader"
        survivor = RemoteClient(won["url"], timeout_s=10.0)
        assert set(acked) <= _names(survivor), "acked writes lost"
        survivor.pods().create(make_pod("post-partition"))
        assert "post-partition" in _names(survivor)
        # heal: the deposed replica rejoins fenced and catches up
        _heal_all(plane)
        deadline = time.monotonic() + 20.0
        rejoined = None
        while time.monotonic() < deadline:
            s = old.status()
            if s is not None and s.get("role") == "follower" \
                    and s.get("fenced"):
                rejoined = s
                break
            time.sleep(0.1)
        assert rejoined is not None, "ex-leader never rejoined fenced"
        want_rv = int(survivor.store.list_with_rv("Pod")[1])
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            s = old.status()
            if s is not None and int(s.get("rv", 0)) >= want_rv:
                break
            time.sleep(0.1)
        s = old.status()
        assert s is not None and int(s.get("rv", 0)) >= want_rv, (
            f"healed ex-leader stuck at {s and s.get('rv')} < {want_rv}")
    finally:
        plane.stop()
