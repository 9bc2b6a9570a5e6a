"""The port's Lease kind and CAS protocol (``ha/lease.py``) on the CPU.

The port's copies of JAX's ``tests/test_ha_lease.py``: acquisition,
renewal, takeover arbitration and release over the in-process store,
under JAX's names; the wire test runs each package's ``LeaseManager``
against each package's REST façade and holds the transcript (holders,
transitions, resource_versions, the LeaseLost, and the Lease both
packages replay from the WAL) to JAX's against JAX's, exactly.
"""

from __future__ import annotations

import pytest

from minisched_tpu_torch.controlplane.client import Client
from minisched_tpu_torch.controlplane.store import ObjectStore
from minisched_tpu_torch.ha.lease import HA_NAMESPACE, LeaseLost, LeaseManager
from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.controlplane import durable as tdurable
from minisched_tpu_torch.controlplane import httpserver as thttp
from minisched_tpu_torch.controlplane import remote as tremote
from minisched_tpu_torch.ha import lease as tlease

from minisched_tpu.api import objects as jobj
from minisched_tpu.controlplane import durable as jdurable
from minisched_tpu.controlplane import httpserver as jhttp
from minisched_tpu.controlplane import remote as jremote
from minisched_tpu.ha import lease as jlease


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _mgr(clock, client=None):
    return LeaseManager(client or Client(ObjectStore()), clock=clock)


def test_acquire_fresh_then_peer_blocked_until_expiry():
    clock = FakeClock()
    client = Client(ObjectStore())
    a = LeaseManager(client, clock=clock)
    b = LeaseManager(client, clock=clock)
    got = a.acquire("lock", "alice", ttl_s=5.0)
    assert got is not None and got.spec.holder == "alice"
    # a live lease is not stealable
    assert b.acquire("lock", "bob", ttl_s=5.0) is None
    # ... until it expires; the takeover bumps transitions
    clock.advance(5.1)
    taken = b.acquire("lock", "bob", ttl_s=5.0)
    assert taken is not None and taken.spec.holder == "bob"
    assert taken.spec.transitions == 1


def test_takeover_race_is_409_arbitrated():
    """Two survivors race for an expired lease: the second CAS hits the
    rv the first one bumped and loses — never a silent double-acquire."""
    clock = FakeClock()
    client = Client(ObjectStore())
    a = LeaseManager(client, clock=clock)
    b = LeaseManager(client, clock=clock)
    assert a.acquire("lock", "dead", ttl_s=1.0) is not None
    clock.advance(2.0)
    # simulate the race: both read the expired lease at the same rv, then
    # write in turn — exactly what two concurrent takeovers do
    stale = b.get("lock")
    won = a.acquire("lock", "alice", ttl_s=5.0)
    assert won is not None
    # b's CAS carries the pre-takeover rv: must lose
    from minisched_tpu_torch.controlplane.store import Conflict

    stale.spec.holder = "bob"
    with pytest.raises(Conflict):
        client.store.update(
            "Lease", stale, expected_rv=stale.metadata.resource_version
        )
    # and the polite-path API reports the loss as None, not an exception
    assert b.acquire("lock", "bob", ttl_s=5.0) is None
    assert a.get("lock").spec.holder == "alice"


def test_renew_extends_and_publishes_epoch():
    clock = FakeClock()
    mgr = _mgr(clock)
    lease = mgr.acquire("lock", "alice", ttl_s=2.0)
    clock.advance(1.5)
    lease = mgr.renew(lease, epoch=7)
    assert lease.spec.renew_time == clock()
    assert lease.spec.epoch == 7
    clock.advance(1.9)  # 3.4 since acquire, 1.9 since renew: still live
    assert not mgr.get("lock").expired(clock())


def test_renew_after_takeover_raises_lease_lost():
    clock = FakeClock()
    client = Client(ObjectStore())
    a = LeaseManager(client, clock=clock)
    b = LeaseManager(client, clock=clock)
    mine = a.acquire("lock", "alice", ttl_s=1.0)
    clock.advance(2.0)
    assert b.acquire("lock", "bob", ttl_s=5.0) is not None
    with pytest.raises(LeaseLost):
        a.renew(mine)
    # the loser can re-acquire only once bob expires
    assert a.acquire("lock", "alice", ttl_s=1.0) is None


def test_renew_conflict_with_own_lost_write_self_heals():
    """A renewal whose response was lost (remote client replays the PUT)
    conflicts with OUR OWN newer rv — renew must re-read, see the holder
    is still us, and retry instead of declaring the lease lost."""
    clock = FakeClock()
    client = Client(ObjectStore())
    mgr = LeaseManager(client, clock=clock)
    lease = mgr.acquire("lock", "alice", ttl_s=5.0)
    # our own write landed but the caller's handle is stale
    stale = lease.clone()
    stale.metadata.resource_version = lease.metadata.resource_version
    mgr.renew(lease)  # rv moves on
    out = mgr.renew(stale, epoch=3)  # stale handle: conflicts, self-heals
    assert out.spec.holder == "alice" and out.spec.epoch == 3


def test_release_only_by_holder_and_gc_reaps_long_dead(tmp_path):
    clock = FakeClock()
    client = Client(ObjectStore())
    a = LeaseManager(client, clock=clock)
    b = LeaseManager(client, clock=clock)
    a.acquire("lock", "alice", ttl_s=1.0)
    assert not b.release("lock", "bob")  # not yours
    assert a.get("lock") is not None
    # long-dead leases get garbage-collected by any survivor
    clock.advance(100.0)
    assert b.gc_expired(grace_factor=10.0) == 1
    assert a.get("lock") is None
    # graceful release deletes immediately
    a.acquire("lock2", "alice", ttl_s=1.0)
    assert a.release("lock2", "alice")
    assert a.get("lock2") is None


#: per package: objects, durable, façade, remote, lease
SIDES = {
    "jax": (jobj, jdurable, jhttp, jremote, jlease),
    "port": (tobj, tdurable, thttp, tremote, tlease),
}
PAIRS = [("port", "jax"), ("jax", "port"), ("port", "port"), ("jax", "jax")]


def _wire_transcript(tmp_path, manager_side, facade_side):
    """``manager_side``'s LeaseManager over ``facade_side``'s façade:
    create → 409-arbitrated takeover → renewal, then the WAL reopened by
    both packages.  Returns every answer as data."""
    _o, _d, _h, rmod, lmod = SIDES[manager_side]
    durable, http = SIDES[facade_side][1], SIDES[facade_side][2]
    tmp_path.mkdir(parents=True, exist_ok=True)
    wal = str(tmp_path / f"{manager_side}-{facade_side}.wal")
    store = durable.DurableObjectStore(wal)
    _server, base, shutdown = http.start_api_server(store)
    out = []
    try:
        clock = FakeClock()
        a = lmod.LeaseManager(rmod.RemoteClient(base), clock=clock)
        b = lmod.LeaseManager(rmod.RemoteClient(base), clock=clock)
        got = a.acquire("wire-lock", "alice", ttl_s=5.0)
        out.append(("acquire", got.spec.holder,
                    got.metadata.resource_version))
        out.append(("blocked", b.acquire("wire-lock", "bob", ttl_s=5.0)))
        got = a.renew(got, epoch=2)
        out.append(("renew", got.spec.epoch, got.metadata.resource_version))
        clock.advance(6.0)
        taken = b.acquire("wire-lock", "bob", ttl_s=5.0)
        out.append(("takeover", taken.spec.holder, taken.spec.transitions,
                    taken.metadata.resource_version))
        try:
            a.renew(got)
            out.append(("lost", None))
        except lmod.LeaseLost:
            out.append(("lost", "LeaseLost"))
        out.append(("release", a.release("wire-lock", "alice"),
                    b.release("wire-lock", "bob"), a.get("wire-lock")))
        a.acquire("wire-lock", "carol", ttl_s=5.0)
    finally:
        shutdown()
        store.close()
    # durability: both packages reopen the WAL and find carol's lease
    for side in ("jax", "port"):
        re = SIDES[side][1].DurableObjectStore(wal)
        try:
            leases = [(l.metadata.namespace, l.spec.holder,
                       l.spec.transitions) for l in re.list("Lease")]
        finally:
            re.close()
        out.append(("reopen", side, leases))
    return out


@pytest.mark.parametrize("manager_side, facade_side", PAIRS)
def test_lease_cas_over_the_wire(tmp_path, manager_side, facade_side):
    """Same protocol through the REST façade: create → 409-arbitrated
    takeover → renewal — and the Lease kind is WAL-durable, so a
    recovered control plane replays it (already expired by wall clock).
    Either package's ``LeaseManager`` against either package's façade
    answers as JAX's against JAX's."""
    want = _wire_transcript(tmp_path / "want", "jax", "jax")
    got = _wire_transcript(tmp_path / "got", manager_side, facade_side)
    assert got == want
    assert want[1] == ("blocked", None)
    assert want[3][1:3] == ("bob", 1)
    assert want[4] == ("lost", "LeaseLost")
    assert want[-1] == ("reopen", "port", [(HA_NAMESPACE, "carol", 0)])
