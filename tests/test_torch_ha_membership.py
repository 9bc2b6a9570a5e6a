"""The port's HA membership (``ha/membership.py``) on the CPU.

The port's copies of JAX's five ``tests/test_ha_membership.py`` tests,
under JAX's names: the rendezvous shard map deterministic, total,
identical across processes and minimal-churn; two members' epochs and
TTL-expiry failover; a graceful release rebalancing at once.  Then the
port against JAX: for three seeds, random member sets of 1-5 and 1,000
uids made with numpy, each package's ``Membership.owns`` answers alike;
and a mixed plane, a JAX ``Membership`` and a port one joined to one
façade of either package, agrees on the live members and moves its
epochs together, each package reading the other's member Lease (the
state that crosses between the packages in this slice).  Then the port's
own schedule beside JAX's: a slow change callback does not stall the
renewals, and a changed view is published at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from minisched_tpu_torch.api.objects import make_pod
from minisched_tpu_torch.controlplane.client import Client
from minisched_tpu_torch.controlplane.store import ObjectStore
from minisched_tpu_torch.ha.membership import Membership, shard_owner
from minisched_tpu_torch.observability import counters

MEMBERS = ("engine-a", "engine-b", "engine-c")
UIDS = [f"pod-{i:08d}" for i in range(2000)]


def _wait(pred, timeout_s: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_shard_map_deterministic_and_total():
    first = [shard_owner(u, MEMBERS) for u in UIDS]
    second = [shard_owner(u, MEMBERS) for u in UIDS]
    assert first == second
    assert set(first) == set(MEMBERS)  # every member gets work
    # reasonably balanced: no member owns more than twice its share
    for m in MEMBERS:
        assert first.count(m) < 2 * len(UIDS) / len(MEMBERS)


def test_shard_map_identical_across_processes():
    """The same members and uids give the same owners in a separate
    interpreter: N engines partition the pods with no coordination."""
    script = (
        "import json, sys; "
        "from minisched_tpu_torch.ha.membership import shard_owner; "
        "members, uids = json.loads(sys.argv[1]); "
        "print(json.dumps([shard_owner(u, members) for u in uids]))"
    )
    out = subprocess.run(
        [sys.executable, "-c", script, json.dumps([MEMBERS, UIDS[:500]])],
        capture_output=True, text=True, check=True, timeout=120)
    theirs = json.loads(out.stdout)
    ours = [shard_owner(u, MEMBERS) for u in UIDS[:500]]
    assert theirs == ours


def test_single_member_loss_moves_only_the_orphaned_shard():
    before = {u: shard_owner(u, MEMBERS) for u in UIDS}
    survivors = ("engine-a", "engine-c")
    after = {u: shard_owner(u, survivors) for u in UIDS}
    for u in UIDS:
        if before[u] != "engine-b":
            # survivors' pods never move (the rendezvous property)
            assert after[u] == before[u], u
        else:
            assert after[u] in survivors
    # a member joining takes back only what it now wins
    rejoined = {u: shard_owner(u, MEMBERS) for u in UIDS}
    assert rejoined == before


def test_membership_epochs_and_expiry_failover():
    """Two members over one store see each other; one crashes (heartbeat
    stopped, lease abandoned): the survivor times the lease out, bumps
    its epoch and reports the loss; the counters flow."""
    store = ObjectStore()
    counters.reset()
    m1 = Membership(Client(store), "m1", ttl_s=0.6)
    m2 = Membership(Client(store), "m2", ttl_s=0.6)
    changes = []
    m1.on_change.append(lambda epoch, members, joined, lost: changes.append(
        (epoch, members, set(joined), set(lost))))
    m1.join()
    m2.join()
    m1.start()
    m2.start()
    try:
        assert _wait(lambda: m1.members() == ("m1", "m2")
                     and m2.members() == ("m1", "m2"), 5.0)
        epoch_before = m1.epoch
        # ownership is complementary and total while both live
        pods = [make_pod(f"p{i}") for i in range(50)]
        for p in pods:
            p.metadata.uid = f"uid-{p.metadata.name}"
        owned1 = {p.metadata.name for p in pods if m1.owns_pod(p)}
        owned2 = {p.metadata.name for p in pods if m2.owns_pod(p)}
        assert owned1 | owned2 == {p.metadata.name for p in pods}
        assert not (owned1 & owned2)
        m2.stop(release=False)  # crash: expiry must do the work
        t0 = time.monotonic()
        assert _wait(lambda: m1.members() == ("m1",), 5.0)
        detect_s = time.monotonic() - t0
        # detection bounded by the TTL and one heartbeat tick (+ margin)
        assert detect_s <= m2.ttl_s + m1.ttl_s / 3.0 + 1.0, detect_s
        assert m1.epoch > epoch_before
        assert any("m2" in lost for _e, _m, _j, lost in changes)
        # the crashed member's whole shard now belongs to the survivor
        assert all(m1.owns_pod(p) for p in pods)
        snap = counters.snapshot()
        assert snap.get("ha.epoch_bump", 0) >= 2
        assert snap.get("ha.member_lost", 0) >= 1
        assert snap.get("ha.lease_expired", 0) >= 1
        assert snap.get("ha.lease_renew", 0) >= 1
    finally:
        m1.stop()
        m2.stop(release=False)


def test_graceful_release_rebalances_without_waiting_out_ttl():
    store = ObjectStore()
    m1 = Membership(Client(store), "m1", ttl_s=5.0)
    m2 = Membership(Client(store), "m2", ttl_s=5.0)
    m1.join()
    m2.join()
    m1.start()
    m2.start()
    try:
        assert _wait(lambda: m1.members() == ("m1", "m2"), 5.0)
        t0 = time.monotonic()
        m2.stop(release=True)  # graceful: the lease is deleted
        # far below the 5 s TTL
        assert _wait(lambda: m1.members() == ("m1",), 4.0)
        assert time.monotonic() - t0 < 4.0
    finally:
        m1.stop()
        m2.stop()


# -- the port against JAX ---------------------------------------------------


def _owns_cases(seed: int):
    """(member set, member id, uids) triples from one numpy seed: sets of
    1-5 members; the id is one of them, or (one case in four) a member
    not yet in the view, which ``owns`` counts in."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(12):
        n = int(rng.integers(1, 6))
        members = sorted({f"engine-{int(x)}"
                          for x in rng.integers(0, 40, size=n)})
        if rng.random() < 0.25:
            me = f"engine-{int(rng.integers(40, 80))}"
        else:
            me = members[int(rng.integers(0, len(members)))]
        uids = [f"pod-{int(x):08d}"
                for x in rng.integers(0, 10**8, size=1000)]
        cases.append((tuple(members), me, uids))
    return cases


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_owns_equals_jax_for_sampled_uids_and_member_sets(seed):
    from minisched_tpu.controlplane.client import Client as JClient
    from minisched_tpu.controlplane.store import ObjectStore as JStore
    from minisched_tpu.ha.membership import Membership as JMembership

    for members, me, uids in _owns_cases(seed):
        jm = JMembership(JClient(JStore()), me)
        tm = Membership(Client(ObjectStore()), me)
        # the view a recompute would derive from these live leases
        jm._members = tm._members = members
        got = [tm.owns(u) for u in uids]
        assert got == [jm.owns(u) for u in uids], (members, me)
        assert any(got) or me not in members and not any(got)


def _facade(side):
    if side == "jax":
        from minisched_tpu.controlplane.httpserver import start_api_server
        from minisched_tpu.controlplane.store import ObjectStore as Store
    else:
        from minisched_tpu_torch.controlplane.httpserver import (
            start_api_server,
        )
        Store = ObjectStore
    return start_api_server(Store())


@pytest.mark.parametrize("facade_side", ["jax", "port"])
def test_mixed_plane_agrees_on_members_and_epochs(facade_side):
    """A JAX member ``j`` and a port member ``t`` over one façade of
    ``facade_side``: both derive the same live set; a third member (the
    port's) joining and then releasing moves both views and both epochs
    by one each; each package reads the other's member Lease (holder,
    TTL and the published epoch) as written."""
    from minisched_tpu.controlplane.remote import RemoteClient as JRemote
    from minisched_tpu.ha.lease import HA_NAMESPACE as J_NS
    from minisched_tpu.ha.membership import Membership as JMembership
    from minisched_tpu_torch.controlplane.remote import (
        RemoteClient as TRemote,
    )
    from minisched_tpu_torch.ha.lease import HA_NAMESPACE

    assert J_NS == HA_NAMESPACE
    _server, base, shutdown = _facade(facade_side)
    jc, tc, xc = JRemote(base), TRemote(base), TRemote(base)
    jm = JMembership(jc, "j", ttl_s=2.0)
    tm = Membership(tc, "t", ttl_s=2.0)
    xm = Membership(xc, "x", ttl_s=2.0)
    try:
        jm.join()
        tm.join()
        jm.start()
        tm.start()
        assert _wait(lambda: jm.members() == tm.members() == ("j", "t"))
        e_j, e_t = jm.epoch, tm.epoch
        xm.join()
        xm.start()
        assert _wait(lambda: jm.members() == tm.members()
                     == ("j", "t", "x"))
        assert (jm.epoch - e_j, tm.epoch - e_t) == (1, 1)
        xm.stop(release=True)
        assert _wait(lambda: jm.members() == tm.members() == ("j", "t"))
        assert (jm.epoch - e_j, tm.epoch - e_t) == (2, 2)
        # each package reads the other's lease as its holder renewed it
        assert _wait(lambda: tc.store.get(
            "Lease", HA_NAMESPACE, "member-j").spec.epoch == jm.epoch
            and jc.store.get("Lease", HA_NAMESPACE,
                             "member-t").spec.epoch == tm.epoch)
        theirs = tc.store.get("Lease", HA_NAMESPACE, "member-j")
        ours = jc.store.get("Lease", HA_NAMESPACE, "member-t")
        assert (theirs.spec.holder, theirs.spec.ttl_s) == ("j", 2.0)
        assert (ours.spec.holder, ours.spec.ttl_s) == ("t", 2.0)
        # the same uids owned alike on both sides of the mixed plane
        uids = [f"pod-{i:08d}" for i in range(500)]
        assert [jm.owns(u) for u in uids] == [not tm.owns(u) for u in uids]
    finally:
        for m in (xm, tm):
            m.stop(release=False)
        jm.stop(release=False)
        shutdown()


class _Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.mark.parametrize("side", ["jax", "port"])
def test_a_slow_change_callback_does_not_stall_the_renewals(side):
    """``m1``'s change callback takes 1.5 s (a resync over a large cache)
    against a TTL of 0.9 s.  JAX's runs it on the heartbeat thread, so
    ``m1``'s lease lapses and ``m2`` drops it; the port's runs it on the
    view thread, its renewals go on, and ``m2`` keeps ``m1``."""
    if side == "jax":
        from minisched_tpu.controlplane.client import Client as C
        from minisched_tpu.controlplane.store import ObjectStore as S
        from minisched_tpu.ha.membership import Membership as M
    else:
        C, S, M = Client, ObjectStore, Membership
    store = S()
    m1, m2, m3 = (M(C(store), n, ttl_s=0.9, heartbeat_interval_s=0.1)
                  for n in ("m1", "m2", "m3"))
    slow = threading.Event()
    m1.on_change.append(lambda *_: slow.is_set() and time.sleep(1.5))
    lost = []
    m2.on_change.append(lambda _e, _m, _j, gone: lost.extend(gone))
    for m in (m1, m2):
        m.join()
        m.start()
    try:
        assert _wait(lambda: m1.members() == m2.members() == ("m1", "m2"),
                     5.0)
        slow.set()
        m3.join()  # a view change: m1's slow callback runs
        m3.start()
        time.sleep(2.0)
    finally:
        for m in (m1, m2, m3):
            m.stop(release=False)
    assert ("m1" in lost) == (side == "jax"), lost


@pytest.mark.parametrize("side", ["jax", "port"])
def test_a_view_changed_by_a_tick_is_published_in_that_tick(side):
    """A tick that finds a peer's lease expired bumps the epoch; the
    port's renews again in the same tick, so its lease carries the new
    epoch at once; JAX's publishes it one tick later."""
    if side == "jax":
        from minisched_tpu.controlplane.client import Client as C
        from minisched_tpu.controlplane.store import ObjectStore as S
        from minisched_tpu.ha.lease import HA_NAMESPACE as NS
        from minisched_tpu.ha.membership import Membership as M
    else:
        from minisched_tpu_torch.ha.lease import HA_NAMESPACE as NS
        C, S, M = Client, ObjectStore, Membership
    clock = _Clock()
    store = S()
    m1 = M(C(store), "m1", ttl_s=1.0, clock=clock)
    m2 = M(C(store), "m2", ttl_s=1.0, clock=clock)
    m1.join()
    m2.join()
    m1.recompute()
    assert m1.members() == ("m1", "m2")
    before = m1.epoch
    clock.t += 1.5  # m2 stopped renewing: its lease lapses
    m1.heartbeat_once()
    assert m1.members() == ("m1",) and m1.epoch == before + 1
    published = store.get("Lease", NS, "member-m1").spec.epoch
    assert published == (before if side == "jax" else before + 1)
    m1.heartbeat_once()  # JAX's catches up a tick later
    assert store.get("Lease", NS, "member-m1").spec.epoch == before + 1


@pytest.mark.parametrize("side", ["jax", "port"])
def test_a_view_changed_by_a_lease_event_is_published_at_once(side):
    """``m1`` ticks every 3 s; its Lease informer recomputes on each of
    ``m3``'s renewals (every 0.1 s) and so finds ``m2`` expired within
    about its 0.6 s TTL of ``m2``'s crash.  The port's heartbeat is woken
    and publishes the new epoch at once; JAX's waits for the next tick."""
    if side == "jax":
        from minisched_tpu.controlplane.client import Client as C
        from minisched_tpu.controlplane.informer import (
            SharedInformerFactory as F,
        )
        from minisched_tpu.controlplane.store import ObjectStore as S
        from minisched_tpu.ha.lease import HA_NAMESPACE as NS
        from minisched_tpu.ha.membership import Membership as M
    else:
        from minisched_tpu_torch.controlplane.informer import (
            SharedInformerFactory as F,
        )
        from minisched_tpu_torch.ha.lease import HA_NAMESPACE as NS
        C, S, M = Client, ObjectStore, Membership
    store = S()
    m1 = M(C(store), "m1", ttl_s=10.0, heartbeat_interval_s=3.0)
    m2 = M(C(store), "m2", ttl_s=0.6, heartbeat_interval_s=0.1)
    m3 = M(C(store), "m3", ttl_s=10.0, heartbeat_interval_s=0.1)
    factory = F(store)
    for m in (m1, m2, m3):
        m.join()
    m1.attach(factory)
    factory.start()
    assert factory.wait_for_cache_sync(5.0)
    try:
        for m in (m2, m3):
            m.start()
        assert _wait(lambda: m1.members() == ("m1", "m2", "m3"), 2.0)
        m1.start()  # its first tick is 3 s away
        m2.stop(release=False)  # crash
        assert _wait(lambda: m1.members() == ("m1", "m3"), 2.0)
        time.sleep(0.5)
        published = store.get("Lease", NS, "member-m1").spec.epoch
    finally:
        for m in (m1, m3):
            m.stop(release=False)
        factory.shutdown()
    if side == "jax":
        assert published < m1.epoch
    else:
        assert published == m1.epoch
