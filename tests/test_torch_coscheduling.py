"""Gangs in the live engine: Coscheduling and GangIndex against the JAX
package's, and all-or-nothing admission end to end on both engines.

``plugins/coscheduling.py`` and ``engine/gang.GangIndex`` are copies of
the JAX ones.  The unit tests drive both packages' classes through the
same scripted calls and compare what they answer and whom they Allow or
Reject.  The engine tests run ``gang_roster_config`` on a 16-node sliced
cluster (``time_scale=0.01``: a gang TTL of 0.3 s) on both engines:

* six gangs of eight that all fit: every member on the same node on both
  engines;
* one gang too many for the capacity: the surplus gang's placed members
  wait at Permit and are released by its TTL, again and again, and no
  gang settles partly bound; once a bound gang is deleted the surplus
  gang lands whole.  Which gang waits depends on TTL timing, so the bound
  sets are not compared.  At the end the Coscheduling ledger and the
  assume cache are empty.

Comparisons are exact; every wait has a deadline.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

import pytest

from minisched_tpu.api import objects as jobj
from minisched_tpu.controlplane.store import (
    EventType as JEventType,
    WatchEvent as JWatchEvent,
)
from minisched_tpu.engine.gang import GangIndex as JGangIndex
from minisched_tpu.observability import counters as jcounters
from minisched_tpu.plugins.coscheduling import Coscheduling as JCosched
from minisched_tpu.framework.types import CycleState as JCycleState

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.controlplane.store import (
    EventType as TEventType,
    WatchEvent as TWatchEvent,
)
from minisched_tpu_torch.engine.gang import GangIndex as TGangIndex
from minisched_tpu_torch.observability import counters as tcounters
from minisched_tpu_torch.plugins.coscheduling import (
    GANG_TTL_REASON,
    Coscheduling as TCosched,
)
from minisched_tpu_torch.framework.types import CycleState as TCycleState
from tests.test_torch_engine import live, wait_for

SIDES = {
    "jax": (jobj, JCosched, JCycleState, JGangIndex, JEventType,
            JWatchEvent, jcounters),
    "port": (tobj, TCosched, TCycleState, TGangIndex, TEventType,
             TWatchEvent, tcounters),
}


class FakeHandle:
    """The engine's waiting-pod registry, as far as Coscheduling reads
    it: every registered uid has a waiting pod that records its signal."""

    def __init__(self):
        self.signals = []
        self.waiting = set()
        self.mu = threading.Lock()

    def get_waiting_pod(self, uid):
        if uid not in self.waiting:
            return None
        handle = self

        class WP:
            def allow(self, plugin):
                with handle.mu:
                    handle.signals.append(("allow", uid))

            def reject(self, plugin, msg):
                with handle.mu:
                    handle.signals.append(("reject", uid,
                                           GANG_TTL_REASON in msg))

        return WP()


def _cosched_script(side):
    objs, Cosched, CycleState, *_ = SIDES[side]
    plugin = Cosched(time_scale=0.01)
    handle = FakeHandle()
    plugin.h = handle
    placed = {"default/b": 2}
    plugin.gang_lister = lambda key, exclude: placed.get(key, 0)
    out = []

    def permit(pod, node="n0"):
        handle.waiting.add(pod.metadata.uid)
        status, timeout = plugin.permit(CycleState(), pod, node)
        out.append((pod.metadata.name, status.code.name, timeout > 0))

    gang_a = objs.make_gang_pods("a", 3, ttl_s=30.0)
    gang_b = objs.make_gang_pods("b", 4, ttl_s=30.0)
    # gang c's TTL (1 s) must outlast the ledger read below
    gang_c = objs.make_gang_pods("c", 3, ttl_s=100.0)
    for i, p in enumerate(gang_a + gang_b + gang_c):
        p.metadata.uid = f"pod-{i:08d}"
    permit(objs.make_pod("single"))
    for p in gang_a:  # admitted on the third member
        permit(p)
    permit(gang_b[0])  # + 2 placed: 3 of 4
    permit(gang_b[1])  # + 2 placed: complete
    permit(gang_c[0])
    # a stale waiter (its WaitingPod resolved elsewhere) is pruned
    handle.waiting.discard(gang_c[0].metadata.uid)
    permit(gang_c[1])
    out.append(("pending", plugin.pending_gangs()))
    assert wait_for(lambda: not plugin.pending_gangs(), timeout=10.0)
    time.sleep(0.05)
    with handle.mu:
        out.append(("signals", sorted(handle.signals)))
    return out


def test_coscheduling_answers_as_jax():
    got, want = _cosched_script("port"), _cosched_script("jax")
    assert got == want
    signals = want[-1][1]
    # gang a: its first two members are allowed when the third arrives;
    # gang c's lone waiter is released by the TTL with the marker
    assert ("reject", "pod-00000008", True) in signals
    assert sum(1 for s in signals if s[0] == "allow") == 3


def _gang_index_run(side):
    objs, *_, GangIndex, EventType, WatchEvent, _ = SIDES[side]
    index = GangIndex()
    nodes = [objs.make_node(f"n{i}", slice_id=f"s{i // 2}", torus=(i, 0, 0),
                            host_index=i) for i in range(4)]
    for n in nodes:
        index._node_changed(n)
    members = objs.make_gang_pods("g", 4) + objs.make_gang_pods("h", 2)
    for i, p in enumerate(members):
        p.metadata.uid = f"pod-{i}"

    def bound(p, node):
        q = p.clone()
        q.spec.node_name = node
        return q

    index._pod_batch([
        WatchEvent(EventType.ADDED, members[0]),
        WatchEvent(EventType.MODIFIED, bound(members[0], "n0"), members[0]),
        WatchEvent(EventType.MODIFIED, bound(members[1], "n1"), members[1]),
        WatchEvent(EventType.MODIFIED, bound(members[4], "n3"), members[4]),
        WatchEvent(EventType.MODIFIED, bound(members[1], "n2"), members[1]),
        WatchEvent(EventType.DELETED, bound(members[4], "n3")),
    ])
    index._node_gone(nodes[3])
    return (index.placed_count("default/g"),
            index.placed_count("default/g", exclude=["pod-0"]),
            index.placed_count("default/h"),
            index.view_for(["default/g", "default/h"],
                           [("default/g", "pod-2", "n3"),
                            ("default/g", "pod-0", "n1"),
                            ("default/h", "pod-5", "n2")]))


def test_gang_index_matches_jax():
    got, want = _gang_index_run("port"), _gang_index_run("jax")
    assert got == want
    assert want[:3] == (2, 1, 0)


def gang_cluster(objs, n_gangs, slots=4, ttl_s=30.0):
    """16 nodes on two 8-host slices; every node holds ``slots`` members
    (1 CPU each), or (fewer, more) slots on the first 12 and the last 4
    nodes when ``slots`` is a pair.  Gangs of 8 with a TTL of ``ttl_s``
    (times the config's ``time_scale``)."""
    low, high = slots if isinstance(slots, tuple) else (slots, slots)
    nodes = []
    for i in range(16):
        s, h = divmod(i, 8)
        cpu = low if i < 12 else high
        nodes.append(objs.make_node(
            f"node{i:02d}", capacity={"cpu": str(cpu), "memory": "16Gi",
                                      "pods": 110},
            slice_id=f"slice{s}", torus=(h % 4, h // 4, 0), host_index=h,
            slice_dims=(4, 2, 1)))
    pods = []
    for g in range(n_gangs):
        pods += objs.make_gang_pods(f"gang{g}", 8, ttl_s=ttl_s,
                                    requests={"cpu": "1", "memory": "1Gi"})
    for i, p in enumerate(pods):
        p.metadata.uid = f"pod-{i:08d}"
    return nodes, pods


def gang_state(client):
    bound = defaultdict(int)
    total = defaultdict(int)
    for p in client.pods().list():
        key = p.spec.gang.name
        total[key] += 1
        bound[key] += bool(p.spec.node_name)
    return {k: (bound[k], total[k]) for k in total}


def cosched_of(sched):
    return next(p for p in sched.permit_plugins if p.name() == "Coscheduling")


def _assumed(sched):
    with sched._assumed_lock:
        return len(sched._assumed)


def _fit_run(side, monkeypatch):
    # a 10 s TTL: a gang admits within one commit pass, and no TTL may
    # release a member on a loaded machine (the nodes are compared)
    nodes, pods = gang_cluster(SIDES[side][0], 6, ttl_s=1000.0)
    with live(side, "gang_roster_config", monkeypatch, nodes, pods,
              assume_ttl_s=0.5, time_scale=0.01) as (client, sched, _):
        assert wait_for(lambda: sum(
            1 for p in client.pods().list() if p.spec.node_name) == 48)
        assert wait_for(lambda: _assumed(sched) == 0)
        assert cosched_of(sched).pending_gangs() == {}
        assert getattr(sched, "loop_errors", 0) == 0
        return {p.metadata.name: p.spec.node_name
                for p in client.pods().list()}


def test_gangs_that_fit_land_as_jax(monkeypatch):
    got = _fit_run("port", monkeypatch)
    want = _fit_run("jax", monkeypatch)
    assert got == want


def _surplus_run(side, monkeypatch):
    objs, *_, counters = SIDES[side]
    # 12 nodes of 3 slots + 4 of 4: 52 slots for 7 gangs of 8
    nodes, pods = gang_cluster(objs, 7, slots=(3, 4))
    ttl0 = counters.get("gang.ttl_expired")
    with live(side, "gang_roster_config", monkeypatch, nodes, pods,
              assume_ttl_s=0.5, time_scale=0.01) as (client, sched, _):
        cos = cosched_of(sched)

        def whole(n_bound):
            # members of an admitted gang bind one by one, so a gang is
            # judged once the bound count has settled at a target
            st = gang_state(client)
            return (sum(b for b, _ in st.values()) == n_bound
                    and all(b in (0, t) for b, t in st.values()))

        assert wait_for(lambda: whole(48)
                        and counters.get("gang.ttl_expired") > ttl0)
        # the surplus gang cycles through TTL releases, never admitted
        ttl1 = counters.get("gang.ttl_expired")
        assert wait_for(lambda: counters.get("gang.ttl_expired") > ttl1 + 1)
        assert whole(48)
        # free a bound gang: the surplus gang must now land whole
        victim = next(k for k, (b, t) in gang_state(client).items() if b == t)
        for p in client.pods().list():
            if p.spec.gang.name == victim:
                client.pods().delete(p.metadata.name)
        assert wait_for(lambda: whole(48) and all(
            b == t for k, (b, t) in gang_state(client).items()
            if k != victim))
        assert wait_for(lambda: cos.pending_gangs() == {})
        assert wait_for(lambda: _assumed(sched) == 0)
        assert getattr(sched, "loop_errors", 0) == 0
        # no node over allocatable
        used = defaultdict(int)
        for p in client.pods().list():
            used[p.spec.node_name] += p.resource_requests().milli_cpu
        assert all(used[n.metadata.name] <= n.status.allocatable.milli_cpu
                   for n in client.nodes().list())


@pytest.mark.parametrize("side", ["port", "jax"])
def test_surplus_gang_is_all_or_nothing(side, monkeypatch):
    _surplus_run(side, monkeypatch)
