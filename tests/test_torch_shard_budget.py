"""The port's copy of ``tests/test_shard_budget.py``, under JAX's names and
gates, over ``minisched_tpu_torch``.  JAX's docstring follows.

Cross-shard capacity integrity (DESIGN.md §31 leg 1): the budget
mirror that lets a NON-home group refuse an over-capacity bind for a
Node it has never stored.

The home group (owner of the cluster-scoped namespace "") publishes an
rv-stamped per-Node budget doc (``GET /shards/budget``); every other
group keeps a monotonic mirror of it and reports its OWN per-Node usage
back (the ``budget_report`` control op).  The bind path then enforces
capacity from whichever vantage it runs on:

* non-home: mirror allocatable minus every OTHER vantage's usage, with
  this group's own share read off the LIVE local aggregate under the
  same lock hold its commit applies under — refusals are the same
  per-item OutOfCapacity 409 as the home path, stamped with the mirror
  rv watermark;
* home: locally-present Node budgets additionally debit the board's
  reported non-home usage.

The property test at the bottom is the acceptance gate: N clients
racing cross-shard binds over one nearly-full Node — under seeded
fault schedules injecting transient request failures — never exceed
the Node's allocatable.
"""

from __future__ import annotations

import random
import threading
import time

import pytest

from minisched_tpu_torch.api.objects import Binding, make_node, make_pod
from minisched_tpu_torch.controlplane.client import OutOfCapacity
from minisched_tpu_torch.controlplane.httpserver import start_api_server
from minisched_tpu_torch.controlplane.shards import (
    BudgetBoard,
    BudgetMirror,
    ShardedStore,
    ShardInfo,
    ShardTopology,
    _raw_req,
)
from minisched_tpu_torch.controlplane.store import ObjectStore
from minisched_tpu_torch.faults import FaultFabric
from minisched_tpu_torch.observability import counters

NAMESPACES = [f"tenant-{i:02d}" for i in range(40)] + ["default"]


# ---------------------------------------------------------------------------
# board / mirror units
# ---------------------------------------------------------------------------


def test_budget_board_reports_are_monotonic_per_group():
    board = BudgetBoard()
    board.report("g1", {"n1": [1000, 4096, 2]}, rv=5)
    assert board.extra_used("n1") == [1000, 4096, 2]
    # a delayed duplicate (older reporter rv) can never roll back
    board.report("g1", {"n1": [0, 0, 0]}, rv=3)
    assert board.extra_used("n1") == [1000, 4096, 2]
    # a newer report replaces; a second group's usage sums
    board.report("g1", {"n1": [2000, 0, 3]}, rv=7)
    board.report("g2", {"n1": [500, 0, 1], "n2": [1, 1, 1]}, rv=2)
    assert board.extra_used("n1") == [2500, 0, 4]
    assert board.extra_used("n2") == [1, 1, 1]
    assert board.extra_used("unknown") is None


def test_budget_mirror_is_monotonic_and_excludes_own_vantage():
    mirror = BudgetMirror("g1")
    doc = {
        "group": "g0",
        "rv": 10,
        "nodes": {"n1": {"alloc": [4000, 8192, 10], "used": [1000, 0, 2]}},
        "reported": {
            # this group's OWN report must be excluded — its live local
            # aggregate covers that share under the commit lock
            "g1": {"rv": 9, "nodes": {"n1": [9999, 9999, 9]}},
            "g2": {"rv": 4, "nodes": {"n1": [500, 0, 1]}},
        },
    }
    assert mirror.update(doc)
    alloc, elsewhere, rv = mirror.budget("n1")
    assert alloc == [4000, 8192, 10]
    assert elsewhere == [1500, 0, 3]  # home used + g2, NOT g1
    assert rv == 10
    assert mirror.budget("unknown") is None
    # a stale doc (lower rv) never rolls the view back
    assert not mirror.update({"rv": 8, "nodes": {}, "reported": {}})
    assert mirror.rv == 10 and mirror.budget("n1") is not None


# ---------------------------------------------------------------------------
# live two-group harness (home group g0 owns "", i.e. every Node)
# ---------------------------------------------------------------------------


class TwoGroups:
    def __init__(self):
        self.stores = {"g0": ObjectStore(), "g1": ObjectStore()}
        stub = ShardTopology(
            {"g0": ["http://x"], "g1": ["http://x"]}, epoch=1
        )
        self.infos = {g: ShardInfo(g, stub.copy()) for g in self.stores}
        self.shutdowns = []
        urls = {}
        for gid, store in self.stores.items():
            _, url, stop = start_api_server(store, shard=self.infos[gid])
            urls[gid] = [url]
            self.shutdowns.append(stop)
        self.topology = ShardTopology(urls, epoch=2)
        for info in self.infos.values():
            info.apply_control(
                {"op": "topology", "topology": self.topology.as_dict()}
            )
        assert self.topology.owner("") == "g0", "harness expects g0 home"

    def wait_mirror(self, node_name: str, timeout_s: float = 10.0):
        """Block until g1's budget sync loop has mirrored ``node_name``
        off the home group's budget doc."""
        deadline = time.monotonic() + timeout_s
        mirror = self.infos["g1"].budget_mirror
        while time.monotonic() < deadline:
            if mirror is not None and mirror.budget(node_name) is not None:
                return mirror.budget(node_name)
            time.sleep(0.05)
        raise AssertionError(f"mirror never learned {node_name!r}")

    def wait_report(self, node_name: str, pods_used: int,
                    timeout_s: float = 10.0):
        """Block until the home board reflects g1's usage report."""
        deadline = time.monotonic() + timeout_s
        board = self.infos["g0"].budget_board
        while time.monotonic() < deadline:
            extra = board.extra_used(node_name) if board else None
            if extra is not None and extra[2] >= pods_used:
                return extra
            time.sleep(0.05)
        raise AssertionError(
            f"board never saw {pods_used} pods on {node_name!r}"
        )

    def close(self):
        for stop in self.shutdowns:
            stop()


@pytest.fixture()
def two_groups():
    tg = TwoGroups()
    yield tg
    tg.close()


def _g1_ns(topology, i=0):
    owned = [ns for ns in NAMESPACES if topology.owner(ns) == "g1"]
    return owned[i]


def test_budget_doc_served_only_by_home_group(two_groups):
    """``/shards/budget`` is the home group's document: the home façade
    serves allocatable + usage per Node at its applied rv; every other
    group 404s (a non-home doc would be a second, conflicting truth)."""
    ss = ShardedStore(topology=two_groups.topology.copy(), retries=2)
    try:
        ss.create("Node", make_node("cap1", capacity={
            "cpu": "8", "memory": "32Gi", "pods": 4,
        }))
    finally:
        ss.close()
    status, doc = _raw_req(
        two_groups.topology.groups["g0"][0], "GET", "/shards/budget"
    )
    assert status == 200
    assert doc["group"] == "g0" and doc["rv"] >= 1
    assert doc["nodes"]["cap1"]["alloc"][2] == 4
    status, _doc = _raw_req(
        two_groups.topology.groups["g1"][0], "GET", "/shards/budget"
    )
    assert status == 404


def test_nonhome_bind_refusal_carries_mirror_rv_watermark(two_groups):
    """A non-home group refuses an over-capacity bind for a Node its
    store has never held — same per-item OutOfCapacity 409 as the home
    path, with the budget-mirror rv watermark in the message so the
    caller can judge how stale the verdict was."""
    ns = _g1_ns(two_groups.topology)
    ss = ShardedStore(topology=two_groups.topology.copy(), retries=2)
    try:
        ss.create("Node", make_node("cap1", capacity={
            "cpu": "64", "memory": "256Gi", "pods": 2,
        }))
        for i in range(3):
            ss.create("Pod", make_pod(f"p{i}", namespace=ns))
        two_groups.wait_mirror("cap1")
        checks0 = counters.get("shard.budget.mirror_checks")
        refused0 = counters.get("shard.budget.refused")
        for i in range(2):
            res = ss.bind_many_remote(
                [Binding(pod_name=f"p{i}", pod_namespace=ns,
                         node_name="cap1")],
                return_objects=False,
            )
            assert not isinstance(res[0], BaseException), res
        with pytest.raises(OutOfCapacity) as err:
            res = ss.bind_many_remote(
                [Binding(pod_name="p2", pod_namespace=ns,
                         node_name="cap1")],
                return_objects=False,
            )
            if isinstance(res[0], BaseException):
                raise res[0]
        msg = str(err.value)
        assert "out of capacity" in msg  # the 409 contract
        assert "budget-mirror rv=" in msg  # the staleness watermark
        assert counters.get("shard.budget.mirror_checks") > checks0
        assert counters.get("shard.budget.refused") > refused0
        # the node never exceeded allocatable: both bound pods live on
        # g1's store, nothing on g0's
        bound = [
            p for p in two_groups.stores["g1"].list("Pod")
            if p.spec.node_name == "cap1"
        ]
        assert len(bound) == 2
    finally:
        ss.close()


def test_home_bind_debits_reported_nonhome_usage(two_groups):
    """The OTHER direction of the mirror: once g1's usage report lands
    on the home board, the home group's own bind path treats those pods
    as consumed — the home vantage can no longer hand out capacity the
    remote vantage already claimed."""
    topo = two_groups.topology
    ns_g1 = _g1_ns(topo)
    ns_g0 = next(ns for ns in NAMESPACES if topo.owner(ns) == "g0")
    ss = ShardedStore(topology=topo.copy(), retries=2)
    try:
        ss.create("Node", make_node("cap2", capacity={
            "cpu": "64", "memory": "256Gi", "pods": 3,
        }))
        two_groups.wait_mirror("cap2")
        for i in range(2):
            ss.create("Pod", make_pod(f"r{i}", namespace=ns_g1))
            res = ss.bind_many_remote(
                [Binding(pod_name=f"r{i}", pod_namespace=ns_g1,
                         node_name="cap2")],
                return_objects=False,
            )
            assert not isinstance(res[0], BaseException), res
        two_groups.wait_report("cap2", pods_used=2)
        # home vantage: 3 allocatable - 2 reported = 1 left
        ss.create("Pod", make_pod("h0", namespace=ns_g0))
        ss.create("Pod", make_pod("h1", namespace=ns_g0))
        res = ss.bind_many_remote(
            [Binding(pod_name="h0", pod_namespace=ns_g0,
                     node_name="cap2")],
            return_objects=False,
        )
        assert not isinstance(res[0], BaseException), res
        with pytest.raises(OutOfCapacity) as err:
            res = ss.bind_many_remote(
                [Binding(pod_name="h1", pod_namespace=ns_g0,
                         node_name="cap2")],
                return_objects=False,
            )
            if isinstance(res[0], BaseException):
                raise res[0]
        # the home path's refusal carries no mirror watermark — its
        # Node budget is first-hand, not mirrored
        assert "out of capacity" in str(err.value)
        assert "budget-mirror" not in str(err.value)
    finally:
        ss.close()


# ---------------------------------------------------------------------------
# the acceptance property: racing cross-shard binds never overcommit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_cross_shard_racing_binds_never_exceed_allocatable(seed):
    """N clients race single-pod bind batches against ONE nearly-full
    Node, all through the non-home group (the serializable case the
    mirror guarantees: every contending commit goes through that
    group's store lock, where mirror-allocatable minus the LIVE local
    aggregate is exact).  Each client runs under a seeded fault
    schedule injecting transient request failures — retries, replays
    and reroutes included, the Node must never exceed its allocatable,
    and every acked bind must be durably present exactly once."""
    tg = TwoGroups()
    try:
        cap = 6
        setup = ShardedStore(topology=tg.topology.copy(), retries=4)
        ns0, ns1 = _g1_ns(tg.topology, 0), _g1_ns(tg.topology, 1)
        pods = []
        try:
            setup.create("Node", make_node("hot", capacity={
                "cpu": "64", "memory": "256Gi", "pods": cap,
            }))
            for i in range(16):
                ns = ns0 if i % 2 == 0 else ns1
                setup.create("Pod", make_pod(f"race-{i:02d}", namespace=ns))
                pods.append((ns, f"race-{i:02d}"))
        finally:
            setup.close()
        tg.wait_mirror("hot")

        acked: list = []
        refusals: list = []
        failures: list = []
        mu = threading.Lock()

        def racer(widx: int, mine: list) -> None:
            rng = random.Random(seed * 1000 + widx)
            fabric = FaultFabric(seed * 100 + widx).on(
                "remote.request", rate=0.2, max_fires=8
            )
            ss = ShardedStore(
                topology=tg.topology.copy(), retries=6,
                backoff_initial_s=0.01, faults=fabric,
            )
            try:
                for ns, name in mine:
                    time.sleep(rng.uniform(0.0, 0.01))
                    binding = Binding(
                        pod_name=name, pod_namespace=ns, node_name="hot"
                    )
                    try:
                        res = ss.bind_many_remote(
                            [binding], return_objects=False,
                            batch_id=f"race-{seed}-{ns}-{name}",
                        )
                        err = res[0] if isinstance(
                            res[0], BaseException
                        ) else None
                    except BaseException as e:  # noqa: BLE001
                        err = e
                    with mu:
                        if err is None:
                            acked.append((ns, name))
                        elif isinstance(err, OutOfCapacity) or \
                                "out of capacity" in str(err):
                            refusals.append(str(err))
                        else:
                            failures.append((name, repr(err)))
            finally:
                ss.close()

        threads = [
            threading.Thread(
                target=racer, args=(w, pods[w::4]), daemon=True
            )
            for w in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not failures, failures

        # THE invariant: the Node never exceeds its allocatable — no
        # interleaving of racers, retries and injected faults may ever
        # admit pod #7
        bound = [
            (p.metadata.namespace, p.metadata.name)
            for p in tg.stores["g1"].list("Pod")
            if p.spec.node_name == "hot"
        ]
        assert len(bound) <= cap, f"OVERCOMMIT: {len(bound)} > {cap}"
        # exactly-once accounting: every acked bind is present, nothing
        # unacked is, and the refused remainder got the typed 409
        assert sorted(bound) == sorted(acked)
        assert len(acked) == cap
        assert len(refusals) == len(pods) - cap
        assert all("budget-mirror rv=" in r for r in refusals)
    finally:
        tg.close()
