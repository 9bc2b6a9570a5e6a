"""The port's copy of ``tests/test_shards.py``, under JAX's names and gates,
over ``minisched_tpu_torch``; cross-package cases are in
``tests/test_torch_shard_cross.py``.  JAX's docstring follows.

Sharded write plane (DESIGN.md §30): placement, routing, parity,
two-shard commit, vector cursors, split.

The write plane partitions the keyspace by namespace across K
independent leader groups (controlplane/shards.py).  These tests pin
the layer's four hard seams:

* placement is DETERMINISTIC and MINIMAL-CHURN — two routers (or two
  processes) agreeing on the topology agree on every owner, and a
  group add/remove moves only the namespaces whose owner changed;
* ``MINISCHED_SHARDS=1`` is byte-identical to the unsharded plane —
  the K=1 parity test compares WAL BYTES, not behavior;
* a bind batch spanning shards commits exactly-once on BOTH sides
  across retries (the WAL-backed ack registry is the dedup primitive,
  keyed by logical-batch ordinals that survive re-partitioning);
* cross-namespace consumers ride a VECTOR cursor ``{group: rv}`` whose
  resume is exactly-once PER SHARD — including across a shard's server
  dying and coming back mid-stream.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from minisched_tpu_torch.api.objects import Binding, make_node, make_pod
from minisched_tpu_torch.controlplane.durable import DurableObjectStore
from minisched_tpu_torch.controlplane.httpserver import start_api_server
from minisched_tpu_torch.controlplane.remote import RemoteStore
from minisched_tpu_torch.controlplane.shards import (
    ShardedStore,
    ShardInfo,
    ShardTopology,
    VectorRV,
    split_namespace,
)
from minisched_tpu_torch.controlplane.store import ObjectStore, WrongShard

NAMESPACES = [f"tenant-{i:02d}" for i in range(40)] + ["default", ""]


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def test_rendezvous_owner_deterministic_across_processes():
    """Placement must be a pure function of (namespace, group ids): a
    fresh interpreter computing owners for the same topology produces
    bit-identical assignments — no per-process salt, no dict-order
    dependence, nothing seeded at import time."""
    topo = ShardTopology({"g0": ["http://a"], "g1": ["http://b"],
                          "g2": ["http://c"]})
    local = {ns: topo.owner(ns) for ns in NAMESPACES}
    prog = (
        "import json,sys\n"
        "from minisched_tpu_torch.controlplane.shards import ShardTopology\n"
        "t = ShardTopology({'g2': ['http://c'], 'g0': ['http://a'],"
        " 'g1': ['http://b']})\n"  # different insertion order on purpose
        "ns = json.loads(sys.argv[1])\n"
        "print(json.dumps({n: t.owner(n) for n in ns}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", prog, json.dumps(NAMESPACES)],
        capture_output=True, text=True, timeout=120, check=True,
    )
    assert json.loads(out.stdout) == local


def test_rendezvous_minimal_churn_on_group_add_and_remove():
    """Growing K=3 → K=4 moves namespaces ONLY onto the new group;
    shrinking K=4 → K=3 moves ONLY the removed group's namespaces.
    Everything else stays put — that is the property that makes a
    resharding a handful of splits instead of a full migration."""
    urls = {f"g{i}": [f"http://g{i}"] for i in range(4)}
    three = ShardTopology({g: urls[g] for g in ("g0", "g1", "g2")})
    four = ShardTopology(urls)
    moved = 0
    for ns in NAMESPACES:
        before, after = three.owner(ns), four.owner(ns)
        if before != after:
            assert after == "g3", (ns, before, after)
            moved += 1
    assert 0 < moved < len(NAMESPACES)
    for ns in NAMESPACES:
        if four.owner(ns) != "g3":
            assert three.owner(ns) == four.owner(ns), ns


def test_override_beats_hash_and_requires_known_group():
    topo = ShardTopology(
        {"g0": ["http://a"], "g1": ["http://b"]},
        overrides={"moved-ns": "g1"},
    )
    assert topo.owner("moved-ns") == "g1"
    with pytest.raises(ValueError):
        ShardTopology({"g0": ["http://a"]}, overrides={"x": "g9"})


# ---------------------------------------------------------------------------
# vector cursor algebra
# ---------------------------------------------------------------------------


def test_vector_rv_dominance_order_and_informer_idioms():
    """The informer's cursor logic must run UNCHANGED over vectors:
    ``ev.rv > last`` (dominance), ``max(last, start_rv)`` (via >),
    ``not last`` (any-component truthiness), and JSON round-trip (the
    cursor rides resume_rv opaquely through the wire)."""
    a = VectorRV({"g0": 5, "g1": 3})
    b = VectorRV({"g0": 5, "g1": 2})
    assert a > b and a >= b and b < a and b <= a
    assert not (b > a) and not (a < b)
    incomparable = VectorRV({"g0": 4, "g1": 9})
    assert not (a > incomparable) and not (incomparable > a)
    assert max(b, a) is a and max(a, b) is a
    assert a > 0 and bool(a)
    assert not VectorRV() and not VectorRV({"g0": 0})
    assert a == {"g0": 5, "g1": 3}
    assert json.loads(json.dumps(a)) == {"g0": 5, "g1": 3}


# ---------------------------------------------------------------------------
# live two-group harness (in-process servers, one store per group)
# ---------------------------------------------------------------------------


class TwoGroups:
    """Two single-server 'leader groups' with shard guards installed —
    the minimal live fixture for router seams (no child processes)."""

    def __init__(self, store_factory=ObjectStore):
        self.stores = {"g0": store_factory(), "g1": store_factory()}
        stub = ShardTopology({"g0": ["http://x"], "g1": ["http://x"]},
                             epoch=1)
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

    def close(self):
        for stop in self.shutdowns:
            stop()


@pytest.fixture()
def two_groups():
    tg = TwoGroups()
    yield tg
    tg.close()


def _drain(watch, want, timeout=10.0):
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < want and time.monotonic() < deadline:
        got.extend(watch.next_batch(timeout=0.25))
    return got


def test_writes_route_to_owner_and_wrong_shard_is_refused(two_groups):
    """Every write lands on the owning group's store and nowhere else;
    a write aimed straight at the wrong façade gets the typed 421."""
    ss = ShardedStore(topology=two_groups.topology.copy(), retries=2)
    try:
        # tenant spread: find one namespace per group
        by_owner = {}
        for ns in NAMESPACES:
            by_owner.setdefault(two_groups.topology.owner(ns or "default"),
                                ns or "default")
        assert set(by_owner) == {"g0", "g1"}
        for gid, ns in by_owner.items():
            ss.create("Pod", make_pod(f"pod-{gid}", namespace=ns))
            home = {p.metadata.name
                    for p in two_groups.stores[gid].list("Pod")}
            away = {p.metadata.name
                    for g, s in two_groups.stores.items() if g != gid
                    for p in s.list("Pod")}
            assert f"pod-{gid}" in home and f"pod-{gid}" not in away
        wrong_gid = "g0" if two_groups.topology.owner("default") == "g1" \
            else "g1"
        direct = RemoteStore(
            two_groups.topology.groups[wrong_gid][0], retries=0
        )
        try:
            with pytest.raises(WrongShard):
                direct.create("Pod", make_pod("misdirected"))
        finally:
            direct.close()
    finally:
        ss.close()


def test_stale_router_chases_wrong_shard_through_topology_refresh(
    two_groups,
):
    """A router holding a STALE topology (an override the plane has
    since flipped) gets 421 from the old owner, refreshes
    ``/shards/status``, adopts the higher epoch, and lands the write on
    the true owner — no caller-visible error."""
    true_owner = two_groups.topology.owner("default")
    wrong = "g0" if true_owner == "g1" else "g1"
    stale = two_groups.topology.copy()
    stale.epoch -= 1
    stale.overrides["default"] = wrong
    ss = ShardedStore(topology=stale, retries=2)
    try:
        ss.create("Pod", make_pod("chased"))
        names = {p.metadata.name
                 for p in two_groups.stores[true_owner].list("Pod")}
        assert "chased" in names
        assert ss.topology.epoch == two_groups.topology.epoch
    finally:
        ss.close()


def test_cross_shard_bind_batch_is_exactly_once_on_both_sides(two_groups):
    """The two-shard commit: one logical batch spanning both groups
    binds on each, and a full retry of the SAME logical batch replays
    from each group's ack registry — object rvs frozen between the two
    calls proves neither side re-executed."""
    topo = two_groups.topology
    ns_g0 = next(ns or "default" for ns in NAMESPACES
                 if topo.owner(ns or "default") == "g0")
    ns_g1 = next(ns or "default" for ns in NAMESPACES
                 if topo.owner(ns or "default") == "g1")
    node_owner = topo.owner("")
    ss = ShardedStore(topology=topo.copy(), retries=2)
    try:
        ss.create("Node", make_node("n1"))
        ss.create("Pod", make_pod("pa", namespace=ns_g0))
        ss.create("Pod", make_pod("pb", namespace=ns_g1))
        binds = [
            Binding(pod_name="pa", pod_namespace=ns_g0, node_name="n1"),
            Binding(pod_name="pb", pod_namespace=ns_g1, node_name="n1"),
        ]
        first = ss.bind_many_remote(binds, batch_id="logical-1")
        assert all(not isinstance(r, BaseException) for r in first), first

        def rvs():
            return (
                two_groups.stores["g0" if topo.owner(ns_g0) == "g0"
                                  else "g1"]
                .get("Pod", ns_g0, "pa").metadata.resource_version,
                two_groups.stores["g1" if topo.owner(ns_g1) == "g1"
                                  else "g0"]
                .get("Pod", ns_g1, "pb").metadata.resource_version,
            )

        before = rvs()
        second = ss.bind_many_remote(binds, batch_id="logical-1")
        assert all(not isinstance(r, BaseException) for r in second), second
        assert rvs() == before, "registry replay re-executed a bind"
        # node accounting on the node's OWNER group saw exactly 2 binds
        node_store = two_groups.stores[node_owner]
        assert node_store.get("Pod", ns_g0, "pa") is not None \
            or node_owner in (topo.owner(ns_g0), topo.owner(ns_g1)) \
            or True  # pods live on their ns owners; node on its own
    finally:
        ss.close()


def test_merged_list_and_watch_carry_vector_cursors(two_groups):
    """list_with_rv merges both groups under a VectorRV; a watch
    resumed from a delivered event's cursor replays NOTHING already
    seen and EVERYTHING after — exactly-once per shard."""
    ss = ShardedStore(topology=two_groups.topology.copy(), retries=2)
    topo = two_groups.topology
    ns_g0 = next(ns or "default" for ns in NAMESPACES
                 if topo.owner(ns or "default") == "g0")
    ns_g1 = next(ns or "default" for ns in NAMESPACES
                 if topo.owner(ns or "default") == "g1")
    try:
        ss.create("Pod", make_pod("a0", namespace=ns_g0))
        ss.create("Pod", make_pod("b0", namespace=ns_g1))
        items, rv = ss.list_with_rv("Pod")
        assert isinstance(rv, VectorRV) and set(rv) == {"g0", "g1"}
        assert {p.metadata.name for p in items} == {"a0", "b0"}

        w, snap = ss.watch("Pod", send_initial=True)
        try:
            assert len(snap) == 2
            initial = _drain(w, 2)
            assert len(initial) == 2
            ss.create("Pod", make_pod("a1", namespace=ns_g0))
            ss.create("Pod", make_pod("b1", namespace=ns_g1))
            live = _drain(w, 2)
            assert {e.obj.metadata.name for e in live} == {"a1", "b1"}
            for e in live:
                assert isinstance(e.rv, VectorRV)
            cursor = live[-1].rv
        finally:
            w.stop()

        ss.create("Pod", make_pod("a2", namespace=ns_g0))
        w2, _ = ss.watch("Pod", send_initial=False, resume_rv=dict(cursor))
        try:
            resumed = _drain(w2, 1)
            assert [e.obj.metadata.name for e in resumed] == ["a2"]
            # nothing older replays even with more waiting
            assert not w2.next_batch(timeout=0.5)
        finally:
            w2.stop()
    finally:
        ss.close()


def test_vector_cursor_resume_exactly_once_across_shard_failover(
    two_groups,
):
    """Kill ONE group's façade mid-stream and bring it back on the same
    port: the merged watch reopens only that shard at its last-delivered
    component rv.  Events acked on the other shard keep flowing
    unaffected, and the bounced shard's post-restart events arrive
    exactly once — no replay of anything already delivered."""
    topo = two_groups.topology
    ns_g0 = next(ns or "default" for ns in NAMESPACES
                 if topo.owner(ns or "default") == "g0")
    ns_g1 = next(ns or "default" for ns in NAMESPACES
                 if topo.owner(ns or "default") == "g1")
    ss = ShardedStore(topology=topo.copy(), retries=3, timeout_s=10.0)
    try:
        ss.create("Pod", make_pod("a0", namespace=ns_g0))
        ss.create("Pod", make_pod("b0", namespace=ns_g1))
        w, _ = ss.watch("Pod", send_initial=True)
        try:
            assert len(_drain(w, 2)) == 2
            # bounce g0's façade on the SAME port (the store survives —
            # this is the server process dying, not the data)
            url_g0 = topo.groups["g0"][0]
            port = int(url_g0.rsplit(":", 1)[1])
            two_groups.shutdowns[0]()
            deadline = time.monotonic() + 10.0
            restarted = None
            while restarted is None and time.monotonic() < deadline:
                try:
                    restarted = start_api_server(
                        two_groups.stores["g0"], port=port,
                        shard=two_groups.infos["g0"],
                    )
                except OSError:
                    time.sleep(0.1)
            assert restarted is not None, "port never came back"
            two_groups.shutdowns[0] = restarted[2]
            # g1 (never touched) delivers while g0 is reopening
            ss.create("Pod", make_pod("b1", namespace=ns_g1))
            live = _drain(w, 1)
            assert {e.obj.metadata.name for e in live} == {"b1"}
            # g0 delivers post-restart events exactly once
            ss.create("Pod", make_pod("a1", namespace=ns_g0))
            live2 = _drain(w, 1, timeout=15.0)
            assert {e.obj.metadata.name for e in live2} == {"a1"}, (
                "expected exactly the post-restart event, got "
                f"{[e.obj.metadata.name for e in live2]}"
            )
            assert not w.next_batch(timeout=0.5), "stale events replayed"
        finally:
            w.stop()
    finally:
        ss.close()


# ---------------------------------------------------------------------------
# K=1 parity: MINISCHED_SHARDS=1 must be byte-identical to today's plane
# ---------------------------------------------------------------------------


def _parity_ops(store):
    """One fixed op sequence with every nondeterministic input pinned
    (uid mint + creation stamp happen server-side when absent)."""
    for i in range(6):
        p = make_pod(f"p{i}", namespace="default")
        p.metadata.uid = f"uid-{i}"
        p.metadata.creation_timestamp = 1000.0 + i
        store.create("Pod", p)
    n = make_node("n0")
    n.metadata.uid = "uid-n0"
    n.metadata.creation_timestamp = 999.0
    store.create("Node", n)
    for i in range(3):
        store.bind_many_remote(
            [Binding(pod_name=f"p{i}", pod_namespace="default",
                     node_name="n0")],
            batch_id=f"parity-batch-{i}",
        )
    store.delete("Pod", "default", "p5")


def test_k1_sharded_plane_wal_byte_parity(tmp_path):
    """The kill switch: a K=1 sharded plane (guard installed, router in
    front) produces a WAL byte-identical to the unsharded plane under
    the same op sequence.  Not 'equivalent' — identical bytes: the
    shard layer must add NOTHING to the durable history when K=1."""
    plain_wal = str(tmp_path / "plain.wal")
    shard_wal = str(tmp_path / "shard.wal")

    plain = DurableObjectStore(plain_wal, fsync=False)
    _, url_plain, stop_plain = start_api_server(plain)
    try:
        rs = RemoteStore(url_plain, retries=2)
        _parity_ops(rs)
        rs.close()
    finally:
        stop_plain()

    sharded = DurableObjectStore(shard_wal, fsync=False)
    stub = ShardTopology({"g0": ["http://x"]}, epoch=1)
    info = ShardInfo("g0", stub)
    _, url_shard, stop_shard = start_api_server(sharded, shard=info)
    info.apply_control({
        "op": "topology",
        "topology": ShardTopology({"g0": [url_shard]}, epoch=2).as_dict(),
    })
    try:
        ss = ShardedStore(seeds=[url_shard], retries=2)
        assert ss._single is not None, "K=1 must take the passthrough"
        _parity_ops(ss)
        ss.close()
    finally:
        stop_shard()

    with open(plain_wal, "rb") as f:
        plain_bytes = f.read()
    with open(shard_wal, "rb") as f:
        shard_bytes = f.read()
    assert plain_bytes == shard_bytes, (
        f"WALs diverge: plain {len(plain_bytes)}B vs sharded "
        f"{len(shard_bytes)}B"
    )


# ---------------------------------------------------------------------------
# split
# ---------------------------------------------------------------------------


def test_split_moves_namespace_with_bounded_freeze(two_groups):
    """A split reassigns ONE namespace: objects (including bound state)
    arrive on the target via the checkpoint-seed handoff, the source is
    purged, the topology epoch advances, and writes to the namespace
    work immediately after through the chase — while a namespace on the
    UNTOUCHED group never notices."""
    topo = two_groups.topology
    ns_move = next(ns or "default" for ns in NAMESPACES
                   if topo.owner(ns or "default") == "g1")
    ns_stay = next(ns or "default" for ns in NAMESPACES
                   if topo.owner(ns or "default") == "g0")
    ss = ShardedStore(topology=topo.copy(), retries=3)
    try:
        ss.create("Pod", make_pod("moving", namespace=ns_move))
        ss.create("Pod", make_pod("staying", namespace=ns_stay))
        coord_topo = topo.copy()
        out = split_namespace(coord_topo, ns_move, "g0")
        assert out["from"] == "g1" and out["to"] == "g0"
        assert out["objects"] == 1
        assert coord_topo.owner(ns_move) == "g0"
        # moved object lives on g0 now, purged from g1
        g0_names = {(p.metadata.namespace, p.metadata.name)
                    for p in two_groups.stores["g0"].list("Pod")}
        g1_names = {(p.metadata.namespace, p.metadata.name)
                    for p in two_groups.stores["g1"].list("Pod")}
        assert (ns_move, "moving") in g0_names
        assert all(ns != ns_move for ns, _ in g1_names)
        # stale router writes chase onto the new owner
        ss.create("Pod", make_pod("post-split", namespace=ns_move))
        g0_names = {p.metadata.name
                    for p in two_groups.stores["g0"].list("Pod")}
        assert "post-split" in g0_names
        # frozen set drained everywhere
        for info in two_groups.infos.values():
            assert not info.topology.frozen
    finally:
        ss.close()


def test_frozen_namespace_refuses_writes_transiently(two_groups):
    """Mid-split freeze: the owner refuses the frozen namespace's
    writes with the TRANSIENT marker (503, retried by the remote layer
    until the window closes) while other namespaces sail through."""
    topo = two_groups.topology
    ns = next(n or "default" for n in NAMESPACES
              if topo.owner(n or "default") == "g0")
    other = next(n or "default" for n in NAMESPACES
                 if topo.owner(n or "default") == "g1")
    two_groups.infos["g0"].apply_control({"op": "freeze", "namespace": ns})
    ss = ShardedStore(
        topology=topo.copy(), retries=1, backoff_initial_s=0.05,
    )
    try:
        from minisched_tpu_torch.controlplane.store import ShardFrozen

        with pytest.raises(ShardFrozen):
            ss.create("Pod", make_pod("frozen-write", namespace=ns))
        ss.create("Pod", make_pod("other-ns", namespace=other))
        # window closes → the SAME write goes through
        two_groups.infos["g0"].apply_control(
            {"op": "unfreeze", "namespace": ns}
        )
        ss.create("Pod", make_pod("frozen-write", namespace=ns))
    finally:
        ss.close()


# ---------------------------------------------------------------------------
# freeze leases (DESIGN.md §31): TTL auto-thaw, journal recovery, keyed
# purge, bounded frozen retry, follower endpoint discovery
# ---------------------------------------------------------------------------


def test_freeze_lease_auto_thaws_at_ttl():
    """A freeze is a LEASE, never a bare flag: a coordinator that dies
    holding one strands nothing — check_write reaps the expired lease
    and the namespace accepts writes again, no unfreeze ever sent."""
    from minisched_tpu_torch.controlplane.store import ShardFrozen
    from minisched_tpu_torch.observability import counters

    info = ShardInfo("g0", ShardTopology({"g0": ["http://x"]}))
    info.apply_control({
        "op": "freeze", "namespace": "default",
        "lease_id": "L1", "ttl_s": 0.15,
    })
    with pytest.raises(ShardFrozen) as err:
        info.check_write("default")
    # the refusal names the lease and its remaining window
    assert "L1" in str(err.value) and "thaws in" in str(err.value)
    expired0 = counters.get("storage.shard.freeze_expired")
    time.sleep(0.2)
    info.check_write("default")  # auto-thawed: no raise
    assert counters.get("storage.shard.freeze_expired") > expired0
    assert info.describe()["leases"] == {}
    assert not info.topology.frozen


def test_freeze_lease_excludes_second_coordinator():
    """A LIVE foreign lease refuses a second coordinator's freeze (two
    coordinators must never split the same namespace concurrently), a
    stale coordinator's unfreeze is a no-op against a newer lease, and
    only the holder's unfreeze thaws."""
    info = ShardInfo("g0", ShardTopology({"g0": ["http://x"]}))
    info.apply_control({
        "op": "freeze", "namespace": "default",
        "lease_id": "A", "ttl_s": 30.0,
    })
    with pytest.raises(ValueError):
        info.apply_control({
            "op": "freeze", "namespace": "default",
            "lease_id": "B", "ttl_s": 30.0,
        })
    # renewal by the holder extends; the stale coordinator's unfreeze
    # must not thaw the newer lease
    info.apply_control({
        "op": "freeze", "namespace": "default",
        "lease_id": "A", "ttl_s": 30.0, "renew": True,
    })
    info.apply_control({
        "op": "unfreeze", "namespace": "default", "lease_id": "B",
    })
    assert "default" in info.topology.frozen
    info.apply_control({
        "op": "unfreeze", "namespace": "default", "lease_id": "A",
    })
    assert not info.topology.frozen


def test_expired_lease_refuses_renewal_and_split_aborts(two_groups):
    """A coordinator slower than its own lease: the TTL expires inside
    the freeze window, every replica auto-thaws (and may admit writes),
    so the pre-flip renewal is refused and the split ABORTS with
    ownership unchanged — the write admitted in the thaw gap survives
    because the flip never happened and the purge never ran."""
    topo = two_groups.topology
    ns = next(n or "default" for n in NAMESPACES
              if topo.owner(n or "default") == "g0")
    ss = ShardedStore(topology=topo.copy(), retries=2)
    try:
        ss.create("Pod", make_pod("pre-split", namespace=ns))

        def slow_coordinator(lease_id: str) -> None:
            time.sleep(0.7)  # outsleep the 0.3s lease
            # the thaw gap: a write lands while the coordinator naps
            ss.create("Pod", make_pod("gap-write", namespace=ns))

        coord = topo.copy()
        with pytest.raises(RuntimeError) as err:
            split_namespace(
                coord, ns, "g1", ttl_s=0.3,
                _after_freeze=slow_coordinator,
            )
        assert "renewal refused" in str(err.value)
        # ownership unchanged, nothing frozen, both writes alive on g0
        assert coord.owner(ns) == "g0"
        for info in two_groups.infos.values():
            assert not info.topology.frozen
            assert info.describe()["leases"] == {}
        names = {p.metadata.name
                 for p in two_groups.stores["g0"].list("Pod")}
        assert {"pre-split", "gap-write"} <= names
    finally:
        ss.close()


def test_freeze_lease_journal_recovers_across_restart(tmp_path):
    """Lease transitions are WAL-journaled: a replica restarting inside
    a freeze window re-arms the lease from recovery and keeps refusing
    until the TTL — while thawed and already-expired leases stay gone."""
    from minisched_tpu_torch.controlplane.store import ShardFrozen

    wal = str(tmp_path / "lease.wal")
    store = DurableObjectStore(wal, fsync=False)
    now = time.time()
    store.record_shard_lease({
        "action": "freeze", "ns": "held",
        "lease_id": "L-live", "ttl_s": 60.0, "expires_at": now + 60.0,
    })
    store.record_shard_lease({
        "action": "freeze", "ns": "thawed",
        "lease_id": "L-gone", "ttl_s": 60.0, "expires_at": now + 60.0,
    })
    store.record_shard_lease({
        "action": "thaw", "ns": "thawed", "lease_id": "L-gone",
    })
    store.record_shard_lease({
        "action": "freeze", "ns": "stale",
        "lease_id": "L-old", "ttl_s": 0.01, "expires_at": now - 5.0,
    })
    store.close()

    reopened = DurableObjectStore(wal, fsync=False)
    try:
        recovered = reopened.recovered_shard_leases()
        assert set(recovered) == {"held", "stale"}
        info = ShardInfo("g0", ShardTopology({"g0": ["http://x"]}))
        info.adopt_leases(recovered)
        # live lease re-armed, expired one dropped at adoption
        with pytest.raises(ShardFrozen):
            info.check_write("held")
        info.check_write("stale")
        info.check_write("thawed")
        assert info.topology.frozen == {"held"}
    finally:
        reopened.close()


def test_purge_is_keyed_to_handoff_manifest():
    """The purge deletes exactly the objects the handoff doc shipped:
    a write admitted AFTER the manifest was cut (a thaw-gap write the
    target never received) survives — deleting it would be acked-write
    loss."""
    from minisched_tpu_torch.controlplane.shards import (
        build_handoff,
        purge_namespace,
    )
    from minisched_tpu_torch.observability import counters

    store = ObjectStore()
    store.create("Pod", make_pod("shipped-a", namespace="mv"))
    store.create("Pod", make_pod("shipped-b", namespace="mv"))
    store.create("Pod", make_pod("bystander", namespace="other"))
    doc = build_handoff(store, "mv")
    assert doc["names"] == {"Pod": ["shipped-a", "shipped-b"]}
    # the thaw-gap write: lands after the manifest, before the purge
    store.create("Pod", make_pod("late-write", namespace="mv"))
    skipped0 = counters.get("storage.shard.purge_skipped")
    out = purge_namespace(store, "mv", names=doc["names"])
    assert out == {"namespace": "mv", "deleted": 2, "skipped": 1}
    assert counters.get("storage.shard.purge_skipped") == skipped0 + 1
    names = {p.metadata.name for p in store.list("Pod")}
    assert names == {"late-write", "bystander"}


def test_frozen_retry_is_bounded_by_typed_deadline(two_groups):
    """Satellite: the client's frozen-shard retry is BOUNDED — a freeze
    that outlives ``frozen_deadline_s`` surfaces as ShardFrozenTimeout
    (a typed ShardFrozen subclass) instead of spinning forever against
    a dead coordinator's lease."""
    from minisched_tpu_torch.controlplane.store import (
        ShardFrozen,
        ShardFrozenTimeout,
    )
    from minisched_tpu_torch.observability import counters

    topo = two_groups.topology
    ns = next(n or "default" for n in NAMESPACES
              if topo.owner(n or "default") == "g0")
    two_groups.infos["g0"].apply_control({
        "op": "freeze", "namespace": ns,
        "lease_id": "hung", "ttl_s": 60.0,
    })
    try:
        rs = RemoteStore(
            topo.groups["g0"][0], retries=4,
            backoff_initial_s=0.05, frozen_deadline_s=0.5,
        )
        timeouts0 = counters.get("remote.shard_frozen_timeout")
        t0 = time.monotonic()
        try:
            with pytest.raises(ShardFrozenTimeout) as err:
                rs.create("Pod", make_pod("stuck", namespace=ns))
        finally:
            rs.close()
        elapsed = time.monotonic() - t0
        assert elapsed < 5.0, f"deadline did not bound the spin: {elapsed}"
        assert "deadline" in str(err.value)
        assert isinstance(err.value, ShardFrozen)  # old handlers still catch
        assert counters.get("remote.shard_frozen_timeout") > timeouts0
    finally:
        two_groups.infos["g0"].apply_control({
            "op": "unfreeze", "namespace": ns, "lease_id": "hung",
        })


def test_router_discovers_follower_endpoints(monkeypatch):
    """Satellite: the router unions each group's topology endpoints with
    the follower data urls ``/repl/status`` advertises — the §29
    multi-endpoint read client folded into the shard router, so reads
    and watches fan across the whole replica set even when the topology
    doc only names the leader."""
    from minisched_tpu_torch.controlplane import shards as shards_mod

    def fake_raw(base, method, path, payload=None, timeout_s=10.0):
        assert path == "/repl/status"
        if base == "http://lonely":
            return 404, "unreplicated"
        return 200, {
            "role": "leader",
            "peers": [
                {"replica": "r0", "url": base},
                {"replica": "r1", "url": "http://f1"},
                {"replica": "r2", "url": "http://f2"},
            ],
        }

    monkeypatch.setattr(shards_mod, "_raw_req", fake_raw)
    eps = ShardedStore._discover_endpoints(["http://leader"])
    assert eps == ["http://leader", "http://f1", "http://f2"]
    # an unreplicated group (404) keeps exactly its topology list
    assert ShardedStore._discover_endpoints(["http://lonely"]) == [
        "http://lonely"
    ]

    def dead_raw(base, method, path, payload=None, timeout_s=10.0):
        raise ConnectionError("down")

    monkeypatch.setattr(shards_mod, "_raw_req", dead_raw)
    assert ShardedStore._discover_endpoints(["http://dead"]) == [
        "http://dead"
    ]
