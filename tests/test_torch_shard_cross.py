"""The sharded write plane across both packages, on the CPU.

The same seeded inputs go through the JAX package's
``controlplane/shards.py`` and the port's: the rendezvous owner over
10,000 namespaces and group sets of 1-5 (overrides included), the
``VectorRV`` order on a table of pairs, topology documents read by the
other side, a handoff document built by either package and seeded by the
other's ``apply_seed`` (equal stores), the home group's budget document,
a WAL of freeze-lease records written by either and replayed by the
other, and each package's router against two in-process façades of the
other (routing, the 421 chase after a topology bump, a two-shard bind
batch exactly once across a retried call).

Then the reference faults the port repairs (ROADMAP §3), each with JAX's
behaviour beside the port's: a merged watch through a split behind a
stale router (JAX delivers the source's purge as DELETEs and drops the
target's seed; the port delivers the moved objects as MODIFIED and no
DELETE), groups minting the same uids (JAX's replica processes each
start their sequence at 1; the port's router mints distinct ones), and
the autosplit watcher on the target splitting a just-moved namespace
straight back (JAX) or not within its cooldown (the port).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from minisched_tpu.api import objects as jobj
from minisched_tpu.controlplane import checkpoint as jckpt
from minisched_tpu.controlplane import client as jclient
from minisched_tpu.controlplane import durable as jdurable
from minisched_tpu.controlplane import httpserver as jhttp
from minisched_tpu.controlplane import shards as jshards
from minisched_tpu.controlplane import store as jstore
from minisched_tpu.ha import membership as jmembership

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.controlplane import checkpoint as tckpt
from minisched_tpu_torch.controlplane import client as tclient
from minisched_tpu_torch.controlplane import durable as tdurable
from minisched_tpu_torch.controlplane import httpserver as thttp
from minisched_tpu_torch.controlplane import shards as tshards
from minisched_tpu_torch.controlplane import store as tstore
from minisched_tpu_torch.ha import membership as tmembership

PKG = {
    "jax": SimpleNamespace(obj=jobj, ckpt=jckpt, client=jclient,
                           durable=jdurable, http=jhttp, shards=jshards,
                           store=jstore),
    "port": SimpleNamespace(obj=tobj, ckpt=tckpt, client=tclient,
                            durable=tdurable, http=thttp, shards=tshards,
                            store=tstore),
}
OTHER = {"jax": "port", "port": "jax"}
TENANTS = [f"tenant-{i:02d}" for i in range(40)]


# ---------------------------------------------------------------------------
# placement, cursor and topology documents
# ---------------------------------------------------------------------------


def _seeded_namespaces(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789-"))
    out = ["", "default"]
    while len(out) < n:
        k = int(rng.integers(1, 24))
        out.append("".join(rng.choice(alphabet, size=k)))
    return out


@pytest.mark.parametrize("n_groups", [1, 2, 3, 4, 5])
def test_owner_equal_to_jax_for_seeded_namespaces(n_groups):
    """``shard_owner`` and ``ShardTopology.owner`` answer as JAX's for
    10,000 seeded namespaces, with 5% of them overridden to a seeded
    group, whatever order the groups were given in."""
    rng = np.random.default_rng(100 + n_groups)
    names = _seeded_namespaces(10_000, seed=n_groups)
    gids = [f"g{i}" for i in rng.permutation(n_groups)]
    members = sorted(gids)
    for ns in names:
        assert (tmembership.shard_owner(ns, members)
                == jmembership.shard_owner(ns, members)), ns
    overrides = {str(ns): str(gids[int(rng.integers(n_groups))])
                 for ns in rng.choice(names, size=500, replace=False)}
    groups = {g: [f"http://{g}"] for g in gids}
    jt = jshards.ShardTopology(groups, epoch=3, overrides=overrides)
    tt = tshards.ShardTopology(groups, epoch=3, overrides=overrides)
    assert [tt.owner(ns) for ns in names] == [jt.owner(ns) for ns in names]


def test_vector_rv_order_equal_to_jax():
    """``VectorRV``'s comparisons (against vectors, dicts and ints) and
    truthiness answer as JAX's on a seeded table of pairs."""
    rng = np.random.default_rng(11)

    def vec():
        return {f"g{i}": int(rng.integers(0, 4)) for i in range(3)
                if rng.random() < 0.85}

    for _ in range(3000):
        a, b = vec(), vec()
        n = int(rng.integers(-1, 4))
        for other in (b, n):
            ja, ta = jshards.VectorRV(a), tshards.VectorRV(a)
            jo = jshards.VectorRV(other) if isinstance(other, dict) else other
            to = tshards.VectorRV(other) if isinstance(other, dict) else other
            got = (ta > to, ta >= to, ta < to, ta <= to, bool(ta))
            want = (ja > jo, ja >= jo, ja < jo, ja <= jo, bool(ja))
            assert got == want, (a, other)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_topology_documents_read_across_both_ways(writer):
    """A topology's ``as_dict`` read by the other package's ``from_dict``
    writes the same document back and places every namespace alike."""
    w, r = PKG[writer].shards, PKG[OTHER[writer]].shards
    topo = w.ShardTopology(
        {"g0": ["http://a/", "http://a2"], "g1": ["http://b"],
         "g2": ["http://c"]},
        epoch=7, overrides={"tenant-03": "g2", "hot": "g0"},
        frozen=["tenant-05"])
    doc = json.loads(json.dumps(topo.as_dict()))
    back = r.ShardTopology.from_dict(doc)
    assert back.as_dict() == topo.as_dict()
    assert w.ShardTopology.from_dict(back.as_dict()).as_dict() == doc
    names = TENANTS + ["hot", "", "default"]
    assert [back.owner(ns) for ns in names] == [topo.owner(ns)
                                                for ns in names]


# ---------------------------------------------------------------------------
# handoff, budget document, lease WAL
# ---------------------------------------------------------------------------


def _fill(side: str):
    """The same store in either package: 4 nodes, pods in ``mv`` (two
    bound) and ``stay``, a claim in ``mv``; uids and creation stamps
    pinned, so the two stores hold equal objects at equal rvs."""
    p = PKG[side]
    store = p.store.ObjectStore()
    for i in range(4):
        n = p.obj.make_node(f"n{i}", capacity={"cpu": "4", "memory": "8Gi",
                                                "pods": 10})
        n.metadata.uid = f"uid-n{i}"
        n.metadata.creation_timestamp = 100.0 + i
        store.create("Node", n)
    for ns in ("mv", "stay"):
        for i in range(3):
            pod = p.obj.make_pod(f"{ns}-p{i}", namespace=ns,
                                 requests={"cpu": "500m", "memory": "1Gi"})
            pod.metadata.uid = f"uid-{ns}-{i}"
            pod.metadata.creation_timestamp = 200.0 + i
            store.create("Pod", pod)
    claim = p.obj.PersistentVolumeClaim(
        metadata=p.obj.ObjectMeta(name="data", namespace="mv",
                                  uid="uid-claim",
                                  creation_timestamp=300.0))
    store.create("PersistentVolumeClaim", claim)
    client = p.client.Client(store)
    for i, node in ((0, "n1"), (1, "n2")):
        client.pods("mv").bind(p.obj.Binding(f"mv-p{i}", "mv", node))
    client.pods("stay").bind(p.obj.Binding("stay-p0", "stay", "n1"))
    return store


def _contents(side: str, store) -> list:
    enc = PKG[side].ckpt._encode
    out = []
    for kind in ("Node", "Pod", "PersistentVolume", "PersistentVolumeClaim",
                 "Lease"):
        out += sorted((kind, json.dumps(enc(o), sort_keys=True))
                      for o in store.list(kind))
    return out


def test_handoff_documents_seed_either_package():
    """Both packages build the same handoff document of ``mv`` (the
    checkpoint codec's bytes, the purge manifest, the source's rv); each
    document seeded by the OTHER package's ``apply_seed`` into a fresh
    store gives equal stores, uids, bindings and rvs included."""
    docs = {side: PKG[side].shards.build_handoff(_fill(side), "mv")
            for side in PKG}
    assert json.dumps(docs["port"], sort_keys=True) == json.dumps(
        docs["jax"], sort_keys=True)
    assert docs["port"]["names"] == {
        "Pod": ["mv-p0", "mv-p1", "mv-p2"],
        "PersistentVolumeClaim": ["data"]}
    targets = {}
    for maker in PKG:
        seeder = OTHER[maker]
        store = PKG[seeder].store.ObjectStore()
        out = PKG[seeder].shards.apply_seed(store, docs[maker])
        assert out == {"namespace": "mv", "created": 4, "skipped": 0}
        targets[seeder] = _contents(seeder, store)
    assert targets["port"] == targets["jax"]
    assert any('"node_name": "n2"' in c for _k, c in targets["port"])


def test_budget_documents_equal():
    """The home group's budget document (allocatable and home usage per
    Node at the store's rv, and the board's non-home reports) is JAX's
    for the same store and reports."""
    docs = {}
    for side in PKG:
        sh = PKG[side].shards
        topo = sh.ShardTopology({"g0": ["http://a"], "g1": ["http://b"]})
        home = topo.owner("")
        info = sh.ShardInfo(home, topo)
        info.budget_board = sh.BudgetBoard()
        other = "g1" if home == "g0" else "g0"
        info.budget_board.report(other, {"n1": [500, 1024, 1],
                                         "n3": [250, 0, 2]}, rv=9)
        docs[side] = sh.build_budget_doc(_fill(side), info)
    assert docs["port"] == docs["jax"]
    assert docs["port"]["nodes"]["n1"]["used"] == [1000, 2 * 2**30, 2]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lease_wal_replays_across_packages(tmp_path, writer):
    """Freeze-lease records journaled by one package's durable store are
    recovered by the other's as by its own: the live lease and the
    expired one kept, the thawed one gone; the port's ShardInfo re-arms
    the live one."""
    wal = str(tmp_path / "lease.wal")
    store = PKG[writer].durable.DurableObjectStore(wal, fsync=False)
    now = time.time()
    store.record_shard_lease({"action": "freeze", "ns": "held",
                              "lease_id": "L-live", "ttl_s": 60.0,
                              "expires_at": now + 60.0})
    store.record_shard_lease({"action": "freeze", "ns": "thawed",
                              "lease_id": "L-gone", "ttl_s": 60.0,
                              "expires_at": now + 60.0})
    store.record_shard_lease({"action": "thaw", "ns": "thawed",
                              "lease_id": "L-gone"})
    store.record_shard_lease({"action": "freeze", "ns": "stale",
                              "lease_id": "L-old", "ttl_s": 0.01,
                              "expires_at": now - 5.0})
    store.close()
    recovered = {}
    for side in PKG:
        reopened = PKG[side].durable.DurableObjectStore(wal, fsync=False)
        try:
            recovered[side] = reopened.recovered_shard_leases()
        finally:
            reopened.close()
    assert recovered["port"] == recovered["jax"]
    assert set(recovered["port"]) == {"held", "stale"}
    info = tshards.ShardInfo("g0", tshards.ShardTopology({"g0": ["http://x"]}))
    info.adopt_leases(recovered["port"])
    with pytest.raises(tstore.ShardFrozen):
        info.check_write("held")
    info.check_write("stale")
    assert info.topology.frozen == {"held"}


# ---------------------------------------------------------------------------
# each router against the other package's façades
# ---------------------------------------------------------------------------


class Groups:
    """Two single-server leader groups of one package, in process, with
    shard guards, at topology epoch 2."""

    def __init__(self, side: str):
        p = PKG[side]
        self.side = side
        self.stores = {"g0": p.store.ObjectStore(),
                       "g1": p.store.ObjectStore()}
        stub = p.shards.ShardTopology({"g0": ["http://x"],
                                       "g1": ["http://x"]}, epoch=1)
        self.infos = {g: p.shards.ShardInfo(g, stub.copy())
                      for g in self.stores}
        self.stops = []
        urls = {}
        for gid, store in self.stores.items():
            _, url, stop = p.http.start_api_server(store,
                                                   shard=self.infos[gid])
            urls[gid] = [url]
            self.stops.append(stop)
        self.doc = {"epoch": 2, "groups": urls, "overrides": {},
                    "frozen": []}
        self.push(self.doc)

    def push(self, doc: dict) -> None:
        for info in self.infos.values():
            info.apply_control({"op": "topology", "topology": doc})

    def names(self, gid: str, kind: str = "Pod") -> set:
        return {o.metadata.name for o in self.stores[gid].list(kind)}

    def close(self) -> None:
        for stop in self.stops:
            stop()


@pytest.mark.parametrize("router", ["port", "jax"])
def test_router_against_the_other_package_facades(router):
    """One package's ``ShardedStore`` over two façades of the other:
    creates land on their namespace's owner only; after the servers'
    topology moves a namespace (epoch 3) the stale router's write is
    refused 421, chased through ``/shards/status`` and lands on the new
    owner; a bind batch spanning both groups binds on each, and the same
    logical batch posted again is answered from both ack registries
    (resource_versions unchanged)."""
    groups = Groups(OTHER[router])
    r = PKG[router]
    try:
        topo = r.shards.ShardTopology.from_dict(groups.doc)
        ns = {g: next(n for n in TENANTS if topo.owner(n) == g)
              for g in ("g0", "g1")}
        ss = r.shards.ShardedStore(topology=topo.copy(), retries=2)
        try:
            for gid, n in ns.items():
                ss.create("Pod", r.obj.make_pod(f"pod-{gid}", namespace=n))
            assert groups.names("g0") == {"pod-g0"}
            assert groups.names("g1") == {"pod-g1"}
            # the servers move ns[g0] to g1; the router still says g0
            doc = dict(groups.doc, epoch=3, overrides={ns["g0"]: "g1"})
            groups.push(doc)
            ss.create("Pod", r.obj.make_pod("chased", namespace=ns["g0"]))
            assert "chased" in groups.names("g1")
            assert "chased" not in groups.names("g0")
            assert ss.topology.epoch == 3
            # a two-shard bind batch, then the same logical batch again
            ss.create("Node", r.obj.make_node("n1"))
            home = ss.topology.owner("")
            assert groups.names(home, "Node") == {"n1"}
            ss.create("Pod", r.obj.make_pod("pa", namespace=ns["g1"]))
            ss.create("Pod", r.obj.make_pod("pb", namespace=ns["g0"]))
            third = next(n for n in TENANTS if ss.topology.owner(n) == "g0")
            ss.create("Pod", r.obj.make_pod("pc", namespace=third))
            binds = [r.obj.Binding("pa", ns["g1"], "n1"),
                     r.obj.Binding("pb", ns["g0"], "n1"),
                     r.obj.Binding("pc", third, "n1")]
            first = ss.bind_many_remote(binds, batch_id="logical-1")
            assert all(not isinstance(x, BaseException) for x in first)

            def state():
                out = {}
                for gid, st in groups.stores.items():
                    for p in st.list("Pod"):
                        out[p.metadata.name] = (gid, p.spec.node_name,
                                                p.metadata.resource_version)
                return out

            before = state()
            assert before["pa"][:2] == ("g1", "n1")
            assert before["pb"][:2] == ("g1", "n1")
            assert before["pc"][:2] == ("g0", "n1")
            second = ss.bind_many_remote(binds, batch_id="logical-1")
            assert all(not isinstance(x, BaseException) for x in second)
            assert state() == before, "a retried batch re-executed"
        finally:
            ss.close()
    finally:
        groups.close()


# ---------------------------------------------------------------------------
# reference faults the port repairs
# ---------------------------------------------------------------------------


def _drain(watch, settle_s: float = 1.5, timeout_s: float = 10.0) -> list:
    got: list = []
    deadline = time.monotonic() + timeout_s
    quiet_since = time.monotonic()
    while time.monotonic() < deadline:
        batch = watch.next_batch(timeout=0.1)
        if batch:
            got.extend(batch)
            quiet_since = time.monotonic()
        elif time.monotonic() - quiet_since > settle_s:
            break
    return got


@pytest.mark.parametrize("side", ["jax", "port"])
def test_split_behind_a_stale_router_watch(side):
    """A merged watch opened before a split, on a router that has not
    learned the new topology.  JAX's passes the source's purge as a
    DELETE of every moved pod and drops the target's seed (a consumer
    loses the pods); the port's delivers each moved pod once more as a
    MODIFIED from the target, with the target's resource_version, and
    no DELETE."""
    groups = Groups(side)
    p = PKG[side]
    try:
        topo = p.shards.ShardTopology.from_dict(groups.doc)
        ns = next(n for n in TENANTS if topo.owner(n) == "g1")
        ss = p.shards.ShardedStore(topology=topo.copy(), retries=2)
        try:
            for i in range(3):
                ss.create("Pod", p.obj.make_pod(f"m{i}", namespace=ns))
            w, snap = ss.watch("Pod", send_initial=True)
            try:
                assert len(_drain(w, settle_s=0.5)) == 3
                out = p.shards.split_namespace(topo.copy(), ns, "g0")
                assert out["objects"] == 3
                events = [(e.type.name, e.obj.metadata.name,
                           e.obj.metadata.resource_version)
                          for e in _drain(w)]
            finally:
                w.stop()
        finally:
            ss.close()
        moved = {o.metadata.name: o.metadata.resource_version
                 for o in groups.stores["g0"].list("Pod")}
        assert set(moved) == {"m0", "m1", "m2"}
        if side == "jax":
            assert sorted((t, n) for t, n, _rv in events) == [
                ("DELETED", n) for n in sorted(moved)]
        else:
            assert sorted(events) == sorted(
                ("MODIFIED", n, rv) for n, rv in moved.items())
    finally:
        groups.close()


def test_groups_mint_distinct_uids_through_the_port_router():
    """JAX's uids come from a process counter that starts at 1 in every
    replica child, so two groups mint the same uids for different pods;
    the port's stores mint per store (the same collision), and its
    router gives uid-less creates distinct uids when K > 1."""
    first = subprocess.run(
        [sys.executable, "-c", "from minisched_tpu.api.objects import "
         "new_uid; print(new_uid('pod'))"],
        capture_output=True, text=True, timeout=120, check=True)
    assert first.stdout.strip() == "pod-00000001"
    groups = Groups("port")
    try:
        for st in groups.stores.values():
            st.create("Pod", tobj.make_pod("direct", namespace="x"))
        assert len({o.metadata.uid for st in groups.stores.values()
                    for o in st.list("Pod")}) == 1
        topo = tshards.ShardTopology.from_dict(groups.doc)
        ss = tshards.ShardedStore(topology=topo, retries=2)
        try:
            for gid in ("g0", "g1"):
                ns = next(n for n in TENANTS if topo.owner(n) == gid)
                ss.create("Pod", tobj.make_pod("routed", namespace=ns))
        finally:
            ss.close()
        uids = [o.metadata.uid for st in groups.stores.values()
                for o in st.list("Pod") if o.metadata.name == "routed"]
        assert len(uids) == 2 and len(set(uids)) == 2
        assert all(not u.rsplit("-", 1)[1].isdigit() for u in uids)
    finally:
        groups.close()


@pytest.mark.parametrize("side", ["jax", "port"])
def test_autosplit_on_the_target_leaves_a_moved_namespace(side):
    """The load watcher on the group a split moved a hot namespace to
    sees the same load.  JAX's splits it straight back to the source;
    the port's leaves it for the cooldown."""
    sh = PKG[side].shards
    ns = next(n for n in TENANTS
              if sh.ShardTopology({"g0": ["a"], "g1": ["b"]}).owner(n)
              == "g0")
    topo = sh.ShardTopology({"g0": ["http://a"], "g1": ["http://b"]},
                            epoch=2, overrides={ns: "g1"})
    info = sh.ShardInfo("g1", topo)
    calls = []

    def split(t, namespace, target):
        calls.append((namespace, target))
        return {"namespace": namespace, "to": target}

    store = SimpleNamespace(_gc_stage=[object()], _fenced=False)
    watcher = sh.AutoSplitWatcher(store, info, p99_hot_s=3600.0,
                                  depth_hot=1, hot_samples=1,
                                  cooldown_s=3600.0, split=split)
    info.note_writes([ns])
    watcher.sample()
    if side == "jax":
        assert calls == [(ns, "g0")]
    else:
        assert calls == []
