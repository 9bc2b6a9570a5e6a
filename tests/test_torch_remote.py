"""The port's remote control plane (``controlplane/remote.py``), on the
CPU.

The cases of ``tests/test_remote.py`` against the port (the engine with
``device="cpu"``); then each package's ``RemoteClient`` against the other
package's façade, in both directions: create, list, watch with resume,
410 past the history, the batch bind per item and the ack registry, with
the same answers; the same list bodies with ``MINISCHED_COW_READS`` at 1
and at 0 from both façades; ``overflow_cluster`` placed by each engine
behind its own package's ``RemoteClient`` and façade, with the same waves
and the same node for every pod; and a ``RemoteStore`` given more than
one endpoint raising.  Comparisons are exact.
"""

from __future__ import annotations

import json
import random
import time
import urllib.request

import numpy as np
import pytest

from minisched_tpu.api import objects as jobj
from minisched_tpu.controlplane import httpserver as jhttp
from minisched_tpu.controlplane import remote as jremote
from minisched_tpu.controlplane import store as jstore
from minisched_tpu.engine import device_scheduler as jds
from minisched_tpu.observability import counters as jcounters
from minisched_tpu.service import config as jconfig
from minisched_tpu.service import service as jservice

from minisched_tpu_torch.api.objects import Binding, make_node, make_pod
from minisched_tpu_torch.controlplane.client import AlreadyBound
from minisched_tpu_torch.controlplane.httpserver import start_api_server
from minisched_tpu_torch.controlplane.remote import RemoteClient
from minisched_tpu_torch.service.config import (
    default_full_roster_config,
    default_scheduler_config,
)
from minisched_tpu_torch.service.service import SchedulerService
from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.controlplane import httpserver as thttp
from minisched_tpu_torch.controlplane import remote as tremote
from minisched_tpu_torch.controlplane import store as tstore
from minisched_tpu_torch.engine import device_scheduler as tds
from minisched_tpu_torch.observability import counters as tcounters
from minisched_tpu_torch.service import config as tconfig
from minisched_tpu_torch.service import service as tservice


def _wait(pred, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_batch_bindings_endpoint_per_item_semantics():
    _server, base, shutdown = start_api_server()
    try:
        client = RemoteClient(base)
        client.nodes().create(make_node("n1"))
        client.pods().create(make_pod("p1"))
        client.pods().create(make_pod("p2"))
        res = client.pods().bind_many(
            [
                Binding("p1", "default", "n1"),
                Binding("missing", "default", "n1"),
                Binding("p2", "default", "n1"),
            ]
        )
        assert res[0].spec.node_name == "n1"
        assert isinstance(res[1], KeyError)
        assert res[2].spec.node_name == "n1"
        # double bind surfaces AlreadyBound per item
        [again] = client.pods().bind_many([Binding("p1", "default", "n1")])
        assert isinstance(again, AlreadyBound)
    finally:
        shutdown()


def test_readme_scenario_over_the_wire():
    """The README scenario with the SCHEDULER attached over HTTP: informers
    watch the chunked stream, the bind crosses the REST boundary."""
    _server, base, shutdown = start_api_server()
    try:
        client = RemoteClient(base)
        for i in range(1, 10):
            client.nodes().create(make_node(f"node{i}", unschedulable=True))
        client.pods().create(make_pod("pod1"))
        svc = SchedulerService(client)
        svc.start_scheduler(default_scheduler_config(time_scale=0.01),
                            device="cpu")
        try:
            time.sleep(0.6)
            assert client.pods().get("pod1").spec.node_name == ""
            client.nodes().create(make_node("node10"))
            _wait(
                lambda: client.pods().get("pod1").spec.node_name == "node10",
                15.0,
                "pod1 bound to node10 over HTTP",
            )
        finally:
            svc.shutdown_scheduler()
    finally:
        shutdown()


def test_device_engine_full_roster_over_the_wire():
    """Moderate scale: the wave engine drains 400 pods over 64 nodes with
    the full default roster, every informer event and every bind crossing
    the wire; ends with the safety audit."""
    _server, base, shutdown = start_api_server()
    try:
        client = RemoteClient(base)
        rng = random.Random(5)
        for i in range(64):
            client.nodes().create(
                make_node(
                    f"n{i:03d}",
                    capacity={"cpu": "8", "memory": "16Gi", "pods": 16},
                    unschedulable=rng.random() < 0.2,
                    labels={"zone": f"z{i % 4}"},
                )
            )
        for i in range(400):
            client.pods().create(
                make_pod(
                    f"p{i:04d}",
                    requests={"cpu": f"{rng.randrange(100, 600)}m"},
                )
            )
        svc = SchedulerService(client)
        svc.start_scheduler(
            default_full_roster_config(), device_mode=True, max_wave=128,
            device="cpu",
        )
        try:
            _wait(
                lambda: sum(
                    1 for p in client.pods().list() if p.spec.node_name
                )
                >= 400,
                120.0,
                "400 pods bound over HTTP",
            )
        finally:
            svc.shutdown_scheduler()
        # safety audit over the wire-visible state
        from collections import defaultdict

        cpu = defaultdict(int)
        cnt = defaultdict(int)
        for p in client.pods().list():
            cpu[p.spec.node_name] += p.resource_requests().milli_cpu
            cnt[p.spec.node_name] += 1
        for n in client.nodes().list():
            name = n.metadata.name
            assert cpu[name] <= n.status.allocatable.milli_cpu, name
            assert cnt[name] <= n.status.allocatable.pods, name
            assert not (n.spec.unschedulable and cnt[name]), name
    finally:
        shutdown()


def test_bindings_endpoint_rejects_malformed_bodies():
    """Malformed JSON / non-dict bodies get a 400, not a dropped socket."""
    import json
    import urllib.error
    import urllib.request

    _server, base, shutdown = start_api_server()
    try:
        for body in (b"{not json", b"[1, 2]", b'{"items": [42]}'):
            req = urllib.request.Request(
                base + "/api/v1/bindings",
                data=body,
                method="POST",
                headers={"Content-Type": "application/json"},
            )
            try:
                urllib.request.urlopen(req, timeout=5)
                raise AssertionError(f"{body!r} accepted")
            except urllib.error.HTTPError as e:
                assert e.code == 400, (body, e.code)
                assert "error" in json.loads(e.read())
    finally:
        shutdown()


def test_remote_watch_reconnects_and_resyncs():
    """A watch stream dying mid-run must NOT freeze the informer: the
    reflector re-watches, diffs the replayed snapshot against its cache,
    and delivers exactly the missed changes (MODIFIED for changed
    objects, DELETED for vanished ones, ADDED for new) — client-go
    re-list semantics over the chunked-watch wire."""
    from minisched_tpu_torch.controlplane.informer import (
        ResourceEventHandlers,
        SharedInformerFactory,
    )

    _server, base, shutdown = start_api_server()
    try:
        client = RemoteClient(base)
        client.pods().create(make_pod("keep"))
        client.pods().create(make_pod("gone"))
        client.pods().create(make_pod("tochange"))

        factory = SharedInformerFactory(client.store)
        inf = factory.informer_for("Pod")
        events = []
        inf.add_event_handlers(
            ResourceEventHandlers(
                on_add=lambda o: events.append(("add", o.metadata.name)),
                on_update=lambda old, new: events.append(
                    ("upd", new.metadata.name)
                ),
                on_delete=lambda o: events.append(("del", o.metadata.name)),
            )
        )
        factory.start()
        assert factory.wait_for_cache_sync(10)
        _wait(lambda: len(events) >= 3, 5, "initial adds")

        # kill the stream out from under the informer (simulated network
        # failure: close the response socket, not an informer stop)
        inf._watch._resp.close()

        # changes landing while the watch is down
        client.pods().delete("gone")
        client.nodes().create(make_node("n1"))
        client.pods().bind(Binding("tochange", "default", "n1"))
        client.pods().create(make_pod("fresh"))

        _wait(
            lambda: ("del", "gone") in events
            and ("upd", "tochange") in events
            and ("add", "fresh") in events,
            15,
            "resync delivered the missed delete/update/add",
        )
        # the unchanged object must NOT be re-delivered by the resync
        assert events.count(("add", "keep")) == 1
        assert inf.get("default/keep") is not None
        assert inf.get("default/gone") is None
        factory.shutdown()
    finally:
        shutdown()


def test_batch_create_collection_post():
    """Collection POST with an items list creates the whole batch in one
    round-trip — per-item conflict errors come back per entry and never
    abort the rest (same shape as the batch bindings endpoint)."""
    _server, base, shutdown = start_api_server()
    try:
        client = RemoteClient(base)
        created = client.nodes().create_many(
            [make_node(f"bn{i}") for i in range(5)]
        )
        assert [n.metadata.name for n in created] == [
            f"bn{i}" for i in range(5)
        ]
        assert {n.metadata.name for n in client.nodes().list()} == {
            f"bn{i}" for i in range(5)
        }
        pods = client.pods().create_many(
            [make_pod(f"bp{i}", requests={"cpu": "100m"}) for i in range(7)]
        )
        assert len(pods) == 7
        assert all(p.metadata.resource_version for p in pods)
        assert len(client.pods().list()) == 7
        # duplicate in the batch: that entry errors, the rest land
        results = client.store.create_many(
            "Pod", [make_pod("bp0"), make_pod("bp-new")]
        )
        assert isinstance(results[0], KeyError)
        assert results[1].metadata.name == "bp-new"
        assert client.pods().get("bp-new") is not None
        # the in-process client exposes the same surface
        from minisched_tpu_torch.controlplane.client import Client

        local = Client()
        out = local.nodes().create_many([make_node("ln0"), make_node("ln1")])
        assert [n.metadata.name for n in out] == ["ln0", "ln1"]
        out = local.pods().create_many([make_pod("lp0")])
        assert out[0].metadata.namespace == "default"
    finally:
        shutdown()


def test_stale_put_conflicts_and_mutate_retries_to_success():
    """Acceptance: a PUT carrying a wrong expected_rv precondition gets
    409 (store.Conflict), never a silent last-write-wins; RemoteStore's
    get–mutate–retry re-reads and lands the merge."""
    import pytest

    from minisched_tpu_torch.controlplane.store import Conflict

    _server, base, shutdown = start_api_server()
    try:
        client = RemoteClient(base)
        store = client.store
        node = client.nodes().create(make_node("n1"))
        stale_rv = node.metadata.resource_version
        # competing writer bumps the version
        node2 = client.nodes().get("n1")
        node2.metadata.labels["who"] = "writer2"
        client.nodes().update(node2)
        # the stale precondition is rejected wholesale
        node.metadata.labels["who"] = "writer1"
        with pytest.raises(Conflict):
            store.update("Node", node, expected_rv=stale_rv)
        assert client.nodes().get("n1").metadata.labels["who"] == "writer2"

        # get–mutate–retry: the first PUT is made stale by a competing
        # update snuck in DURING fn; the retry re-reads and succeeds
        calls = {"n": 0}

        def fn(cur):
            calls["n"] += 1
            if calls["n"] == 1:
                racer = client.nodes().get("n1")
                racer.metadata.labels["racer"] = "yes"
                client.nodes().update(racer)
            cur.metadata.labels["mutated"] = str(calls["n"])
            return cur

        out = store.mutate("Node", "", "n1", fn)
        assert calls["n"] == 2  # one conflict, one clean retry
        assert out.metadata.labels["mutated"] == "2"
        assert out.metadata.labels["racer"] == "yes"  # merge, not clobber
        from minisched_tpu_torch.observability import counters

        assert counters.get("remote.conflict_retry") >= 1
    finally:
        shutdown()


def test_bind_with_stale_expected_rv_is_conflict():
    """A binding that names a pod version the world has moved past must
    NOT land on stale requirements — per-item Conflict, batch continues."""
    from minisched_tpu_torch.controlplane.store import Conflict

    _server, base, shutdown = start_api_server()
    try:
        client = RemoteClient(base)
        client.nodes().create(make_node("n1"))
        p1 = client.pods().create(make_pod("p1"))
        p2 = client.pods().create(make_pod("p2"))
        stale = p1.metadata.resource_version
        p1b = client.pods().get("p1")
        p1b.metadata.labels["bump"] = "1"
        client.pods().update(p1b)
        res = client.pods().bind_many(
            [
                Binding("p1", "default", "n1", expected_rv=stale),
                Binding("p2", "default", "n1",
                        expected_rv=p2.metadata.resource_version),
            ]
        )
        assert isinstance(res[0], Conflict)
        assert res[1].spec.node_name == "n1"
        assert not client.pods().get("p1").spec.node_name
        # fresh rv: the retried decision lands
        cur = client.pods().get("p1")
        [ok] = client.pods().bind_many(
            [Binding("p1", "default", "n1",
                     expected_rv=cur.metadata.resource_version)]
        )
        assert ok.spec.node_name == "n1"
    finally:
        shutdown()


def test_watch_resume_replays_only_the_missed_tail():
    """?resource_version=N resumes: the new stream replays exactly the
    events after N (deletes included) with SYNC count 0 — no snapshot
    re-replay, nothing missed in the gap."""
    _server, base, shutdown = start_api_server()
    try:
        client = RemoteClient(base)
        store = client.store
        client.pods().create(make_pod("a"))
        client.pods().create(make_pod("b"))
        w1, snap = store.watch("Pod")
        assert len(snap) == 2
        seen = []
        deadline = time.monotonic() + 5
        while len(seen) < 2 and time.monotonic() < deadline:
            seen.extend(w1.next_batch(timeout=0.2))
        last_rv = max(ev.rv for ev in seen)
        w1.stop()
        # the gap: one create, one delete
        client.pods().create(make_pod("c"))
        client.pods().delete("a")
        w2, snap2 = store.watch("Pod", resume_rv=last_rv)
        assert snap2 == []  # SYNC count 0: nothing to re-sync
        tail = []
        deadline = time.monotonic() + 5
        while len(tail) < 2 and time.monotonic() < deadline:
            tail.extend(w2.next_batch(timeout=0.2))
        assert [(e.type.value, e.obj.metadata.name) for e in tail] == [
            ("ADDED", "c"), ("DELETED", "a"),
        ]
        assert all(e.rv > last_rv for e in tail)
        w2.stop()
    finally:
        shutdown()


def test_watch_resume_from_compacted_rv_is_410():
    """Acceptance: a resume older than the retained history gets 410 Gone
    (store.HistoryCompacted) — the consumer must relist, never silently
    miss the gap."""
    import pytest

    from minisched_tpu_torch.controlplane.store import HistoryCompacted, ObjectStore

    store = ObjectStore(history_events=2)  # tiny ring: overflow fast
    _server, base, shutdown = start_api_server(store)
    try:
        client = RemoteClient(base)
        for i in range(6):
            client.pods().create(make_pod(f"p{i}"))
        with pytest.raises(HistoryCompacted):
            client.store.watch("Pod", resume_rv=1)
        # a resume inside the ring still works
        w, snap = client.store.watch(
            "Pod", resume_rv=store.resource_version
        )
        assert snap == []
        w.stop()
    finally:
        shutdown()


def test_bind_batch_ack_registry_skips_reposted_entries():
    """Partial-batch acks: a retried batch (same batch_id — the response
    was lost) answers already-committed entries from the server's ack
    registry instead of re-running them, so a replay is success, not a
    wave of AlreadyBound errors.  A DIFFERENT batch_id re-executes and
    sees the genuine AlreadyBound."""
    import json as _json
    import urllib.request

    _server, base, shutdown = start_api_server()
    try:
        client = RemoteClient(base)
        client.nodes().create(make_node("n1"))
        client.pods().create(make_pod("p1"))
        client.pods().create(make_pod("p2"))

        def post(payload):
            req = urllib.request.Request(
                base + "/api/v1/bindings",
                data=_json.dumps(payload).encode(),
                method="POST",
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=10.0) as r:
                return _json.loads(r.read())

        body = {
            "batch_id": "wave-1",
            "items": [
                {"namespace": "default", "name": "p1", "node_name": "n1"},
                {"namespace": "default", "name": "p2", "node_name": "n1"},
            ],
        }
        first = post(body)["items"]
        assert all("error" not in e for e in first)
        # blind re-POST of the identical batch: everything acked, nothing
        # re-executed (no AlreadyBound), objects replayed from the registry
        second = post(body)["items"]
        assert all(e.get("acked") for e in second), second
        assert all("error" not in e for e in second), second
        # a new batch identity re-executes for real
        third = post(dict(body, batch_id="wave-2"))["items"]
        assert all(e.get("type") == "AlreadyBound" for e in third), third
        assert all(e.get("node") == "n1" for e in third)
    finally:
        shutdown()


# -- each package's client against the other package's façade --------------

#: side → (objects, façade module, remote module, store module, counters)
PKG = {
    "jax": (jobj, jhttp, jremote, jstore, jcounters),
    "port": (tobj, thttp, tremote, tstore, tcounters),
}
PAIRS = [("port", "jax"), ("jax", "port"), ("port", "port"), ("jax", "jax")]


def _drain(w, n, timeout=10.0):
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        out.extend(w.next_batch(timeout=0.2))
    return out


def _outcome(res):
    """A bind or create result as comparable data."""
    if isinstance(res, BaseException):
        return type(res).__name__
    if res is None:
        return None
    return (res.metadata.name, res.spec.node_name)


def wire_script(client_side, server_side):
    """One script of calls from ``client_side``'s ``RemoteClient`` to
    ``server_side``'s façade: the transcript of every answer."""
    objs, _, rmod, _, cnt = PKG[client_side]
    _, hmod, _, smod, _ = PKG[server_side]
    out = []
    server_store = smod.ObjectStore()
    _server, base, shutdown = hmod.start_api_server(server_store)
    try:
        client = rmod.RemoteClient(base)
        client.nodes().create_many([objs.make_node("n1"),
                                    objs.make_node("n2")])
        created = client.pods().create_many(
            [objs.make_pod(f"p{i}") for i in range(1, 5)])
        out.append(("created", [(p.metadata.name,
                                 p.metadata.resource_version)
                                for p in created]))
        items, rv = client.store.list_with_rv("Pod")
        out.append(("list", sorted(p.metadata.name for p in items), rv,
                    rv == server_store.resource_version))
        out.append(("nodes", sorted(n.metadata.name
                                    for n in client.nodes().list())))
        # watch, then resume from the last event seen
        w, snap = client.store.watch("Pod")
        seen = _drain(w, 4)
        w.stop()
        out.append(("watch", len(snap), w.start_rv,
                    sorted((e.type.value, e.obj.metadata.name, e.rv)
                           for e in seen)))
        last_rv = max(e.rv for e in seen)
        client.pods().create(objs.make_pod("p5"))
        client.pods().delete("p1")
        w2, snap2 = client.store.watch("Pod", resume_rv=last_rv)
        tail = _drain(w2, 2)
        w2.stop()
        out.append(("resume", snap2, [(e.type.value, e.obj.metadata.name,
                                       e.rv) for e in tail]))
        # batch bind, per item
        res = client.pods().bind_many([
            objs.Binding("p2", "default", "n1"),
            objs.Binding("missing", "default", "n1"),
            objs.Binding("p3", "default", "n2")])
        out.append(("bind", [_outcome(r) for r in res]))
        [again] = client.pods().bind_many([objs.Binding("p2", "default",
                                                        "n1")])
        out.append(("bind-again", _outcome(again)))
        # the ack registry: one batch_id posted twice
        acked0 = cnt.get("remote.bind_ack_replayed")
        first = client.store.bind_many_remote(
            [objs.Binding("p4", "default", "n1")], batch_id="b1")
        second = client.store.bind_many_remote(
            [objs.Binding("p4", "default", "n1")], batch_id="b1")
        third = client.store.bind_many_remote(
            [objs.Binding("p4", "default", "n1")], batch_id="b2")
        out.append(("acks", [_outcome(r) for r in first + second + third],
                    cnt.get("remote.bind_ack_replayed") - acked0))
        out.append(("final", sorted(
            (p.metadata.name, p.spec.node_name)
            for p in client.pods().list())))
        client.store.close()
    finally:
        shutdown()
    # a resume past the history: 410
    small = smod.ObjectStore(history_events=2)
    _server, base, shutdown = hmod.start_api_server(small)
    try:
        client = rmod.RemoteClient(base)
        for i in range(6):
            client.pods().create(objs.make_pod(f"q{i}"))
        try:
            client.store.watch("Pod", resume_rv=1)
            out.append(("gone", None))
        except Exception as e:  # noqa: BLE001 - the type is the answer
            out.append(("gone", type(e).__name__))
        w, snap = client.store.watch("Pod", resume_rv=small.resource_version)
        out.append(("inside", snap))
        w.stop()
        client.store.close()
    finally:
        shutdown()
    return out


@pytest.mark.parametrize("client_side,server_side", PAIRS)
def test_client_against_either_facade_answers_as_jax(client_side,
                                                     server_side):
    """The script's transcript equals JAX's client against JAX's façade,
    whichever package plays client and server."""
    want = wire_script("jax", "jax")
    got = wire_script(client_side, server_side)
    assert got == want
    assert ("gone", "HistoryCompacted") in want
    assert ("bind-again", "AlreadyBound") in want


def _seeded(side, cow, monkeypatch):
    objs, hmod, _, smod, _ = PKG[side]
    monkeypatch.setenv("MINISCHED_COW_READS", cow)
    store = smod.ObjectStore()
    assert (store.read_plane() is not None) == (cow == "1")
    for i in range(12):
        p = objs.make_pod(f"p-{i:02d}",
                          namespace="default" if i % 3 else "kube-system")
        p.metadata.uid = f"uid-{i:02d}"
        p.metadata.creation_timestamp = 1700000000.0 + i
        store.create("Pod", p)
    return hmod.start_api_server(store)


def _raw(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return r.read()


def test_list_bodies_byte_equal_across_read_modes_on_both_facades(
        monkeypatch):
    """Each façade answers byte-identical list bodies, full and
    namespace-filtered, with ``MINISCHED_COW_READS`` at 1 and at 0; the
    two façades' bodies decode to the same objects (the port's field
    order differs from JAX's, not the values)."""
    bodies = {}
    for side in ("port", "jax"):
        for cow in ("1", "0"):
            _server, base, shutdown = _seeded(side, cow, monkeypatch)
            try:
                bodies[side, cow] = (
                    _raw(base, "/api/v1/pods"),
                    _raw(base, "/api/v1/namespaces/kube-system/pods"))
            finally:
                shutdown()
    for side in ("port", "jax"):
        assert bodies[side, "1"] == bodies[side, "0"]

    def decoded(raw):
        doc = json.loads(raw)
        return doc["resource_version"], sorted(
            (o["metadata"]["namespace"], o["metadata"]["name"],
             o["metadata"]["uid"], o["metadata"]["resource_version"])
            for o in doc["items"])

    for i in range(2):
        assert (decoded(bodies["port", "1"][i])
                == decoded(bodies["jax", "1"][i]))
    assert len(json.loads(bodies["port", "1"][1])["items"]) == 4


def test_remote_store_refuses_more_than_one_endpoint():
    """The multi-endpoint read policy waits for replication: a second
    endpoint raises, naming ROADMAP item 7; the same endpoint twice is one
    endpoint."""
    with pytest.raises(ValueError, match="ROADMAP item 7"):
        tremote.RemoteStore("http://127.0.0.1:1",
                            endpoints=["http://127.0.0.1:2"])
    with pytest.raises(ValueError, match="ROADMAP item 8"):
        tremote.RemoteStore("http://127.0.0.1:1", faults=object())
    store = tremote.RemoteStore("http://127.0.0.1:1",
                                endpoints=["http://127.0.0.1:1/"])
    store.close()


# -- placement parity over the wire ------------------------------------------

HOST = "kubernetes.io/hostname"


def overflow_cluster(objs, seed=0, n_nodes=12, n_pods=60):
    """``tests/test_torch_engine.py``'s: nodes of 4 CPU (20% cordoned) and
    more pods than fit, with explicit uids."""
    rng = np.random.default_rng(seed)
    nodes = [objs.make_node(f"n{i:03d}",
                            unschedulable=bool(rng.random() < 0.2),
                            capacity={"cpu": "4", "memory": "8Gi",
                                      "pods": 110},
                            labels={"zone": f"z{i % 3}", HOST: f"n{i:03d}"})
             for i in range(n_nodes)]
    pods = [objs.make_pod(f"p{i:04d}", requests={
        "cpu": f"{int(rng.choice([500, 1000, 1500]))}m", "memory": "1Gi"})
        for i in range(n_pods)]
    for i, p in enumerate(pods):
        p.metadata.uid = f"pod-{i:08d}"
    return nodes, pods


def _overflow_over_wire(side, monkeypatch):
    """``overflow_cluster`` created through the façade, then the engine of
    ``side`` (serial, as ``test_full_roster_overflow_places_as_jax`` runs
    it) behind its own package's ``RemoteClient``: (placements, the pod
    names of each wave, the queue's stats)."""
    objs, hmod, rmod, smod, _ = PKG[side]
    config, service = ((jconfig, jservice) if side == "jax"
                       else (tconfig, tservice))
    engine = (jds if side == "jax" else tds).DeviceScheduler
    monkeypatch.setenv("MINISCHED_PIPELINE", "0")
    module = jds if side == "jax" else tservice
    new = module.new_device_scheduler

    def with_ttl(*args, **kw):
        sched = new(*args, **kw)
        sched.assume_ttl_s = 0.5
        return sched

    monkeypatch.setattr(module, "new_device_scheduler", with_ttl)
    waves = []
    orig = engine.schedule_wave

    def recorded(self, qpis):
        waves.append([q.pod.metadata.name for q in qpis])
        return orig(self, qpis)

    monkeypatch.setattr(engine, "schedule_wave", recorded)
    nodes, pods = overflow_cluster(objs)
    _server, base, shutdown = hmod.start_api_server(smod.ObjectStore())
    try:
        client = rmod.RemoteClient(base)
        client.nodes().create_many(nodes)
        client.pods().create_many(pods)
        svc = service.SchedulerService(rmod.RemoteClient(base))
        kw = {"device": "cpu"} if side == "port" else {}
        sched = svc.start_scheduler(
            config.default_full_roster_config(time_scale=0.01),
            device_mode=True, max_wave=16, **kw)
        try:
            def settled():
                st = sched.queue.stats()
                bound = sum(1 for p in client.pods().list()
                            if p.spec.node_name)
                return (st["active"] == 0 and st["backoff"] == 0
                        and bound + st["unschedulable"] == len(pods))

            _wait(settled, 120.0, f"{side}: every pod bound or parked")
            _wait(lambda: not sched._assumed, 60.0,
                  f"{side}: the assume cache drained")
            assert getattr(sched, "loop_errors", 0) == 0
            placed = {p.metadata.name: p.spec.node_name
                      for p in client.pods().list()}
            return placed, waves, sched.queue.stats()
        finally:
            svc.shutdown_scheduler()
            client.store.close()
    finally:
        shutdown()


def test_full_roster_overflow_over_the_wire_places_as_jax(monkeypatch):
    """Each engine behind its own package's ``RemoteClient`` and façade:
    the same waves, the same node for every pod, the same pods parked."""
    got, got_waves, got_stats = _overflow_over_wire("port", monkeypatch)
    monkeypatch.undo()
    want, want_waves, want_stats = _overflow_over_wire("jax", monkeypatch)
    assert got_waves == want_waves
    assert len(want_waves) >= 4
    assert got == want
    assert got_stats == want_stats
    assert 0 < sum(1 for v in want.values() if v) < len(want)


# -- the wire and wal bench roles, at a small size ----------------------------


def test_wire_role_at_a_small_size(monkeypatch):
    """``bench --only wire``'s body on the CPU twins: 50 nodes and 300
    pods through the device engine behind ``RemoteClient``; gated on
    every pod bound."""
    from minisched_tpu_torch import bench

    monkeypatch.setenv("BENCH_WIRE_NODES", "50")
    monkeypatch.setenv("BENCH_WIRE_PODS", "300")
    rec = bench.role_wire(device="cpu")
    assert rec["pods"] == 300 and rec["loop_errors"] == 0
    assert rec["wire_counters"]["wire.pool_reuse"] > 0


def test_wal_role_at_a_small_size(monkeypatch):
    """``bench.role_wal`` (``--only wal``) on the host: 12 ``RemoteClient`` writers of 5
    pods each over a ``file://`` WAL with fsync on and a 20 ms floor,
    group commit against ``MINISCHED_GROUP_COMMIT=0``; ``bench.py``'s
    gates (coalescing, the 3x speedup, fsck clean, a full replay)."""
    from minisched_tpu_torch import bench

    monkeypatch.setenv("BENCH_WAL_WRITERS", "12")
    monkeypatch.setenv("BENCH_WAL_PODS_PER_WRITER", "5")
    monkeypatch.setenv("BENCH_WAL_FSYNC_FLOOR_US", "20000")
    rec = bench.role_wal()
    assert rec["fsck_clean"]
    assert rec["speedup"] >= 3.0
