"""The port's in-process control plane against the JAX package's.

``minisched_tpu_torch/controlplane/{store,client,informer}.py`` are copies
of the in-process core of ``minisched_tpu/controlplane/``.  The same
scripted create / update / delete / bind sequence, with objects built
from one seed once with each package's objects, must give the same watch
event sequence (types, keys, resource versions) and the same outcomes
(the bound node, or the exception type: ``AlreadyBound``,
``OutOfCapacity``, ``Conflict``, ``KeyError``); the per-node aggregates
must equal the JAX ``compute_node_agg``.  Comparisons are exact.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from minisched_tpu.api import objects as jobj
from minisched_tpu.controlplane import client as jclient
from minisched_tpu.controlplane import store as jstore
from minisched_tpu.controlplane.informer import (
    ResourceEventHandlers as JHandlers,
    SharedInformerFactory as JFactory,
)

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.controlplane import client as tclient
from minisched_tpu_torch.controlplane import store as tstore
from minisched_tpu_torch.controlplane.informer import (
    ResourceEventHandlers as THandlers,
    SharedInformerFactory as TFactory,
)

SIDES = {
    "jax": (jobj, jclient, jstore),
    "port": (tobj, tclient, tstore),
}


def wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


def _outcome(fn):
    """The result of ``fn()`` as comparable data: the value, or the
    exception's type name."""
    try:
        return ("ok", fn())
    except Exception as err:  # the type is the outcome compared
        return ("raise", type(err).__name__)


def _bind_outcomes(results):
    return [type(r).__name__ if isinstance(r, BaseException)
            else r.spec.node_name for r in results]


def scripted_run(side: str, seed: int):
    """One control-plane script, driven through ``side``'s client: the
    watch events seen (type, key, rv) per kind, every call's outcome, the
    final per-node aggregates and the bound pods."""
    objs, client_mod, store_mod = SIDES[side]
    rng = np.random.default_rng(seed)
    client = client_mod.Client()
    store = client.store
    pod_watch, _ = store.watch("Pod", send_initial=True)
    node_watch, _ = store.watch("Node", send_initial=True)
    out = []
    n_nodes = 6
    nodes = [objs.make_node(f"n{i}", capacity={
        "cpu": str(int(rng.integers(1, 4))), "memory": "4Gi",
        "pods": int(rng.integers(2, 5))}) for i in range(n_nodes)]
    out.append(_outcome(lambda: len(client.nodes().create_many(nodes))))
    # a second create of an existing node: KeyError, nothing fanned out
    out.append(_outcome(lambda: client.nodes().create(
        objs.make_node("n0")).metadata.name))
    pods = []
    for i in range(24):
        p = objs.make_pod(f"p{i:02d}", requests={
            "cpu": f"{int(rng.choice([250, 500, 1000]))}m",
            "memory": f"{int(rng.choice([256, 512, 1024]))}Mi"})
        p.metadata.uid = f"pod-{i:08d}"
        pods.append(p)
    out.append(_outcome(lambda: len(client.pods().create_many(pods[:16]))))
    for p in pods[16:]:
        out.append(_outcome(lambda p=p: client.pods().create(p).metadata.uid))
    # binds: random targets (some overflow → OutOfCapacity), a rebind
    # (AlreadyBound), a stale expected_rv (Conflict), a missing pod
    for _ in range(3):
        picks = rng.choice(24, size=10, replace=False)
        bindings = [objs.Binding(f"p{int(i):02d}", "default",
                                 f"n{int(rng.integers(n_nodes))}")
                    for i in picks]
        out.append(("bind_many",
                    _bind_outcomes(client.pods().bind_many(bindings))))
    cur = client.pods().get("p20")
    out.append(_outcome(lambda: client.pods().bind(objs.Binding(
        "p20", "default", "n1",
        expected_rv=cur.metadata.resource_version - 1)).spec.node_name))
    out.append(_outcome(lambda: client.pods().bind(objs.Binding(
        "nope", "default", "n1")).spec.node_name))
    # updates: a label change, a stale-rv update, a mutate, deletes
    node = client.nodes().get("n2")
    node.metadata.labels["special"] = "true"
    out.append(_outcome(lambda: client.nodes().update(node)
                        .metadata.resource_version))
    out.append(_outcome(lambda: store.update(
        "Node", node, expected_rv=node.metadata.resource_version)))

    def relabel(p):
        p.metadata.labels["touched"] = "yes"
        return p

    out.append(_outcome(lambda: client.pods().mutate("p03", relabel)
                        .metadata.labels["touched"]))
    for name in ("p01", "p05", "p07"):
        out.append(_outcome(lambda name=name: client.pods().delete(name)))
    out.append(_outcome(lambda: client.pods().delete("p01")))
    out.append(_outcome(lambda: client.nodes().delete("n5")))
    out.append(("rv", store.resource_version))
    events = {}
    for kind, w in (("Pod", pod_watch), ("Node", node_watch)):
        events[kind] = [(ev.type.value, ev.obj.metadata.key, ev.rv)
                        for ev in w.next_batch(timeout=1.0)]
        w.stop()
    listed = client.pods().list()
    bound = {p.metadata.name: p.spec.node_name for p in listed
             if p.spec.node_name}
    agg = {k: list(v) for k, v in store._pod_node_agg.items()}
    return out, events, agg, bound, listed


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_sequence_matches_jax_store(seed):
    j_out, j_events, j_agg, j_bound, j_listed = scripted_run("jax", seed)
    t_out, t_events, t_agg, t_bound, t_listed = scripted_run("port", seed)
    assert t_out == j_out
    assert t_events == j_events
    assert t_bound == j_bound
    assert any(isinstance(o, tuple) and o[0] == "bind_many"
               and "OutOfCapacity" in o[1] for o in t_out)
    assert ("raise", "AlreadyBound") in t_out or any(
        o[0] == "bind_many" and "AlreadyBound" in o[1] for o in t_out)
    assert ("raise", "Conflict") in t_out
    # the incremental aggregates equal the JAX recompute on either side
    assert t_agg == j_agg == jstore.compute_node_agg(j_listed)
    assert tstore.compute_node_agg(t_listed) == t_agg


def test_reads_are_copies_and_stored_objects_never_change():
    client = tclient.Client()
    client.nodes().create(tobj.make_node("n0"))
    pod = tobj.make_pod("p", requests={"cpu": "1"})
    created = client.pods().create(pod)
    # one uid sequence per store, across kinds (the node took 1)
    assert created.metadata.uid == "pod-00000002"
    assert created.metadata.resource_version == 2
    got = client.pods().get("p")
    got.spec.containers[0].requests.milli_cpu = 99
    got.metadata.labels["x"] = "y"
    again = client.pods().get("p")
    assert again.resource_requests().milli_cpu == 1000
    assert again.metadata.labels == {}
    w, snap = client.store.watch("Pod")
    stored = w.next(timeout=1.0).obj
    bound = client.pods().bind(tobj.Binding("p", "default", "n0"))
    assert bound.spec.node_name == "n0" and bound.status.phase == "Running"
    assert stored.spec.node_name == "" and snap[0].spec.node_name == ""
    ev = w.next(timeout=1.0)
    assert ev.type == tstore.EventType.MODIFIED
    assert ev.old_obj is stored and ev.obj.spec.node_name == "n0"
    # the bind shares every sub-object it does not change
    assert ev.obj.spec.containers is stored.spec.containers
    w.stop()
    assert client.store.list_with_rv("Pod")[1] == 3


def test_create_many_raises_the_first_conflict_after_creating_the_rest():
    for objs, client_mod in ((jobj, jclient), (tobj, tclient)):
        client = client_mod.Client()
        client.pods().create(objs.make_pod("b"))
        with pytest.raises(KeyError):
            client.pods().create_many([objs.make_pod(n) for n in "abc"])
        assert sorted(p.metadata.name for p in client.pods().list()) == [
            "a", "b", "c"]


def _informer_log(side: str):
    """Handler calls seen by two informers of ``side``: one registered
    before start, one after the cache synced (it gets the cache replayed
    as adds)."""
    objs, client_mod, _ = SIDES[side]
    Factory, Handlers = (JFactory, JHandlers) if side == "jax" else (
        TFactory, THandlers)
    client = client_mod.Client()
    client.nodes().create_many([objs.make_node(f"n{i}") for i in range(3)])
    factory = Factory(client.store)
    log, late, batches = [], [], []
    lock = threading.Lock()

    def rec(into, tag):
        def fn(*objs_):
            with lock:
                into.append((tag,) + tuple(
                    o.metadata.name if o is not None else None
                    for o in objs_))
        return fn

    inf = factory.informer_for("Node")
    inf.add_event_handlers(Handlers(
        on_add=rec(log, "add"), on_update=rec(log, "update"),
        on_delete=rec(log, "delete"),
        filter=lambda n: n.metadata.name != "n1"))
    factory.informer_for("Pod").add_event_handlers(Handlers(
        on_batch=lambda evs: batches.append(
            [(e.type.value, e.obj.metadata.name) for e in evs])))
    factory.start()
    assert factory.wait_for_cache_sync(timeout=10.0)
    assert wait_for(lambda: len(log) == 2)
    inf.add_event_handlers(Handlers(on_add=rec(late, "add")))
    assert wait_for(lambda: len(late) == 3)
    node = client.nodes().get("n2")
    node.metadata.labels["a"] = "b"
    client.nodes().update(node)
    client.nodes().delete("n0")
    client.nodes().create(objs.make_node("n9"))
    client.pods().create(objs.make_pod("p0"))
    client.pods().bind(objs.Binding("p0", "default", "n2"))
    assert wait_for(lambda: len(log) == 5)
    assert wait_for(lambda: sum(len(b) for b in batches) == 2)
    state = (sorted(n.metadata.name for n in inf.lister()),
             [o.metadata.name if o else None
              for o in inf.get_many(["/n2", "/n0", "/n9"])])
    factory.shutdown()
    return log, sorted(late), [e for b in batches for e in b], state


def test_informer_dispatch_matches_jax():
    assert _informer_log("port") == _informer_log("jax")


def test_paused_dispatch_holds_events_until_resumed():
    client = tclient.Client()
    factory = TFactory(client.store)
    seen = []
    factory.informer_for("Pod").add_event_handlers(
        THandlers(on_add=lambda p: seen.append(p.metadata.name)))
    factory.start()
    assert factory.wait_for_cache_sync(timeout=5.0)
    factory.pause_dispatch()
    client.pods().create(tobj.make_pod("held"))
    time.sleep(0.3)
    assert seen == []
    factory.resume_dispatch()
    assert wait_for(lambda: seen == ["held"])
    factory.shutdown()


def test_event_recorder_writes_bounded_events_into_the_store():
    client = tclient.Client()
    rec = tclient.EventRecorder(store=client.store, max_events=3)
    pod = tobj.make_pod("p")
    for i in range(5):
        rec.eventf(pod, "Normal", "Scheduled", f"m{i}")
    rec.close()
    stored = client.store.list("Event")
    assert [e.message for e in stored] == ["m2", "m3", "m4"]
    assert all(e.regarding == "default/p" for e in stored)
    assert [e["message"] for e in rec.events] == ["m2", "m3", "m4"]
