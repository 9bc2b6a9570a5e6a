"""The port's fault fabric (``faults/__init__.py``) and network-fault
layer (``faults/net.py``) on the CPU.

The port's copies of JAX's fabric, retry-jitter and store-level tests of
``tests/test_faults.py`` and of
``tests/test_partition_chaos.py::test_net_fabric_rules_channels_and_schedule``,
under JAX's names; then, for the same seeds and the same calls, the
port's ``FaultFabric`` and ``NetFabric`` decide every call as JAX's do
(call for call, fire counts and stats included), and the WAL
double-bind audit now in ``faults`` answers as JAX's.  The injection
points' tests (``watch.drop`` with the informer's reconnect, the
façade's ``http.500``/``http.reset`` under the remote client's retries,
semantic errors never retried, a retried bind idempotent on its own node
through ``remote.request``, ``create_many`` parity across façades) are
JAX's too; and over one fixed call sequence each package's store,
façade and device engine decide every ``watch.drop``, ``http.*`` and
``engine.bind`` call alike, for three seeds.
"""

from __future__ import annotations

import random
import time

import pytest

from minisched_tpu import faults as jfaults
from minisched_tpu.faults import net as jnet

from minisched_tpu_torch import faults as tfaults
from minisched_tpu_torch.api.objects import Binding, make_node, make_pod
from minisched_tpu_torch.controlplane.client import Client
from minisched_tpu_torch.controlplane.durable import DurableObjectStore
from minisched_tpu_torch.controlplane.store import ObjectStore
from minisched_tpu_torch.faults import FaultFabric, InjectedFault
from minisched_tpu_torch.faults import net as tnet
from minisched_tpu_torch.faults.net import NetFabric, NetPartitioned


# -- fabric ----------------------------------------------------------------


def _fire_pattern(seed: int, calls):
    fab = FaultFabric(seed).on("p", rate=0.3)
    return [fab.should_fire("p", key) for key in calls]


def test_fabric_schedule_is_deterministic_for_a_seed():
    calls = [f"k{i % 7}" for i in range(500)]
    a = _fire_pattern(42, calls)
    b = _fire_pattern(42, calls)
    assert a == b, "same seed + same call sequence must fire identically"
    assert any(a), "rate 0.3 over 500 calls must fire"
    assert not all(a)
    c = _fire_pattern(43, calls)
    assert a != c, "a different seed must produce a different schedule"


def test_fabric_decisions_are_per_key_ordinal_not_global():
    """Thread-interleaving independence: the decision for call n at
    (point, key) must not depend on calls at OTHER keys in between."""
    fab1 = FaultFabric(7).on("p", rate=0.5)
    seq1 = [fab1.should_fire("p", "a") for _ in range(50)]
    fab2 = FaultFabric(7).on("p", rate=0.5)
    seq2 = []
    for _ in range(50):
        fab2.should_fire("p", "b")  # interleaved traffic at another key
        seq2.append(fab2.should_fire("p", "a"))
    assert seq1 == seq2


def test_fabric_after_max_fires_and_keys():
    fab = FaultFabric(1).on("p", rate=1.0, after=2, max_fires=3)
    fires = [fab.should_fire("p", "k") for _ in range(10)]
    assert fires == [False, False, True, True, True] + [False] * 5
    assert fab.fires("p") == 3

    fab = FaultFabric(1).on("w", rate=1.0, keys={"Pod"})
    assert not fab.should_fire("w", "Node")
    assert fab.should_fire("w", "Pod")
    assert fab.stats()["calls"]["w"] == 2

    # unarmed points never fire and raise nothing
    fab.check("unarmed", "x")


def test_fabric_check_raises_injected_fault():
    fab = FaultFabric(1).on("p", rate=1.0)
    with pytest.raises(InjectedFault):
        fab.check("p", "k")


# -- retry jitter ----------------------------------------------------------


def test_backoff_delays_jitter_bounds_and_reproducibility():
    import random

    from minisched_tpu_torch.utils.retry import (
        backoff_delays,
        retry_with_exponential_backoff,
    )

    base = list(backoff_delays(0.1, 3.0, 6, jitter=0.0))
    assert base == pytest.approx([0.1, 0.3, 0.9, 2.7, 8.1])  # legacy schedule
    j1 = list(backoff_delays(0.1, 3.0, 6, jitter=0.5, rng=random.Random(9)))
    j2 = list(backoff_delays(0.1, 3.0, 6, jitter=0.5, rng=random.Random(9)))
    assert j1 == j2, "seeded rng makes the jittered schedule reproducible"
    for b, j in zip(base, j1):
        assert b <= j <= b * 1.5, "wait.Jitter semantics: [d, d*(1+jitter)]"

    # the default call shape is byte-exact with the pre-jitter behavior
    slept = []
    attempts = [0]

    def fn():
        attempts[0] += 1
        return attempts[0] >= 3

    retry_with_exponential_backoff(fn, sleep=slept.append)
    assert slept == [0.1, 0.30000000000000004]


# -- store-level injection -------------------------------------------------


def test_store_get_and_list_consult_the_injector():
    store = ObjectStore()
    store.create("Node", make_node("n1"))
    fab = FaultFabric(3).on("store.get", rate=1.0, max_fires=1).on(
        "store.list", rate=1.0, max_fires=1
    )
    store.fault_injector = fab.as_store_injector()
    with pytest.raises(InjectedFault):
        store.get("Node", "", "n1")
    assert store.get("Node", "", "n1").metadata.name == "n1"  # recovered
    with pytest.raises(InjectedFault):
        store.list("Node")
    assert len(store.list("Node")) == 1


def test_wal_append_fault_fails_before_the_inmemory_commit(tmp_path):
    wal = str(tmp_path / "t.wal")
    store = DurableObjectStore(wal)
    fab = FaultFabric(5).on("wal.append", rate=1.0, max_fires=1)
    store.faults = fab
    with pytest.raises(InjectedFault):
        store.create("Node", make_node("n1"))
    # the refused mutation touched NOTHING: no object, no watch event
    assert store.list("Node") == []
    store.create("Node", make_node("n1"))  # next attempt lands
    store.close()
    store2 = DurableObjectStore(wal)
    assert [n.metadata.name for n in store2.list("Node")] == ["n1"]
    store2.close()


def test_net_fabric_rules_channels_and_schedule():
    """The in-process NetFabric contract: directional imposed rules per
    channel, wildcard dst, heal, the delay mode's imposed latency, the
    blackhole mode's capped hang, and the blake2s-scheduled ``net.drop``
    point replaying identically from a seed."""
    net = NetFabric().configure(identity="a")
    net.check("b")  # no rules: every link up
    net.cut("a", "b", channel="arbiter")
    with pytest.raises(NetPartitioned):
        net.check("b", channel="arbiter")
    net.check("b", channel="data")  # other channel untouched
    with pytest.raises(ValueError):
        net.cut("a", "b", mode="sever")
    net.cut("*", "c")  # any local actor -> c, every channel
    with pytest.raises(NetPartitioned):
        net.check("c", src="z")
    assert net.heal("a", "b") is True
    net.check("b", channel="arbiter")
    net.heal_all()

    net.cut("a", "b", mode="delay", delay_s=0.05)
    t0 = time.monotonic()
    net.check("b")  # delayed, then allowed through
    assert time.monotonic() - t0 >= 0.05
    net.heal_all()

    net.cut("a", "b", mode="blackhole")
    t0 = time.monotonic()
    with pytest.raises(NetPartitioned):
        net.check("b", timeout_s=0.1)
    assert 0.1 <= time.monotonic() - t0 < 1.0, "hang must respect timeout"
    net.heal_all()

    def verdicts(seed: int) -> list:
        f = NetFabric().configure(identity="a").flake(rate=0.5, seed=seed)
        out = []
        for _ in range(24):
            try:
                f.check("b")
                out.append(True)
            except NetPartitioned:
                out.append(False)
        return out

    assert verdicts(77) == verdicts(77), "schedule must replay from seed"
    assert False in verdicts(77) and True in verdicts(77)


# -- the port against the JAX package -----------------------------------------

FABRICS = {"jax": jfaults, "port": tfaults}
NETS = {"jax": jnet, "port": tnet}


def _fabric_trace(side, seed):
    """A seeded sequence of calls over several armed points (rates,
    ``after``, ``max_fires``, ``keys``) and one unarmed point: every
    decision, then the fire counts and stats."""
    mod = FABRICS[side]
    fab = (mod.FaultFabric(seed)
           .on("a", rate=0.3)
           .on("b", rate=0.7, after=3, max_fires=9)
           .on("c", rate=1.0, keys={"k1", "k3"}))
    rng = random.Random(seed)
    out = []
    for _ in range(600):
        point = rng.choice("abcz")
        key = f"k{rng.randrange(5)}"
        try:
            fab.check(point, key)
            out.append(False)
        except mod.InjectedFault:
            out.append(True)
    inj = fab.as_store_injector()
    for i in range(50):
        try:
            inj("get", "Pod", f"default/p{i % 4}")
            out.append(False)
        except mod.InjectedFault:
            out.append(True)
    return out, {p: fab.fires(p) for p in "abcz"}, fab.stats()


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_fabric_decisions_equal_jax_call_for_call(seed):
    want = _fabric_trace("jax", seed)
    got = _fabric_trace("port", seed)
    assert got == want
    assert any(want[0]) and not all(want[0])


def _net_trace(side, seed):
    """Scheduled ``net.drop`` verdicts over several links, then imposed
    rules by channel and wildcard, then the describe() document."""
    mod = NETS[side]
    net = mod.NetFabric().configure(identity="r0").flake(rate=0.4,
                                                         seed=seed)
    rng = random.Random(seed)
    out = []
    for _ in range(300):
        dst = f"r{rng.randrange(1, 4)}"
        src = rng.choice(["", "r0", "r9"])
        try:
            net.check(dst, channel=rng.choice(["data", "arbiter"]), src=src)
            out.append(True)
        except mod.NetPartitioned:
            out.append(False)
    net.cut("r0", "r1", channel="arbiter")
    net.cut("*", "r2")
    for dst, channel in (("r1", "arbiter"), ("r1", "data"), ("r2", "data"),
                         ("r2", "arbiter")):
        try:
            net.check(dst, channel=channel)
            out.append((dst, channel, "up"))
        except mod.NetPartitioned as e:
            out.append((dst, channel, str(e)))
    return out, net.describe()


@pytest.mark.parametrize("seed", [3, 77])
def test_net_fabric_decisions_equal_jax_call_for_call(seed):
    want = _net_trace("jax", seed)
    got = _net_trace("port", seed)
    assert got == want
    assert False in want[0] and True in want[0]


def test_wal_double_binds_equal_jax(tmp_path):
    """A WAL with one pod bound to two nodes (written around the bind
    precondition): the port's audit names the same violation as JAX's,
    and a clean WAL none."""
    wal = str(tmp_path / "d.wal")
    store = DurableObjectStore(wal)
    client = Client(store=store)
    client.nodes().create_many([make_node("n1"), make_node("n2")])
    client.pods().create_many([make_pod("p0"), make_pod("p1")])
    client.pods().bind_many([Binding("p0", "default", "n1")])
    assert tfaults.wal_double_binds(wal) == jfaults.wal_double_binds(wal) \
        == []
    moved = store.get("Pod", "default", "p0")
    moved.spec.node_name = "n2"
    store.update("Pod", moved)
    store.close()
    got = tfaults.wal_double_binds(wal)
    assert got == jfaults.wal_double_binds(wal)
    assert got == [(moved.metadata.uid, "n1", "n2")]


# -- the injection points (JAX ``test_faults.py:145-341``) ------------------


def test_watch_drop_kills_stream_and_informer_reconnects_with_diff():
    from minisched_tpu_torch.controlplane.informer import (
        SharedInformerFactory,
    )

    store = ObjectStore()
    fab = FaultFabric(11).on("watch.drop", rate=1.0, max_fires=1,
                             keys={"Node"})
    factory = SharedInformerFactory(store)
    inf = factory.informer_for("Node")
    factory.start()
    assert factory.wait_for_cache_sync(5.0)
    store.faults = fab
    # this event's fanout kills the watch and is lost with it; the
    # reconnect's snapshot replay diff must still deliver the node
    store.create("Node", make_node("n1"))
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if [n.metadata.name for n in inf.lister()] == ["n1"]:
            break
        time.sleep(0.05)
    assert [n.metadata.name for n in inf.lister()] == ["n1"]
    assert inf.reconnects >= 1
    assert fab.fires("watch.drop") == 1
    assert inf.staleness_s() < 5.0  # live again after the replay
    factory.shutdown()


def test_remote_client_retries_through_500s_and_resets():
    from minisched_tpu_torch.controlplane.httpserver import start_api_server
    from minisched_tpu_torch.controlplane.remote import RemoteClient
    from minisched_tpu_torch.observability import counters

    store = ObjectStore()
    fab = (FaultFabric(21).on("http.500", rate=1.0, max_fires=2)
           .on("http.reset", rate=1.0, max_fires=2))
    _server, base, shutdown = start_api_server(store, faults=fab)
    try:
        counters.reset()
        client = RemoteClient(base, retries=6, backoff_initial_s=0.01,
                              retry_seed=1)
        node = client.nodes().create(make_node("n1"))
        assert node.metadata.name == "n1"
        got = client.store.get("Node", "", "n1")
        assert got.metadata.name == "n1"
        assert fab.fires("http.500") + fab.fires("http.reset") >= 2
        assert counters.get("remote.retry") >= 2
    finally:
        shutdown()


def test_remote_client_semantic_errors_do_not_retry():
    from minisched_tpu_torch.controlplane.httpserver import start_api_server
    from minisched_tpu_torch.controlplane.remote import RemoteStore
    from minisched_tpu_torch.observability import counters

    store = ObjectStore()
    _server, base, shutdown = start_api_server(store)
    try:
        counters.reset()
        rstore = RemoteStore(base, retries=3, backoff_initial_s=0.01)
        with pytest.raises(KeyError):
            rstore.get("Node", "", "missing")
        assert counters.get("remote.retry") == 0
    finally:
        shutdown()


def test_remote_bind_retry_is_idempotent_same_node_only():
    """A retried bind whose first attempt landed comes back AlreadyBound
    to the same node: success; AlreadyBound to another node stays a
    conflict."""
    from minisched_tpu_torch.controlplane.client import AlreadyBound
    from minisched_tpu_torch.controlplane.httpserver import start_api_server
    from minisched_tpu_torch.controlplane.remote import RemoteStore

    store = ObjectStore()
    _server, base, shutdown = start_api_server(store)
    try:
        inproc = Client(store)
        inproc.nodes().create(make_node("n1"))
        inproc.pods().create(make_pod("p1"))
        inproc.pods().create(make_pod("p2"))
        # "the first attempt committed, its answer was lost": the pod is
        # bound already, and the client's fabric fails attempt 0, so the
        # request the server sees is a retry
        inproc.pods().bind(Binding("p1", "default", "n1"))
        inproc.pods().bind(Binding("p2", "default", "n1"))
        fab = FaultFabric(31).on("remote.request", rate=1.0, max_fires=1)
        rstore = RemoteStore(base, retries=3, backoff_initial_s=0.01,
                             faults=fab)
        [res] = rstore.bind_many_remote([Binding("p1", "default", "n1")])
        assert res is None, "same-node AlreadyBound after a retry is ours"
        fab2 = FaultFabric(32).on("remote.request", rate=1.0, max_fires=1)
        rstore2 = RemoteStore(base, retries=3, backoff_initial_s=0.01,
                              faults=fab2)
        [res2] = rstore2.bind_many_remote(
            [Binding("p2", "default", "nOTHER")])
        assert isinstance(res2, AlreadyBound)
    finally:
        shutdown()


def _seed_conflict_batch(pods_api):
    pods = [make_pod("a"), make_pod("a"), make_pod("b")]
    with pytest.raises(KeyError):
        pods_api.create_many(pods)


def test_create_many_partial_failure_parity_across_facades():
    """Both façades create every independent item and raise the first
    per-item conflict."""
    from minisched_tpu_torch.controlplane.httpserver import start_api_server
    from minisched_tpu_torch.controlplane.remote import RemoteClient

    inproc_store = ObjectStore()
    _seed_conflict_batch(Client(inproc_store).pods())
    inproc_names = sorted(p.metadata.name for p in inproc_store.list("Pod"))
    remote_store = ObjectStore()
    _server, base, shutdown = start_api_server(remote_store)
    try:
        _seed_conflict_batch(RemoteClient(base).pods())
    finally:
        shutdown()
    remote_names = sorted(p.metadata.name for p in remote_store.list("Pod"))
    assert inproc_names == remote_names == ["a", "b"]


def test_informer_resumes_from_last_rv_after_drop():
    """A dropped stream reconnects by resuming from the informer's last
    rv: the missed tail (the event the drop swallowed included) is
    replayed from history, with no relist."""
    from minisched_tpu_torch.controlplane.informer import (
        SharedInformerFactory,
    )
    from minisched_tpu_torch.observability import counters

    store = ObjectStore()
    fab = FaultFabric(11).on("watch.drop", rate=1.0, max_fires=1,
                             keys={"Node"})
    factory = SharedInformerFactory(store)
    inf = factory.informer_for("Node")
    factory.start()
    assert factory.wait_for_cache_sync(5.0)
    store.create("Node", make_node("n0"))  # seen live: sets the cursor
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not inf.lister():
        time.sleep(0.02)
    counters.reset()
    store.faults = fab
    store.create("Node", make_node("n1"))
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if {n.metadata.name for n in inf.lister()} == {"n0", "n1"}:
            break
        time.sleep(0.05)
    assert {n.metadata.name for n in inf.lister()} == {"n0", "n1"}
    assert inf.reconnects >= 1
    assert inf.resumes >= 1
    assert counters.get("informer.resume") >= 1
    factory.shutdown()


def test_informer_relists_on_compacted_history_without_dropping_events():
    """A resume whose rv was compacted away gets 410 and the informer
    relists, converging on the whole post-outage state."""
    from minisched_tpu_torch.controlplane.informer import (
        SharedInformerFactory,
    )
    from minisched_tpu_torch.observability import counters

    store = ObjectStore()
    fab = FaultFabric(13).on("watch.drop", rate=1.0, max_fires=1,
                             keys={"Node"})
    factory = SharedInformerFactory(store)
    inf = factory.informer_for("Node")
    factory.start()
    assert factory.wait_for_cache_sync(5.0)
    store.create("Node", make_node("n0"))
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not inf.lister():
        time.sleep(0.02)
    counters.reset()
    # the floor is raised before the stream dies, so the verdict is
    # deterministic (410), not a race with the ring's overflow
    store.set_history_floor(store.resource_version + 1)
    store.faults = fab
    store.create("Node", make_node("n1"))
    store.faults = None
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if {n.metadata.name for n in inf.lister()} == {"n0", "n1"}:
            break
        time.sleep(0.05)
    assert {n.metadata.name for n in inf.lister()} == {"n0", "n1"}
    assert counters.get("informer.relist_on_410") >= 1
    assert inf.reconnects >= 1
    factory.shutdown()


# -- the points decide as JAX's, call for call ------------------------------


def _recording(mod):
    """A FaultFabric of ``mod`` that records every (point, key, verdict)."""

    class Recording(mod.FaultFabric):
        def __init__(self, seed):
            super().__init__(seed)
            self.log = []

        def should_fire(self, point, key=""):
            fired = super().should_fire(point, key)
            self.log.append((point, key, fired))
            return fired

    return Recording


def _watch_drop_trace(side, seed):
    """One fixed sequence of writes (single and batched) on a store with
    three Pod and two Node watches: after each write, which watches are
    dead; and every ``watch.drop`` draw."""
    if side == "jax":
        from minisched_tpu import faults as mod
        from minisched_tpu.api import objects as objs
        from minisched_tpu.controlplane.store import ObjectStore as Store
    else:
        from minisched_tpu_torch import faults as mod
        from minisched_tpu_torch.api import objects as objs
        Store = ObjectStore
    store = Store()
    fab = _recording(mod)(seed).on("watch.drop", rate=0.3,
                                   keys={"Pod", "Node"})
    store.faults = fab
    watches = []
    for kind in ("Pod", "Pod", "Node", "Pod", "Node"):
        got = store.watch(kind)
        watches.append(got[0] if isinstance(got, tuple) else got)
    out = []
    for i in range(30):
        if i % 5 == 0:
            store.create("Node", objs.make_node(f"n{i}"))
        elif i % 5 == 1:
            store.create_many("Pod", [objs.make_pod(f"b{i}-{j}")
                                      for j in range(3)])
        elif i % 5 == 2:
            pod = store.get("Pod", "default", f"b{i - 1}-0")
            pod.metadata.labels = {"step": str(i)}
            store.update("Pod", pod)
        elif i % 5 == 3:
            store.delete("Pod", "default", f"b{i - 2}-1")
        else:
            store.create("Pod", objs.make_pod(f"p{i}"))
        out.append([w.stopped for w in watches])
    return out, fab.log, fab.stats()


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_watch_drop_decisions_equal_jax_call_for_call(seed):
    want = _watch_drop_trace("jax", seed)
    got = _watch_drop_trace("port", seed)
    assert got == want
    assert want[2]["fires"].get("watch.drop", 0) >= 1


#: (verb, path) of the façades' fault trace; /healthz is exempt
_HTTP_CALLS = [("GET", "/healthz"), ("GET", "/api/v1/nodes"),
               ("GET", "/api/v1/namespaces/default/pods"),
               ("POST", "/api/v1/nodes"), ("PUT", "/api/v1/nodes/x"),
               ("DELETE", "/api/v1/namespaces/default/pods/x"),
               ("GET", "/api/v1/nodes/x"), ("POST", "/api/v1/bindings")]


def _http_trace(side, seed):
    """A fixed sequence of requests, each on a fresh connection: reset (no
    byte answered), the injected 503, or routed; and every draw."""
    import http.client

    if side == "jax":
        from minisched_tpu import faults as mod
        from minisched_tpu.controlplane.httpserver import start_api_server
        from minisched_tpu.controlplane.store import ObjectStore as Store
    else:
        from minisched_tpu_torch import faults as mod
        from minisched_tpu_torch.controlplane.httpserver import (
            start_api_server,
        )
        Store = ObjectStore
    fab = (_recording(mod)(seed).on("http.500", rate=0.25)
           .on("http.reset", rate=0.2))
    _server, base, shutdown = start_api_server(Store(), faults=fab)
    host, port = base.split("//")[1].split(":")
    out = []
    try:
        for i in range(60):
            verb, path = _HTTP_CALLS[i % len(_HTTP_CALLS)]
            conn = http.client.HTTPConnection(host, int(port), timeout=10)
            try:
                conn.request(verb, path, body=b"{}" if verb in ("POST", "PUT")
                             else None,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read()
                injected = (resp.status == 503
                            and b"injected" in body)
                out.append("503" if injected else "routed")
            except (ConnectionError, http.client.HTTPException, OSError):
                out.append("reset")
            finally:
                conn.close()
    finally:
        shutdown()
    return out, fab.log, fab.stats()


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_http_fault_decisions_equal_jax_call_for_call(seed):
    want = _http_trace("jax", seed)
    got = _http_trace("port", seed)
    assert got == want
    assert {"503", "reset", "routed"} <= set(want[0])
    # /healthz is never drawn
    assert not any(key == "/healthz" for _p, key, _f in want[1])


def _engine_bind_trace(side, seeds, monkeypatch):
    """The serial device engine of ``side`` on one small cluster: for
    each seed in turn, 40 pods arrive with ``engine.bind`` armed by a
    fabric of that seed and are driven until bound.  Every draw (keyed by
    the batch's size) with its verdict, and where each pod ended."""
    from tests.test_torch_engine import SIDES, wait_for

    objs, config, ClientCls, Service, _Engine = SIDES[side]
    if side == "jax":
        from minisched_tpu import faults as mod
    else:
        mod = tfaults
    monkeypatch.setenv("MINISCHED_PIPELINE", "0")
    client = ClientCls()
    client.nodes().create_many([
        objs.make_node(f"node{i}", capacity={"cpu": "64", "memory": "64Gi",
                                             "pods": 110})
        for i in range(6)])
    cfg = config.default_full_roster_config()
    # short backoffs: a refused batch's pods come back within the test
    cfg.queue_opts = {"initial_backoff_s": 0.05, "max_backoff_s": 0.2}
    svc = Service(client)
    kw = {"device": "cpu"} if side == "port" else {}
    sched = svc.start_scheduler(cfg, device_mode=True, max_wave=8, **kw)
    out = []
    try:
        sched.assume_ttl_s = 1.0
        for seed in seeds:
            fab = _recording(mod)(seed).on("engine.bind", rate=0.4,
                                           max_fires=5)
            sched.faults = fab
            pods = [objs.make_pod(f"s{seed}-{i:03d}",
                                  requests={"cpu": "500m"})
                    for i in range(40)]
            for p in pods:
                p.metadata.uid = f"uid-{p.metadata.name}"
            client.pods().create_many(pods)

            def all_bound():
                if sched.queue.stats()["unschedulable"]:
                    sched.queue.flush_unschedulable_leftover()
                    sched.queue.flush_backoff_completed()
                return all(p.spec.node_name for p in client.pods().list())

            assert wait_for(all_bound, 120)
            out.append((fab.log, fab.stats()["fires"]))
    finally:
        svc.shutdown_scheduler()
    return out, sorted((p.metadata.name, p.spec.node_name)
                       for p in client.pods().list())


def test_engine_bind_decisions_equal_jax_call_for_call(monkeypatch):
    """Both engines refuse the same bind batches: for each of three
    seeds the same draws (one a wave, keyed by its size) with the same
    verdicts, every run converging anyway, and every pod on the same
    node."""
    seeds = (0, 7, 1234)
    want = _engine_bind_trace("jax", seeds, monkeypatch)
    got = _engine_bind_trace("port", seeds, monkeypatch)
    assert got == want
    assert all(fires.get("engine.bind", 0) >= 1 for _log, fires in want[0])
