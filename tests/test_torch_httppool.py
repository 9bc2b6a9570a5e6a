"""The port's pooled keep-alive transport (``controlplane/httppool.py``),
on the CPU: the cases of ``tests/test_httppool.py`` against the port's
façade — connection reuse, the retry-safe reopen of a stale socket, no
response bleed across 409, 410 and 507 on one pooled socket, the shared
per-endpoint pool and the bind-replay dedup of ``HTTPClient``, and the
pool under the façade's injected ``http.reset``.  The stale socket is
made by SIGKILLing a ``faults.proc.ServerSupervisor`` façade child and
restarting it on its port (JAX's copy injects ``http.500``, which
closes the socket after answering).
"""

from __future__ import annotations

import time

import pytest

from minisched_tpu_torch.api.objects import Binding, make_node, make_pod
from minisched_tpu_torch.controlplane.client import AlreadyBound
from minisched_tpu_torch.controlplane.httppool import HTTPConnectionPool
from minisched_tpu_torch.controlplane.httpserver import start_api_server
from minisched_tpu_torch.controlplane.remote import RemoteClient
from minisched_tpu_torch.controlplane.store import (
    Conflict,
    HistoryCompacted,
    ObjectStore,
    StorageDegraded,
)
from minisched_tpu_torch.observability import counters


@pytest.fixture()
def api():
    store = ObjectStore()
    server, base, shutdown = start_api_server(store)
    try:
        yield store, base
    finally:
        shutdown()


def test_pool_reuses_one_socket_across_requests(api):
    _store, base = api
    pool = HTTPConnectionPool(base)
    open0 = counters.get("wire.pool_open")
    reuse0 = counters.get("wire.pool_reuse")
    for _ in range(5):
        status, body, replayed = pool.request("GET", "/healthz")
        assert status == 200 and not replayed
    # one connect, four warm reuses — the keep-alive claim
    assert counters.get("wire.pool_open") == open0 + 1
    assert counters.get("wire.pool_reuse") == reuse0 + 4
    assert pool.idle_count() == 1
    pool.close()
    assert pool.idle_count() == 0


def test_pooled_connection_survives_409_conflict_no_bleed(api):
    """A 409 (AlreadyBound / stale-rv Conflict / duplicate create) is a
    fully-read keep-alive response: the SAME connection must serve the
    next request and every response must match ITS request."""
    _store, base = api
    client = RemoteClient(base, retries=0)
    client.nodes().create(make_node("n1"))
    client.pods().create(make_pod("p1"))
    open_before = counters.get("wire.pool_open")

    # duplicate create → KeyError(409); the pod bind → success; a second
    # bind → AlreadyBound(409); a stale PUT → Conflict(409) — then a GET
    # whose body must be the GET's, not a stale 409 body
    with pytest.raises(KeyError):
        client.pods().create(make_pod("p1"))
    [bound] = client.pods().bind_many([Binding("p1", "default", "n1")])
    assert bound.spec.node_name == "n1"
    [again] = client.pods().bind_many([Binding("p1", "default", "n1")])
    assert isinstance(again, AlreadyBound)
    cur = client.pods().get("p1")
    cur.metadata.labels["x"] = "y"
    with pytest.raises(Conflict):
        client.store.update("Pod", cur, expected_rv=1)
    got = client.pods().get("p1")
    assert got.metadata.name == "p1" and got.spec.node_name == "n1"
    # the whole conversation stayed on pooled sockets: no per-call opens
    assert counters.get("wire.pool_open") <= open_before + 1


def test_pooled_connection_survives_410_gone_no_bleed(api):
    """A watch resume below the history floor answers 410 on a DEDICATED
    stream connection (HistoryCompacted), while the pool's request
    sockets keep serving — and a resume retried through the pool's
    request path cannot read the 410 stream's bytes."""
    store, base = api
    small = ObjectStore(history_events=2)
    server2, base2, shutdown2 = start_api_server(small)
    try:
        client = RemoteClient(base2, retries=0)
        for i in range(6):
            client.pods().create(make_pod(f"p{i}"))
        with pytest.raises(HistoryCompacted):
            client.store.watch("Pod", resume_rv=1)
        # request traffic after the 410 stream: correct, no bleed
        assert len(client.pods().list()) == 6
        # a resume inside the ring works on a fresh stream conn
        w, snap = client.store.watch("Pod", resume_rv=small.resource_version)
        assert snap == []
        w.stop()
        assert len(client.pods().list()) == 6
    finally:
        shutdown2()


def test_pooled_connection_survives_507_degraded_no_bleed(api):
    """507 StorageDegraded is retried with backoff and surfaces TYPED;
    the pooled socket that carried the 507 keeps serving the recovery
    traffic once the store re-arms."""
    store, base = api
    client = RemoteClient(base, retries=1, backoff_initial_s=0.01)
    client.pods().create(make_pod("ok0"))

    real_create = store.create
    calls = {"n": 0}

    def degraded_create(kind, obj):
        calls["n"] += 1
        raise StorageDegraded("disk full (test)")

    store.create = degraded_create
    try:
        with pytest.raises(StorageDegraded):
            client.pods().create(make_pod("p-degraded"))
        assert calls["n"] == 2  # 507 stayed in the backoff set
    finally:
        store.create = real_create
    # same pool, post-recovery: the next create and a read both land
    client.pods().create(make_pod("ok1"))
    assert {p.metadata.name for p in client.pods().list()} == {"ok0", "ok1"}
    assert counters.get("storage.remote_degraded_retry") >= 1


def test_pool_reopens_stale_socket_after_server_side_close(tmp_path):
    """A façade restarted on its port leaves dead sockets on the idle
    stack; the next request notices at send or read time and replays
    once on a fresh connection (``wire.pool_stale_retry``) instead of
    failing.  The façade is a child over a WAL, SIGKILLed and started
    again (JAX's copy closes the socket with an injected ``http.500``;
    a restart kills every kept-alive socket)."""
    from minisched_tpu_torch.faults.proc import ServerSupervisor

    child = ServerSupervisor(str(tmp_path / "pool.wal"))
    try:
        base = child.start()
        client = RemoteClient(base, retries=2, backoff_initial_s=0.01)
        client.nodes().create(make_node("warm"))
        assert client.store._pool.idle_count() >= 1
        child.kill_and_restart()
        stale0 = counters.get("wire.pool_stale_retry")
        for i in range(3):
            client.nodes().create(make_node(f"n{i}"))
        assert {n.metadata.name for n in client.nodes().list()} == {
            "warm", "n0", "n1", "n2"
        }
        assert counters.get("wire.pool_stale_retry") >= stale0 + 1
        client.store.close()
    finally:
        if child.alive():
            assert child.terminate() == 0
        child.stop()


def test_stale_replay_goes_fresh_not_next_corpse(api):
    """The single-replay contract: a stale REUSED socket's replay rides
    a provably-FRESH connection, never the next idle socket — after a
    server restart leaves N corpses pooled, one request costs ONE stale
    retry, not N (regression: `reused = False` before a `continue` that
    re-entered _checkout was dead code)."""
    import http.client
    import socket

    _store, base = api
    pool = HTTPConnectionPool(base, max_idle=4)

    def dead_conn():
        # a connection whose peer is already gone: first use raises
        lst = socket.socket()
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)
        c = http.client.HTTPConnection(*lst.getsockname(), timeout=5.0)
        c.connect()
        srv, _ = lst.accept()
        srv.close()
        lst.close()
        return c

    pool._idle[:] = [dead_conn(), dead_conn()]  # LIFO: corpses on top
    stale0 = counters.get("wire.pool_stale_retry")
    status, _body, replayed = pool.request("GET", "/healthz")
    assert status == 200
    assert replayed  # the caller can tell a retransmission happened
    # one corpse popped, ONE replay on a fresh conn — the second corpse
    # stays for a later request, it must not be consumed by this one
    assert counters.get("wire.pool_stale_retry") == stale0 + 1
    status, _body, replayed = pool.request("GET", "/healthz")  # fresh one
    assert status == 200 and not replayed
    assert counters.get("wire.pool_stale_retry") == stale0 + 1
    pool.close()


def test_stale_replay_counts_as_req_attempt(api):
    """The pool's internal replay IS a retransmission: _req_ex must fold
    it into the attempts it reports, or bind_many_remote's
    AlreadyBound-to-our-node dedup (`attempts > 0`) would report the
    caller's own committed bind as an error after a mid-response socket
    death (regression: the urlopen transport surfaced such resets to
    the outer retry loop, the pool hides them)."""
    _store, base = api
    client = RemoteClient(base, retries=0)
    store = client.store

    class ReplayingPool:
        def __init__(self, inner):
            self._inner = inner

        def request(self, method, path, body=None, headers=None):
            status, data, _ = self._inner.request(
                method, path, body=body, headers=headers
            )
            return status, data, True  # pretend a stale replay ran

    store._pool = ReplayingPool(store._pool)
    _out, attempts = store._req_ex("GET", "/healthz")
    assert attempts >= 1


def test_httpclient_bind_replay_dedup(api):
    """HTTPClient.bind: an AlreadyBound-to-our-node answering a pool
    RETRANSMISSION converts to success (the first attempt committed
    before its socket died) — mirroring bind_many_remote's dedup.  A
    non-replayed AlreadyBound stays an error."""
    from minisched_tpu_torch.controlplane.httpserver import HTTPClient

    _store, base = api
    http = HTTPClient(base)
    http.nodes().create(make_node("n1"))
    http.pods().create(make_pod("p1"))
    inner = http._pool

    class DoubleSend:
        """Simulates commit-then-lost-response: the bind POST executes
        twice and the SECOND response returns with replayed=True."""

        def request(self, method, path, body=None, headers=None):
            if path.endswith("/binding"):
                inner.request(method, path, body=body, headers=headers)
                status, raw, _ = inner.request(
                    method, path, body=body, headers=headers
                )
                return status, raw, True
            return inner.request(method, path, body=body, headers=headers)

    http._pool = DoubleSend()
    bound = http.pods().bind(Binding("p1", "default", "n1"))
    assert bound.spec.node_name == "n1"  # own bind recognized, not 409
    http._pool = inner
    # a GENUINE AlreadyBound (no replay) still raises
    with pytest.raises(AlreadyBound):
        http.pods().bind(Binding("p1", "default", "n1"))
    http.close()
    assert inner.idle_count() == 0


def test_pool_composes_with_http_reset_fault_retries(api):
    """``http.reset`` closes the connection before a single response
    byte: the pool surfaces the transport error (fresh connections) or
    retries once (stale), and the remote store's jittered retries
    converge, every later response matching its own request."""
    from minisched_tpu_torch.faults import FaultFabric

    fabric = FaultFabric(seed=11).on("http.reset", rate=0.4, max_fires=6)
    server, base, shutdown = start_api_server(faults=fabric)
    try:
        client = RemoteClient(base, retries=6, backoff_initial_s=0.01,
                              retry_seed=1)
        for i in range(12):
            client.pods().create(make_pod(f"r{i}"))
        assert fabric.fires("http.reset") >= 1
        pods = {p.metadata.name for p in client.pods().list()}
        assert pods == {f"r{i}" for i in range(12)}
        # interleaved verbs on the same pool: each response is its own
        got = client.pods().get("r3")
        assert got.metadata.name == "r3"
        client.pods().delete("r3")
        with pytest.raises(KeyError):
            client.pods().get("r3")
    finally:
        shutdown()


def test_shared_pool_one_endpoint_one_pool(api):
    """RemoteStore and
    HTTPClient facades at the same endpoint share ONE pool — the second
    client's first request checks out the socket the first client
    warmed (wire.pool_reuse), instead of opening its own."""
    from minisched_tpu_torch.controlplane.httpserver import HTTPClient

    _store, base = api
    client = RemoteClient(base, retries=0)
    http = HTTPClient(base)
    assert client.store._pool is http._pool  # literally the same object
    open0 = counters.get("wire.pool_open")
    reuse0 = counters.get("wire.pool_reuse")
    client.nodes().create(make_node("shared-n1"))
    got = http.nodes().list()
    assert [n.metadata.name for n in got] == ["shared-n1"]
    # cross-facade reuse: the HTTPClient call rode the RemoteStore's
    # warm socket — one open total, at least one reuse
    assert counters.get("wire.pool_open") == open0 + 1
    assert counters.get("wire.pool_reuse") >= reuse0 + 1
    # refcounted close: the first sharer leaving drops idles but keeps
    # the pool open for the survivor...
    client.store.close()
    assert not http._pool._closed
    status, _body, _r = http._pool.request("GET", "/healthz")
    assert status == 200
    # ...and the LAST close latches it and leaves the shared registry
    http.close()
    assert http._pool._closed
    from minisched_tpu_torch.controlplane import httppool

    assert http._pool not in httppool._SHARED.values()


def test_shared_pool_keyed_by_timeout(api):
    """Sockets bake their timeout at connect, so a 5s client must not
    share with a 30s one — the registry keys on (host, port, timeout)."""
    from minisched_tpu_torch.controlplane.httppool import shared_pool

    _store, base = api
    a = shared_pool(base, timeout_s=30.0)
    b = shared_pool(base, timeout_s=30.0)
    c = shared_pool(base, timeout_s=5.0)
    try:
        assert a is b and a is not c
        # max_idle ratchets UP across sharers, never down
        d = shared_pool(base, max_idle=8, timeout_s=30.0)
        assert d is a and a._max_idle == 8
        e = shared_pool(base, max_idle=2, timeout_s=30.0)
        assert e is a and a._max_idle == 8
    finally:
        for _ in range(4):
            a.close()
        c.close()
    assert a._closed and c._closed


def test_direct_pool_close_unchanged(api):
    """A pool built directly (no shared_pool) still closes on the FIRST
    close() — the refcount only engages for registry-handed pools."""
    _store, base = api
    pool = HTTPConnectionPool(base)
    status, _b, _r = pool.request("GET", "/healthz")
    assert status == 200
    pool.close()
    assert pool._closed and pool.idle_count() == 0


def test_watch_read_timeout_is_configurable(api):
    """The stream read timeout  comes
    from RemoteStore(watch_read_timeout_s=): a server gone silent past
    it kills the stream onto the reconnect path instead of pinning the
    reader for an hour.  (The server keepalives every 0.5s, so a LIVE
    stream at a 0.2s timeout only survives if reads actually time out —
    proving the knob reaches the socket.)"""
    _store, base = api
    client = RemoteClient(base, watch_read_timeout_s=0.2)
    w, _ = client.store.watch("Pod")
    # with per-read timeout 0.2s < the 0.5s keepalive cadence the
    # reader thread dies on socket timeout almost immediately
    deadline = time.monotonic() + 5.0
    while not w.stopped and time.monotonic() < deadline:
        time.sleep(0.02)
    assert w.stopped
    w.stop()
    # a generous timeout keeps the stream alive across keepalive gaps
    client2 = RemoteClient(base, watch_read_timeout_s=30.0)
    w2, _ = client2.store.watch("Pod")
    time.sleep(1.2)  # two keepalive periods
    assert not w2.stopped
    w2.stop()
