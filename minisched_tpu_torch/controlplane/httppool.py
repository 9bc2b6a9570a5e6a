"""Pooled keep-alive HTTP client transport.

A copy of ``minisched_tpu/controlplane/httppool.py`` (``:1-281``).

Every ``RemoteStore`` call used to pay a fresh TCP handshake through a
per-call ``urllib.request.urlopen`` — at wave scale that is a connect/
teardown per informer relist, per bind batch, per mutate round-trip, and
the latency floor of every request is the handshake, not the server.
``HTTPConnectionPool`` keeps a small stack of idle ``http.client``
connections per (host, port) and replays requests over them:

* **Reuse**: a connection whose response was fully read and did not
  carry ``Connection: close`` goes back on the idle stack
  (``wire.pool_reuse`` counts checkouts that found one,
  ``wire.pool_open`` fresh connects).
* **Retry-safe reopen on stale sockets**: a REUSED connection can be
  half-dead — the server closed it while idle (keep-alive timeout, an
  injected ``http.500`` whose handler dropped keep-alive, a restart)
  and the client only learns at the next send/read
  (ConnectionReset/BrokenPipe/BadStatusLine).  That failure is retried
  ONCE on a freshly-opened connection (``wire.pool_stale_retry``);
  a fresh connection's transport failure propagates to the caller's
  own retry policy unchanged, so the jittered-backoff/fault-injection
  retry set composes exactly as before.  (The blind single replay is
  safe under the same contract the outer retry loop already documents:
  GET/PUT/DELETE are idempotent, creates surface as per-item conflicts,
  and the bind subresource's unset-node_name precondition dedupes.)
* **Streams**: ``open_stream`` shares the pool's connection setup
  (host/port parse, timeout plumbing) for the chunked watch verb, whose
  connection is consumed until stream death and never pooled.

The pool is transport only: status-code semantics (409→Conflict,
410→HistoryCompacted, 507→StorageDegraded, ...) stay with the callers
(``RemoteStore._req_ex``, ``httpserver.HTTPClient``), which branch on
the returned status instead of urllib's HTTPError.
"""

from __future__ import annotations

import http.client
import threading
from typing import Dict, Optional, Tuple
from urllib.parse import urlsplit

from minisched_tpu_torch.observability import counters

#: idle connections retained per pool: enough for the informer dispatch
#: threads + the engine's bind path of one scheduler process to each keep
#: a warm socket, small enough that a thousand RemoteStores don't pin a
#: thousand sockets each
DEFAULT_MAX_IDLE = 4

#: transport-level failures on a pooled connection: the socket died under
#: us (never a server-ANSWERED error — those come back as statuses).
#: TimeoutError is deliberately handled apart from this set in request():
#: a timed-out REUSED socket means the server ACCEPTED the request and is
#: slow, not that the socket was dead at checkout — replaying it blindly
#: would double the caller's effective timeout, hide the first failure
#: from its retry accounting, and re-send a POST the wedged server may
#: still be executing.
_CONN_ERRORS = (
    http.client.HTTPException,
    ConnectionError,
    OSError,
)


def bind_already_ours(
    bound_node: str, message: str, requested_node: str
) -> bool:
    """The ONE idempotent-bind-retry dedup rule shared by every client
    facade (RemoteStore.bind_many_remote, HTTPClient.bind): a replayed
    bind answered AlreadyBound is OUR first attempt having landed
    exactly when the server-reported bound node equals the node we
    asked for.  The message-suffix check is the fallback for servers
    predating the structured ``node`` field."""
    if bound_node:
        return bound_node == requested_node
    return message.endswith(f"already bound to {requested_node}")


class HTTPConnectionPool:
    """A small keep-alive connection pool for ONE base URL."""

    def __init__(
        self,
        base_url: str,
        max_idle: int = DEFAULT_MAX_IDLE,
        timeout_s: float = 30.0,
    ):
        u = urlsplit(base_url if "//" in base_url else f"//{base_url}")
        if u.scheme not in ("", "http"):
            raise ValueError(f"only http:// pools supported, got {base_url}")
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or 80
        self._timeout_s = timeout_s
        self._max_idle = max(int(max_idle), 0)
        self._lock = threading.Lock()
        self._idle: list = []  # LIFO: the warmest socket first
        self._closed = False
        #: >0 marks a pool handed out by shared_pool(): close() then
        #: decrements and only latches _closed when the LAST sharer
        #: leaves.  Direct-constructed pools (refs stays 0) close on the
        #: first call exactly as before.
        self._refs = 0

    # -- connection lifecycle ----------------------------------------------
    def _new_conn(
        self, timeout: Optional[float] = None
    ) -> http.client.HTTPConnection:
        counters.inc("wire.pool_open")
        return http.client.HTTPConnection(
            self._host, self._port,
            timeout=self._timeout_s if timeout is None else timeout,
        )

    def _checkout(self) -> Tuple[http.client.HTTPConnection, bool]:
        """(connection, reused): an idle keep-alive socket when one
        exists, else a fresh connect.  ``reused`` is what makes the stale
        retry safe to scope — only a socket the server had a chance to
        close while idle gets the blind single replay."""
        with self._lock:
            if self._idle:
                counters.inc("wire.pool_reuse")
                return self._idle.pop(), True
        return self._new_conn(), False

    def _checkin(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if not self._closed and len(self._idle) < self._max_idle:
                self._idle.append(conn)
                return
        conn.close()

    # -- request/response ---------------------------------------------------
    def request(
        self,
        method: str,
        path: str,
        body: Optional[bytes] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, bytes, bool]:
        """One round-trip: returns ``(status, body bytes, replayed)``
        with the response FULLY read (the precondition for reusing the
        socket — a partially-read body would bleed into the next
        request's response).  Transport failures on a reused socket
        retry once on a fresh one; on a fresh socket they raise to the
        caller's retry policy.

        ``replayed`` is True when the stale-socket replay ran — i.e.
        this response may answer a SECOND transmission of the request.
        Callers whose semantics depend on knowing a retry happened
        (RemoteStore's AlreadyBound-to-our-node dedup keys on its
        attempt count) must fold it in: the first wire attempt may have
        committed before the socket died."""
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        conn, reused = self._checkout()
        replayed = False
        while True:
            try:
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()  # drain fully: required for reuse
            except TimeoutError:
                # the server HAS the request and is slow — not a stale
                # socket.  Surface to the caller's own retry policy
                # (which backs off), never replay blindly here.
                conn.close()
                raise
            except _CONN_ERRORS:
                conn.close()
                if reused:
                    # stale keep-alive socket (server closed it while
                    # idle): replay ONCE on a provably-FRESH connection —
                    # built directly, never re-checked-out (the idle
                    # stack may hold more corpses after a server restart,
                    # and N replays would void the single-replay contract
                    # the idempotency argument is scoped to)
                    counters.inc("wire.pool_stale_retry")
                    conn, reused = self._new_conn(), False
                    replayed = True
                    continue
                raise
            if resp.will_close:
                conn.close()
            else:
                self._checkin(conn)
            return resp.status, data, replayed

    def open_stream(
        self,
        path: str,
        read_timeout_s: float,
        headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[http.client.HTTPConnection, http.client.HTTPResponse]:
        """Open a long-lived GET stream (the chunked watch verb) on a
        DEDICATED connection built by the pool's factory: returns
        ``(connection, response)`` with the status line and headers read
        but the body left streaming.  The connection never joins the
        idle stack — a watch stream monopolizes its socket until death,
        and the caller owns closing both.  ``read_timeout_s`` is the
        per-read socket timeout (the old hard-coded 3600.0)."""
        conn = self._new_conn(timeout=read_timeout_s)
        try:
            conn.request("GET", path, headers=headers or {})
            resp = conn.getresponse()
        except BaseException:
            conn.close()
            raise
        return conn, resp

    def close(self) -> None:
        """Drop every idle connection (in-flight requests finish on
        their own sockets and find the pool closed at check-in).  A
        pool obtained through :func:`shared_pool` is refcounted: each
        sharer's close() drops the idle sockets it may have warmed, but
        the pool only latches closed — and leaves the shared registry —
        when the last sharer hangs up."""
        with self._lock:
            idle, self._idle = self._idle, []
            if self._refs > 0:
                self._refs -= 1
            if self._refs == 0:
                self._closed = True
        for c in idle:
            c.close()
        if self._closed:
            _forget_shared(self)

    def idle_count(self) -> int:
        with self._lock:
            return len(self._idle)


# -- shared per-endpoint pools ----------------------------------------------
#
# RemoteStore and HTTPClient used to each build a private pool, so one
# process talking to one apiserver through both facades kept two idle
# stacks and paid two warmups.  shared_pool() hands every same-endpoint
# caller the SAME pool, keyed by (host, port, timeout_s) — timeout is
# part of the key because it is baked into each pooled socket at connect
# (EngineSupervisor's 5s RemoteStore must not share sockets with a 30s
# default client).

_SHARED: Dict[Tuple[str, int, float], HTTPConnectionPool] = {}
_SHARED_MU = threading.Lock()


def shared_pool(
    base_url: str,
    max_idle: int = DEFAULT_MAX_IDLE,
    timeout_s: float = 30.0,
) -> HTTPConnectionPool:
    """The process-wide pool for ``base_url``'s endpoint, created on
    first use.  Each call takes a reference; callers still call
    ``close()`` exactly as if the pool were private — the refcount makes
    the last close the real one.  ``max_idle`` ratchets UP only (two
    sharers asking 4 and 8 get one pool retaining 8)."""
    probe = HTTPConnectionPool(base_url, max_idle=0, timeout_s=timeout_s)
    key = (probe._host, probe._port, float(timeout_s))
    with _SHARED_MU:
        pool = _SHARED.get(key)
        if pool is None or pool._closed:
            pool = HTTPConnectionPool(
                base_url, max_idle=max_idle, timeout_s=timeout_s
            )
            _SHARED[key] = pool
        with pool._lock:
            pool._refs += 1
            pool._max_idle = max(pool._max_idle, int(max_idle))
        return pool


def _forget_shared(pool: HTTPConnectionPool) -> None:
    """Drop a fully-closed pool from the registry (so a later
    shared_pool() for the endpoint builds a fresh one)."""
    with _SHARED_MU:
        key = (pool._host, pool._port, float(pool._timeout_s))
        if _SHARED.get(key) is pool:
            del _SHARED[key]
