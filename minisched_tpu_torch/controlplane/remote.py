"""Scheduler over the wire: a store and client facade backed by the REST
API.

A copy of ``minisched_tpu/controlplane/remote.py`` (``:1-988``) over the
port's objects and codec; the bytes on the wire are the façade's
(``httpserver.py``), so either package's ``RemoteClient`` talks to
either package's façade.  In the reference the scheduler's informers
list and watch through the HTTP boundary of the in-process apiserver,
client-go against the httptest server (scheduler/scheduler.go:54,72-73;
k8sapiserver/k8sapiserver.go:45-48).  ``RemoteStore`` speaks the
façade's REST and chunked-watch protocol and exposes the part of the
``ObjectStore`` surface the informers and the engine use (watch, list,
get, create, update, mutate, delete); ``RemoteClient`` is the ``Client``
facade over it, so ``SchedulerService(RemoteClient(base_url))`` runs the
whole scheduling path, informers, queue, waves and binds, over the wire.

A wave's binds ride one ``POST /api/v1/bindings`` with a ``batch_id``
(``bind_many_remote``): per-item errors come back per entry, a retried
batch is answered from the server's ack registry, and a retried bind
that had landed (AlreadyBound to the node asked for) counts as done.
Every request rides the shared keep-alive pool (``httppool.py``); watch
streams get their own connections from it.

The multi-endpoint half (JAX ``:313-467``, DESIGN.md §29):
``RemoteStore(base, endpoints=[...])`` over the replica façades of one
replicated plane.  Reads ride the current read endpoint with a
``min_rv`` bound at the session rv (the highest rv the session has seen:
``observe_rv``, ``_advance_from`` on every answer), so reads never go
backwards across a switch and read your writes; a dead or lagging
endpoint rotates (``_rotate_read``).  Writes ride the leader found by
``_discover_leader`` (each endpoint's ``/repl/status``; a 404 means the
plane is not replicated and that server leads); a dead leader or a
``503 not leader`` drops it (``_invalidate_leader``) and the next
attempt discovers again.  A watch whose open fails rotates to the next
endpoint, and a resume there replays exactly the events after its rv.
With one endpoint every path is the single-server one.

The sharded plane's statuses (JAX ``:281-292``, ``:497``, ``:549-643``):
a 421 raises ``WrongShard`` at once (the shard router chases it); a 503
``shard frozen`` is waited out under its own jittered deadline,
``frozen_deadline_s`` (10 s), apart from the transient-retry budget,
and past it raises ``ShardFrozenTimeout``.  ``bind_many_remote(batch_id=,
ack_ids=)`` lets the router post one logical batch across servers.

``faults=`` takes a ``faults.FaultFabric``: its ``remote.request`` point
is consulted before each attempt leaves the process, and an
``InjectedFault`` is retried like a reset connection.
"""

from __future__ import annotations

import http.client
import json
import random
import threading
import time
import traceback
import urllib.error
import uuid
from typing import Any, Dict, List, Optional, Tuple

from minisched_tpu_torch.api.objects import Binding, Pod
from minisched_tpu_torch.controlplane.client import (
    AlreadyBound,
    OutOfCapacity,
    _NodeAPI,
    _PodAPI,
)
from minisched_tpu_torch.controlplane.codec import _decode, _encode
from minisched_tpu_torch.controlplane.httppool import (
    DEFAULT_MAX_IDLE,
    HTTPConnectionPool,
    bind_already_ours,
    shared_pool,
)
from minisched_tpu_torch.controlplane.store import (
    Conflict,
    EventType,
    HistoryCompacted,
    NotLeader,
    NotYetObserved,
    ShardFrozen,
    ShardFrozenTimeout,
    StorageDegraded,
    WatchEvent,
    WrongShard,
)
from minisched_tpu_torch.faults import InjectedFault
from minisched_tpu_torch.observability import counters
from minisched_tpu_torch.utils.retry import backoff_delays

_COLLECTIONS = {
    "Node": "nodes",
    "Pod": "pods",
    "PersistentVolume": "persistentvolumes",
    "PersistentVolumeClaim": "persistentvolumeclaims",
    "Lease": "leases",
    "Event": "events",
}
_CLUSTER_SCOPED = {"Node", "PersistentVolume"}


def _kind_types():
    from minisched_tpu_torch.controlplane.httpserver import REST_KINDS

    return REST_KINDS


class RemoteWatch:
    """A ``store.Watch``-shaped consumer of one chunked watch stream: a
    daemon reader thread decodes JSON lines into WatchEvents; ``next``,
    ``next_batch`` and ``stop`` match the in-process Watch the informer
    drives."""

    def __init__(self, pool: HTTPConnectionPool, path: str, kind: str,
                 read_timeout_s: float = 3600.0,
                 on_decoded: Optional[Any] = None):
        self._cond = threading.Condition()
        self._events: List[WatchEvent] = []
        self._stopped = False
        self._explicit_stop = False
        self._kind = kind
        self._typ = _kind_types()[kind]
        #: called as (kind, seconds, events) with the reader's decode time
        self._on_decoded = on_decoded
        #: the snapshot replay's count from the server's SYNC first line,
        #: set by the reader thread; ``initial_count()`` blocks on it (the
        #: informer's sync barrier)
        self._sync_count: Optional[int] = None
        #: the store rv this stream's snapshot reflects (SYNC line)
        self.start_rv = 0
        # the pool builds the connection, but the stream owns it until
        # it dies: it never joins the idle stack
        self._conn, self._resp = pool.open_stream(path, read_timeout_s)
        if self._resp.status != 200:
            body = self._resp.read().decode(errors="replace")
            self._conn.close()
            if self._resp.status == 410:
                # a resume past the history: the caller must relist
                raise HistoryCompacted(body)
            if self._resp.status == 504 and "not yet observed" in body:
                raise NotYetObserved(body)
            raise RuntimeError(f"HTTP {self._resp.status}: {body}")
        self._thread = threading.Thread(
            target=self._read, name=f"remote-watch-{kind}", daemon=True)
        self._thread.start()

    def _read(self) -> None:
        spent, n = 0.0, 0
        try:
            # http.client de-chunks; each line is one JSON event or a
            # bare keepalive newline
            for raw in self._resp:
                line = raw.strip()
                if not line:
                    continue
                t0 = time.monotonic()
                msg = json.loads(line)
                if msg["type"] == "SYNC":
                    with self._cond:
                        self.start_rv = int(msg.get("rv", 0))
                        self._sync_count = int(msg["count"])
                        self._cond.notify_all()
                    continue
                ev = WatchEvent(EventType(msg["type"]),
                                _decode(self._typ, msg["object"]),
                                rv=int(msg.get("rv", 0)))
                spent += time.monotonic() - t0
                n += 1
                if n >= 1024:
                    self._add_decode(spent, n)
                    spent, n = 0.0, 0
                with self._cond:
                    if self._stopped:
                        return
                    self._events.append(ev)
                    self._cond.notify_all()
        except Exception:
            if not self._explicit_stop:
                # a network failure: the informer's reconnect path takes
                # over; the trace says why it had to
                traceback.print_exc()
        finally:
            self._add_decode(spent, n)
            with self._cond:
                self._stopped = True
                self._cond.notify_all()

    def _add_decode(self, spent: float, n: int) -> None:
        if n and self._on_decoded is not None:
            self._on_decoded(self._kind, spent, n)

    def initial_count(self, timeout: float = 30.0) -> int:
        """Block until the server's SYNC line arrives (how many snapshot
        events this stream replays before live events)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._sync_count is None and not self._stopped:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    break
            if self._sync_count is None:
                raise RuntimeError("watch stream sent no SYNC line")
            return self._sync_count

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        batch = self._wait(timeout, take_all=False)
        return batch[0] if batch else None

    def next_batch(self, timeout: Optional[float] = None) -> List[WatchEvent]:
        return self._wait(timeout, take_all=True)

    def _wait(self, timeout: Optional[float],
              take_all: bool) -> List[WatchEvent]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._events and not self._stopped:
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        break
            if not self._events:
                return []
            if take_all:
                out, self._events = self._events, []
                return out
            return [self._events.pop(0)]

    def stop(self) -> None:
        with self._cond:
            self._explicit_stop = True
            self._stopped = True
            self._cond.notify_all()
        try:
            self._resp.close()  # unblocks the reader thread
        except Exception:
            pass
        try:
            self._conn.close()
        except Exception:
            pass

    @property
    def stopped(self) -> bool:
        return self._stopped


#: transport failures worth a retry: the request may never have reached
#: the server, or its answer was lost.  A status the server answered is
#: not here; only its 5xx family is retried, in ``_req_ex``
_TRANSIENT_ERRORS = (
    urllib.error.URLError,
    ConnectionError,
    TimeoutError,
    http.client.HTTPException,
    InjectedFault,
    OSError,
)


class RemoteStore:
    """The ObjectStore surface the informers and the engine use, over
    REST.

    Every call carries a per-call timeout and retries transient failures
    (connection resets, timeouts, HTTP 5xx) with jittered exponential
    backoff (``utils/retry.backoff_delays``): a scheduler facing a lossy
    control plane waits, it does not crash or drop state.  Semantic
    errors (404, 409: AlreadyBound, a missing object, a conflict) are
    never retried.

    Retry safety: GET, PUT and DELETE are idempotent.  The batch bind is
    made idempotent by the bind's own precondition (``spec.node_name``
    unset): a retried bind whose first attempt landed comes back
    AlreadyBound to the node asked for, which ``bind_many_remote`` turns
    into success.  A retried create whose first attempt landed comes back
    as a per-item conflict."""

    def __init__(
        self,
        base_url: str,
        timeout_s: float = 30.0,
        retries: int = 4,
        backoff_initial_s: float = 0.05,
        backoff_factor: float = 2.0,
        backoff_jitter: float = 0.2,
        retry_seed: Optional[int] = None,
        faults: Any = None,
        watch_read_timeout_s: float = 3600.0,
        pool_max_idle: int = DEFAULT_MAX_IDLE,
        endpoints: Optional[List[str]] = None,
        frozen_deadline_s: float = 10.0,
    ):
        self._base = base_url.rstrip("/")
        self._timeout_s = timeout_s
        self._retries = max(int(retries), 0)
        #: how long one call may wait out a frozen namespace (a split's
        #: window) before ``ShardFrozenTimeout``: its own budget, apart
        #: from ``retries`` — a healthy freeze is milliseconds, a dead
        #: coordinator's thaws at its lease TTL
        self._frozen_deadline_s = max(float(frozen_deadline_s), 0.0)
        #: the ``faults.FaultFabric`` whose ``remote.request`` point each
        #: attempt consults before it leaves the process; the informers
        #: read ``faults`` for their relist jitter seed
        self._faults = faults
        self.faults = faults
        self._backoff_initial_s = backoff_initial_s
        self._backoff_factor = backoff_factor
        self._backoff_jitter = backoff_jitter
        self._rng = random.Random(retry_seed)
        #: per-read timeout of watch streams: an informer behind a proxy
        #: that kills idle flows sooner can match it and reconnect
        self._watch_read_timeout_s = watch_read_timeout_s
        #: the process's pool for this endpoint, shared per (host, port,
        #: timeout) with every RemoteStore and HTTPClient; close() drops
        #: only this reference
        self._pool = shared_pool(self._base, max_idle=pool_max_idle,
                                 timeout_s=timeout_s)
        # -- the multi-endpoint read policy (DESIGN.md §29) --------------
        # ``endpoints`` lists every replica façade of one replicated
        # plane; with two or more, reads round-robin-failover across them
        # bounded by the session rv, and writes route to the discovered
        # leader.  With one endpoint every path is the single-server one.
        bases = [self._base]
        for e in endpoints or []:
            e = e.rstrip("/")
            if e not in bases:
                bases.append(e)
        self._endpoints = bases
        self._multi = len(bases) > 1
        self._pools = {self._base: self._pool}
        for b in bases[1:]:
            self._pools[b] = shared_pool(b, max_idle=pool_max_idle,
                                         timeout_s=timeout_s)
        self._ep_mu = threading.Lock()
        #: the highest rv this session has observed (list rvs, object rvs
        #: on writes): the floor every endpoint-routed read is bounded by
        self._session_rv = 0
        self._read_base = self._base
        self._leader_base: Optional[str] = None if self._multi else self._base
        #: per kind: seconds this store's watch streams spent in
        #: ``json.loads`` and ``_decode`` on their reader threads, and the
        #: events they decoded
        self.decode_s: Dict[str, float] = {}
        self.decoded: Dict[str, int] = {}
        self._decode_mu = threading.Lock()

    def _count_decode(self, kind: str, seconds: float, events: int) -> None:
        with self._decode_mu:
            self.decode_s[kind] = self.decode_s.get(kind, 0.0) + seconds
            self.decoded[kind] = self.decoded.get(kind, 0) + events

    # -- endpoint routing ---------------------------------------------------
    @property
    def session_rv(self) -> int:
        with self._ep_mu:
            return self._session_rv

    def observe_rv(self, rv: int) -> None:
        """Advance the session rv floor (never backwards): from response
        bodies, and from consumers that learn an rv out of band (an
        informer's delivered watch events)."""
        if rv <= 0:
            return
        with self._ep_mu:
            if rv > self._session_rv:
                self._session_rv = rv

    def _advance_from(self, out: Any) -> None:
        """Harvest the rv watermarks of a decoded answer: a list's
        ``resource_version``, an object's ``metadata.resource_version``,
        a batch's per item.  An acked write advances the floor, so the
        next read, wherever routed, observes it."""
        if not isinstance(out, dict):
            return
        rv = out.get("resource_version")
        if rv is None:
            md = out.get("metadata")
            if isinstance(md, dict):
                rv = md.get("resource_version")
        best = int(rv or 0)
        items = out.get("items")
        if isinstance(items, list):
            for item in items:
                if not isinstance(item, dict):
                    continue
                obj = item if "metadata" in item else item.get("object")
                if isinstance(obj, dict):
                    md = obj.get("metadata")
                    if isinstance(md, dict):
                        best = max(best, int(md.get("resource_version") or 0))
        self.observe_rv(best)

    def _rotate_read(self, failed: str) -> None:
        """Move the read cursor off a failed or lagging endpoint (no-op
        when another thread already moved it)."""
        with self._ep_mu:
            if self._read_base == failed and self._multi:
                i = self._endpoints.index(failed)
                self._read_base = self._endpoints[(i + 1)
                                                  % len(self._endpoints)]
                counters.inc("remote.read_failover")

    def _invalidate_leader(self, failed: str) -> None:
        with self._ep_mu:
            if self._leader_base == failed and self._multi:
                self._leader_base = None

    def _discover_leader(self) -> Optional[str]:
        """Probe every endpoint's ``/repl/status``; the base URL of the
        replica that leads.  A 404 means the plane is not replicated:
        that sole server leads.  When no replica claims the role
        (mid-election), a fenced replica's ``leader_hint`` is followed
        if it names a probed peer; else None, and the caller's backoff
        loop discovers again."""
        statuses: Dict[str, dict] = {}
        for base in self._endpoints:
            try:
                st, raw, _ = self._pools[base].request("GET", "/repl/status")
            except _TRANSIENT_ERRORS:
                continue
            if st == 404:
                counters.inc("remote.leader_discoveries")
                return base
            if st != 200:
                continue
            try:
                doc = json.loads(raw)
            except ValueError:
                continue
            statuses[base] = doc
            if doc.get("role") == "leader" and not doc.get("fenced"):
                counters.inc("remote.leader_discoveries")
                return base
        by_id = {d.get("replica"): b for b, d in statuses.items()}
        for doc in statuses.values():
            hint = doc.get("leader_hint") or doc.get("leader") or ""
            if hint in by_id:
                counters.inc("remote.leader_discoveries")
                return by_id[hint]
        return None

    def _route(self, is_read: bool,
               path: str) -> Tuple[HTTPConnectionPool, str, str]:
        """(pool, base, wire path) for one attempt.  Reads ride the
        current read endpoint with the session rv's ``min_rv`` bound;
        writes ride the discovered leader.  Raises OSError (transient:
        the retry loop backs off) while no leader is discoverable."""
        if not self._multi:
            return self._pool, self._base, path
        if path.startswith("/repl/") or path.startswith("/net/"):
            return self._pool, self._base, path
        if is_read:
            with self._ep_mu:
                base = self._read_base
                rv = self._session_rv
            wire = path
            if rv > 0:
                wire += ("&" if "?" in wire else "?") + f"min_rv={rv}"
            return self._pools[base], base, wire
        with self._ep_mu:
            base = self._leader_base
        if base is None:
            base = self._discover_leader()
            if base is None:
                raise OSError("no leader discoverable among "
                              f"{len(self._endpoints)} endpoints")
            with self._ep_mu:
                self._leader_base = base
        return self._pools[base], base, path

    # -- plumbing -----------------------------------------------------------
    def _path(self, kind: str, namespace: str = "", name: str = "") -> str:
        coll = _COLLECTIONS[kind]
        if kind in _CLUSTER_SCOPED or not namespace:
            p = f"/api/v1/{coll}"
        else:
            p = f"/api/v1/namespaces/{namespace}/{coll}"
        return f"{p}/{name}" if name else p

    def _req(self, method: str, path: str, payload: Any = None) -> Any:
        return self._req_ex(method, path, payload)[0]

    def _req_ex(self, method: str, path: str,
                payload: Any = None) -> Tuple[Any, int]:
        """(decoded response, attempts used beyond the first): a caller
        reasoning about idempotency (``bind_many_remote``) needs to know
        whether a retry happened.  The payload is encoded once, so every
        retry carries the same bytes (and the same batch_id)."""
        data = json.dumps(payload).encode() if payload is not None else None
        delays = backoff_delays(self._backoff_initial_s,
                                self._backoff_factor, self._retries + 1,
                                self._backoff_jitter, self._rng)
        last_err: Optional[BaseException] = None
        is_read = method == "GET"
        # a frozen namespace gets its own deadline loop below instead of
        # spending the transient-failure attempts: hence the manual count
        attempt = 0
        frozen_deadline: Optional[float] = None
        frozen_delays: Any = None
        while attempt < self._retries + 1:
            frozen = False
            status = None
            base: Optional[str] = None
            try:
                # routed per attempt: a rotation or a leader discovered
                # between attempts re-routes the retry
                pool, base, wire_path = self._route(is_read, path)
                if self._faults is not None:
                    self._faults.check("remote.request", path)
                # a stale pooled socket is reopened inside the pool
                # without spending one of these attempts, but it is a
                # retransmission: it counts toward the attempts the bind
                # dedup reasons about
                status, raw, replayed = pool.request(method, wire_path,
                                                     body=data)
            except _TRANSIENT_ERRORS as e:
                last_err = e
                if self._multi and base is not None:
                    # a dead endpoint fails over instead of spending the
                    # whole backoff budget on one corpse
                    if is_read:
                        self._rotate_read(base)
                    else:
                        self._invalidate_leader(base)
            if status is not None:
                if status < 400:
                    out = json.loads(raw)
                    self._advance_from(out)
                    return out, attempt + (1 if replayed else 0)
                body = raw.decode(errors="replace")
                if status == 409 and "already bound" in body:
                    raise AlreadyBound(body)
                if status == 409 and "stale resource_version" in body:
                    # semantic: the caller re-reads before re-applying
                    raise Conflict(body)
                if status == 409 and "out of capacity" in body:
                    raise OutOfCapacity(body)
                if status in (404, 409):
                    raise KeyError(body)
                if status == 421:
                    # a sharded plane's misdirected write: retrying this
                    # group never succeeds; the shard router refreshes
                    # its topology and re-routes
                    raise WrongShard(body)
                if status == 503 and "shard frozen" in body:
                    # a split's write freeze: waited out under the frozen
                    # deadline below
                    counters.inc("remote.shard_frozen_retry")
                    last_err = ShardFrozen(body)
                    frozen = True
                elif status == 503 and "not leader" in body:
                    # a fenced replica: retrying HERE never succeeds.  One
                    # endpoint: the typed error at once; several: drop the
                    # cached leader and let the next attempt re-route
                    counters.inc("storage.repl.not_leader_errors")
                    if not self._multi:
                        raise NotLeader(body)
                    self._invalidate_leader(base or "")
                    last_err = NotLeader(body)
                elif status == 504 and "not yet observed" in body:
                    # a read bounded past this replica's applied rv:
                    # retryable; rotate to a (fresher) replica and back
                    # off — the write the bound comes from is acked
                    counters.inc("remote.not_yet_observed")
                    if self._multi and base is not None:
                        self._rotate_read(base)
                    last_err = NotYetObserved(body)
                elif status == 507:
                    # the server's WAL is degraded; it probes its own
                    # recovery, so a later attempt can succeed, and the
                    # typed error surfaces when none does
                    counters.inc("storage.remote_degraded_retry")
                    last_err = StorageDegraded(body)
                elif status < 500:
                    raise RuntimeError(f"HTTP {status}: {body}")
                else:
                    last_err = RuntimeError(f"HTTP {status}: {body}")
            if frozen:
                now = time.monotonic()
                if frozen_deadline is None:
                    frozen_deadline = now + self._frozen_deadline_s
                    frozen_delays = backoff_delays(
                        self._backoff_initial_s, self._backoff_factor,
                        1 << 20, self._backoff_jitter, self._rng)
                if now >= frozen_deadline:
                    counters.inc("remote.shard_frozen_timeout")
                    raise ShardFrozenTimeout(
                        f"remote {method} {path} namespace still frozen "
                        f"after its {self._frozen_deadline_s:.1f}s "
                        f"deadline: {last_err}")
                time.sleep(min(next(frozen_delays),
                               max(frozen_deadline - now, 0.0)))
                continue
            attempt += 1
            if attempt <= self._retries:
                counters.inc("remote.retry")
                time.sleep(next(delays))
        if isinstance(last_err, StorageDegraded):
            raise StorageDegraded(
                f"remote {method} {path} still degraded after "
                f"{self._retries + 1} attempts: {last_err}")
        if isinstance(last_err, NotYetObserved):
            raise NotYetObserved(
                f"remote {method} {path} still unobserved after "
                f"{self._retries + 1} attempts: {last_err}")
        if isinstance(last_err, ShardFrozen):
            raise ShardFrozen(
                f"remote {method} {path} still frozen after "
                f"{self._retries + 1} attempts: {last_err}")
        if isinstance(last_err, NotLeader):
            raise NotLeader(
                f"remote {method} {path} found no writable leader after "
                f"{self._retries + 1} attempts: {last_err}")
        raise RuntimeError(
            f"remote {method} {path} failed after {self._retries + 1} "
            f"attempts: {last_err}")

    # -- store surface ------------------------------------------------------
    def watch(self, kind: str, send_initial: bool = True,
              resume_rv: Optional[int] = None
              ) -> Tuple[RemoteWatch, List[Any]]:
        """(watch, snapshot placeholder): the stream replays the server's
        snapshot as ADDED events and announces their exact count in its
        SYNC first line, counted atomically with the registration.  The
        returned list is sized to that count and holds Nones: the
        informer only measures its length, and the objects arrive on the
        stream.

        ``resume_rv`` resumes from that resource_version instead
        (``?resource_version=N``): SYNC count 0, the retained events after
        N stream in as live events.  Raises HistoryCompacted (the 410)
        when the history no longer reaches back to N.

        With several endpoints the stream opens on the current read
        endpoint and fails over across replicas on a connect failure or
        a lagging follower's NotYetObserved; with the server's exact
        rv > resume_rv replay, a consumer that resumes at its last
        delivered rv gets every event exactly once whichever replica
        serves it."""
        path = f"{self._path(kind)}?watch=true"
        if resume_rv is not None:
            path += f"&resource_version={int(resume_rv)}"
        if not self._multi:
            w = RemoteWatch(self._pool, path, kind,
                            read_timeout_s=self._watch_read_timeout_s,
                            on_decoded=self._count_decode)
            return w, [None] * w.initial_count()
        last: Optional[BaseException] = None
        for _ in range(len(self._endpoints)):
            with self._ep_mu:
                base = self._read_base
            try:
                w = RemoteWatch(self._pools[base], path, kind,
                                read_timeout_s=self._watch_read_timeout_s,
                                on_decoded=self._count_decode)
                return w, [None] * w.initial_count()
            except (NotYetObserved,) + _TRANSIENT_ERRORS as e:
                last = e
                counters.inc("remote.watch_failover")
                self._rotate_read(base)
        raise last if last is not None else RuntimeError(
            f"watch {kind} open failed on every endpoint")

    def list(self, kind: str) -> List[Any]:
        typ = _kind_types()[kind]
        out = self._req("GET", self._path(kind))
        return [_decode(typ, o) for o in out["items"]]

    def list_with_rv(self, kind: str) -> Tuple[List[Any], int]:
        """(items, the store resource_version they reflect), as the
        in-process ``list_with_rv``.  The server may stream the body
        chunked from its list cache; ``http.client`` de-chunks it."""
        typ = _kind_types()[kind]
        out = self._req("GET", self._path(kind))
        return ([_decode(typ, o) for o in out["items"]],
                int(out.get("resource_version", 0)))

    def get(self, kind: str, namespace: str, name: str) -> Any:
        typ = _kind_types()[kind]
        return _decode(typ, self._req("GET",
                                      self._path(kind, namespace, name)))

    def create(self, kind: str, obj: Any) -> Any:
        typ = _kind_types()[kind]
        return _decode(typ, self._req(
            "POST", self._path(kind, obj.metadata.namespace), _encode(obj)))

    def create_many(self, kind: str, objs: List[Any],
                    return_objects: bool = True) -> List[Any]:
        """Batch create: one collection POST per distinct namespace (the
        server rewrites each item's namespace to the URL's, so a mixed
        batch on one URL would move objects).  Returns results aligned
        with ``objs``: the object, None with ``return_objects=False``
        (the server answers ``{}`` per success), or the item's
        exception."""
        if not objs:
            return []
        typ = _kind_types()[kind]
        by_ns: Dict[str, List[int]] = {}
        for i, o in enumerate(objs):
            by_ns.setdefault(o.metadata.namespace, []).append(i)
        results: List[Any] = [None] * len(objs)
        for ns, idxs in by_ns.items():
            payload: dict = {"items": [_encode(objs[i]) for i in idxs]}
            if not return_objects:
                payload["return_objects"] = False
            out = self._req("POST", self._path(kind, ns), payload)
            for i, item in zip(idxs, out["items"]):
                err = item.get("error")
                if err is not None:
                    results[i] = (StorageDegraded(err)
                                  if item.get("type") == "StorageDegraded"
                                  else KeyError(err))
                elif item.get("object") is not None:
                    results[i] = _decode(typ, item["object"])
                else:
                    results[i] = None
        return results

    def update(self, kind: str, obj: Any,
               expected_rv: Optional[int] = None) -> Any:
        typ = _kind_types()[kind]
        path = self._path(kind, obj.metadata.namespace, obj.metadata.name)
        if expected_rv is not None:
            path += f"?expected_rv={int(expected_rv)}"
        return _decode(typ, self._req("PUT", path, _encode(obj)))

    def mutate(self, kind: str, namespace: str, name: str, fn: Any,
               max_conflict_retries: int = 16) -> Any:
        """Read-modify-write over the wire: GET, apply ``fn``, PUT with
        the read's resource_version as ``expected_rv``, and on Conflict
        read again and re-apply.  Two remote writers never silently
        overwrite each other."""
        last: Optional[BaseException] = None
        for _ in range(max_conflict_retries + 1):
            obj = self.get(kind, namespace, name)
            rv = obj.metadata.resource_version
            updated = fn(obj) or obj
            try:
                return self.update(kind, updated, expected_rv=rv)
            except Conflict as err:
                counters.inc("remote.conflict_retry")
                last = err
        raise RuntimeError(
            f"remote mutate {kind} {namespace}/{name} still conflicting "
            f"after {max_conflict_retries + 1} attempts: {last}")

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._req("DELETE", self._path(kind, namespace, name))

    def close(self) -> None:
        """Drop the pools' idle sockets (watch streams own theirs)."""
        for pool in self._pools.values():
            pool.close()

    def bind_many_remote(self, bindings: List[Binding],
                         return_objects: bool = True,
                         batch_id: Optional[str] = None,
                         ack_ids: Optional[List[str]] = None,
                         assume_retry: bool = False) -> List[Any]:
        """One batch-bind POST with one ack identity (``batch_id``) for
        the logical batch, carried by every retry: the server answers the
        entries it already decided from its ack registry.  ``ack_ids``
        pins each item's ack id; ``assume_retry`` treats the call as a
        re-dispatch, so AlreadyBound to our node counts as done on the
        first attempt too."""
        items = []
        for i, b in enumerate(bindings):
            it: dict = {"namespace": b.pod_namespace, "name": b.pod_name,
                        "node_name": b.node_name}
            if b.expected_rv is not None:
                it["expected_rv"] = b.expected_rv
            if ack_ids is not None:
                it["ack"] = str(ack_ids[i])
            items.append(it)
        out, attempts = self._req_ex("POST", "/api/v1/bindings", {
            "items": items, "return_objects": return_objects,
            "batch_id": batch_id or uuid.uuid4().hex})
        if assume_retry:
            attempts = max(attempts, 1)
        results: List[Any] = []
        for b, item in zip(bindings, out["items"]):
            if item.get("acked"):
                # the first attempt's recorded outcome, not a re-run
                counters.inc("remote.bind_ack_replayed")
            err = item.get("error")
            if err is not None:
                typ = item.get("type")
                if typ == "Conflict":
                    results.append(Conflict(err))
                elif typ == "OutOfCapacity":
                    results.append(OutOfCapacity(err))
                elif typ == "StorageDegraded":
                    results.append(StorageDegraded(err))
                elif typ == "AlreadyBound":
                    # a retried request whose first attempt committed
                    # comes back AlreadyBound to the node we asked for:
                    # our own bind, not a conflict (one rule with
                    # HTTPClient.bind: httppool.bind_already_ours)
                    ours = bind_already_ours(item.get("node") or "", err,
                                             b.node_name)
                    if attempts > 0 and ours:
                        counters.inc("remote.bind_retry_dedup")
                        results.append(None)
                    else:
                        results.append(AlreadyBound(err))
                else:
                    results.append(KeyError(err))
            elif item.get("object") is not None:
                results.append(_decode(Pod, item["object"]))
            else:
                results.append(None)
        return results


class _RemotePodAPI(_PodAPI):
    """The Pod facade over the wire: binds take the batch endpoint (one
    request a wave), batch creates one collection POST."""

    def bind_many(self, bindings: List[Binding],
                  return_objects: bool = True) -> List[Any]:
        return self._store.bind_many_remote(bindings,
                                            return_objects=return_objects)

    def create_many(self, pods: List[Any],
                    return_objects: bool = True) -> List[Any]:
        for p in pods:
            if not p.metadata.namespace:
                p.metadata.namespace = self._ns
        out = []
        for res in self._store.create_many("Pod", pods, return_objects):
            if isinstance(res, BaseException):
                raise res
            out.append(res)
        return out


class _RemoteNodeAPI(_NodeAPI):
    """The Node facade over the wire, with the batch-create POST."""

    def create_many(self, nodes: List[Any],
                    return_objects: bool = True) -> List[Any]:
        for n in nodes:
            n.metadata.namespace = ""
        out = []
        for res in self._store.create_many("Node", nodes, return_objects):
            if isinstance(res, BaseException):
                raise res
            out.append(res)
        return out


class RemoteClient:
    """The Client facade whose every call crosses the HTTP boundary: hand
    it to ``SchedulerService`` to run the whole scheduling path over the
    wire (scheduler.go:54,72-73 against k8sapiserver.go:45-48).  Keyword
    arguments (timeouts, the retry policy) pass through to
    ``RemoteStore``."""

    def __init__(self, base_url: str, **kwargs: Any):
        self.store = RemoteStore(base_url, **kwargs)

    def nodes(self) -> _RemoteNodeAPI:
        return _RemoteNodeAPI(self.store)

    def pods(self, namespace: str = "default") -> _RemotePodAPI:
        return _RemotePodAPI(self.store, namespace)
