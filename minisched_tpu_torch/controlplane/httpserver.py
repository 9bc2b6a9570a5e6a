"""HTTP API façade: the control plane served over REST.

A copy of ``minisched_tpu/controlplane/httpserver.py`` over the port's
``ObjectStore`` (in memory, or ``durable.DurableObjectStore``: then the
batch bind's ack outcomes are also written to the WAL, and the registry
starts from the ones the WAL recovered).  It re-creates the reference's L1 boundary, a
kube-apiserver served through an ``httptest.Server`` with health polling
(k8sapiserver/k8sapiserver.go:43-71, :231-249), as a stdlib
ThreadingHTTPServer.  Kubernetes-shaped routes:

    GET    /healthz                                   → 200 "ok"
    GET    /metrics                                   → Prometheus text
    GET    /debug/trace                               → the span ring (JSONL)
    GET    /api/v1/nodes                              → list
    GET    /api/v1/nodes/{name}                       → get
    POST   /api/v1/nodes                              → create (one, or
                                                        {"items": [...]})
    PUT    /api/v1/nodes/{name}                       → update
    DELETE /api/v1/nodes/{name}                       → delete
    (the same under /api/v1/namespaces/{ns}/pods, persistentvolumes,
    /api/v1/namespaces/{ns}/persistentvolumeclaims and events)
    POST   /api/v1/namespaces/{ns}/pods/{name}/binding → bind subresource
    POST   /api/v1/bindings                           → batch bind
    GET    /api/v1/...?watch=true[&resource_version=N] → JSON-lines stream

Objects travel in the control plane's JSON codec (``codec.py``), the
namespace rules and the error codes are JAX's (409 conflict, 404
missing, 400 malformed, 410 a watch resume past the history, 507 a store
that cannot persist), and ``start_api_server`` mirrors
``StartAPIServer(etcdURL) → (config, shutdownFn)``: it returns (server,
base_url, shutdown_fn) once ``/healthz`` answers.  ``HTTPClient`` is the
in-process ``Client``'s facade over the wire.

``GET /debug/trace`` dumps the flight-recorder span ring
(``observability/trace.py``) as JSONL.

Lists are served from the store's copy-on-write read plane (JAX
``:500``): one encode per (kind, namespace, rv), streamed chunked from
the shared bytes to every relisting client; ``MINISCHED_COW_READS=0``
answers the same bytes from the locked path.  After the handshake and
the replay, a watch stream's socket is handed to the one-thread selector
loop (``streamloop.StreamLoop``, JAX ``:632-680``), with an 8 MiB
out-buffer bound past which a laggard is evicted onto the resume path;
``MINISCHED_STREAMLOOP=0`` keeps a handler thread for each stream.
``HTTPClient`` rides the process's shared keep-alive pool
(``httppool.py``).

Replication (JAX ``:225-227``, ``:388-400``, ``:735-751``): with
``start_api_server(repl=ReplRuntime)`` the ``/repl/*`` routes (status,
stream, digests, checkpoint, ack) are the runtime's, and without one
they answer 404, which a multi-endpoint ``RemoteStore`` reads as "not
replicated".  A fenced store's ``NotLeader`` answers 503 ``not leader``
on every write route.  ``GET``/``POST /net/partition`` read and drive
this process's ``faults.net.GLOBAL_NET``.  Leases ride
``/api/v1/namespaces/{ns}/leases``.  A ``min_rv``-bounded read counts
``wire.read.bounded_requests``, and one past the applied rv (or a watch
resume a follower has not applied) ``wire.read.not_yet_observed``.

Shards (JAX ``:228-232``, ``:308-332``, ``:402-430``, ``:753-879``):
with ``start_api_server(shard=ShardInfo)`` the façade fronts one leader
group of a sharded write plane (``shards.py``).  Every write route, each
entry of a batch create or batch bind included, first asks the group's
``ShardInfo``: a namespace another group owns answers 421 ``wrong
shard``, one inside a split's freeze 503 ``shard frozen``, before the
store runs anything (a batch bind checks only the entries its ack
registry does not answer).  ``GET /shards/status`` (topology, leases),
``/shards/handoff?namespace=`` (the source's handoff document),
``/shards/budget`` (the home group's budget document; 404 elsewhere) and
``POST /shards/control`` (topology, freeze, unfreeze, budget_report),
``/shards/seed`` and ``/shards/purge`` are the split's and the capacity
mirror's surface; the façade's ``shards.ShardRuntime`` (lease journal,
budget sync, autosplit) starts and stops with it.  Without ``shard=``
the routes answer 404 and no write is refused.

``start_api_server(faults=FaultFabric)`` makes the façade lossy on
purpose (JAX ``:237-265``): before any route runs, ``http.reset`` closes
the connection without a byte written and ``http.500`` answers 503 and
closes it, each keyed by the request path; ``/healthz`` is exempt.  Both
fire before the store is touched, and before a watch stream is handed to
the stream loop, so a retried request never finds half-applied state.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, List, Optional, Tuple
from urllib.parse import parse_qs

from minisched_tpu_torch.api import objects
from minisched_tpu_torch.api.objects import Binding, Node, Pod
from minisched_tpu_torch.controlplane.client import (
    AlreadyBound,
    Client,
    OutOfCapacity,
)
from minisched_tpu_torch.controlplane.codec import KIND_TYPES, _decode, _encode
from minisched_tpu_torch.controlplane.store import (
    Conflict,
    HistoryCompacted,
    NotLeader,
    NotYetObserved,
    ObjectStore,
    ShardFrozen,
    StorageDegraded,
    WrongShard,
)
from minisched_tpu_torch.faults.net import GLOBAL_NET
from minisched_tpu_torch.observability import counters, hist, trace

#: the kinds the REST façade serves: the codec's plus the Event kind the
#: scheduler's recorder writes (scheduler/scheduler.go:55-59)
REST_KINDS = {**KIND_TYPES, "Event": objects.Event}

_COLLECTIONS = {"nodes": "Node", "pods": "Pod",
                "persistentvolumes": "PersistentVolume",
                "persistentvolumeclaims": "PersistentVolumeClaim",
                "leases": "Lease", "events": "Event"}

#: kinds stored under namespace "" whatever the URL or body (kube
#: semantics)
_CLUSTER_SCOPED = {"Node", "PersistentVolume"}

#: bound on the binding-ack registry (entries, FIFO): every in-flight
#: wave's retries land inside it, and a long run never grows without bound
_ACK_REGISTRY_CAP = 65536

#: chunk size of a list body streamed from the read plane's shared bytes
_LIST_CHUNK_BYTES = 256 * 1024


def _fixup_namespace(kind: str, ns: str, obj: Any) -> None:
    """The one namespace rule for creates (single and batch): cluster-
    scoped kinds normalize to ""; otherwise the URL namespace wins, else
    the body's, else "default"."""
    if kind in _CLUSTER_SCOPED:
        obj.metadata.namespace = ""
    elif ns:
        obj.metadata.namespace = ns
    elif not obj.metadata.namespace:
        obj.metadata.namespace = "default"


def _route(path: str):
    """→ (kind, namespace, name, subresource); name and sub may be ''."""
    parts = [p for p in path.split("/") if p]
    # api/v1/nodes[/name]  |  api/v1/namespaces/ns/pods[/name[/binding]]
    if parts[:2] != ["api", "v1"] or len(parts) < 3:
        raise KeyError(path)
    rest = parts[2:]
    try:
        if rest[0] == "namespaces":
            ns, collection, *tail = rest[1:]
        else:
            ns, (collection, *tail) = "", rest
    except (IndexError, ValueError):
        raise KeyError(path)
    name = tail[0] if tail else ""
    sub = tail[1] if len(tail) > 1 else ""
    return _COLLECTIONS[collection], ns, name, sub


def _route_label(path: str) -> str:
    """Low-cardinality route label for ``http.request_s``: the shape of
    the path, never an object's name."""
    if not path.startswith("/api/"):
        return path if path in (
            "/healthz", "/metrics", "/debug/trace"
        ) else "other"
    try:
        kind, _ns, name, sub = _route(path)
    except KeyError:
        return "unroutable"
    label = kind.lower()
    if name:
        label += "/{name}"
    if sub:
        label += "/" + sub
    return label


def _chunk_frame(data: bytes) -> bytes:
    """One chunked-transfer frame of the watch stream."""
    return f"{len(data):X}\r\n".encode() + data + b"\r\n"


def event_wire_chunk(ev: Any) -> bytes:
    """The watch stream's framed bytes for one event, encoded once and
    memoized on the event: the store hands every watcher the same event,
    so N streams of one mutation cost one encode.  ``watch.fanout.encoded``
    counts first encodes, ``watch.fanout.shared`` the reuses."""
    wire = ev.wire
    if wire is None:
        wire = _chunk_frame(json.dumps(
            {"type": ev.type.value, "object": _encode(ev.obj), "rv": ev.rv}
        ).encode() + b"\n")
        ev.wire = wire
        counters.inc("watch.fanout.encoded")
    else:
        counters.inc("watch.fanout.shared")
    return wire


class _Server(ThreadingHTTPServer):
    """A ThreadingHTTPServer that can detach a request's socket: a watch
    handler hands its connection to the stream loop and returns, and
    ``shutdown_request`` must then leave the socket open."""

    #: the default listen backlog (5) drops a burst of watch connects
    request_queue_size = 1024
    daemon_threads = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._detach_lock = threading.Lock()
        self._detached: set = set()

    def detach_socket(self, sock) -> None:
        with self._detach_lock:
            self._detached.add(sock)

    def undetach_socket(self, sock) -> None:
        """Give a socket back to the normal teardown (the adoption raced
        the loop's shutdown)."""
        with self._detach_lock:
            self._detached.discard(sock)

    def shutdown_request(self, request) -> None:
        with self._detach_lock:
            if request in self._detached:
                self._detached.discard(request)
                return  # the stream loop owns this socket now
        super().shutdown_request(request)


class _Handler(BaseHTTPRequestHandler):
    store: ObjectStore = None  # set by start_api_server
    active_watches: set = None
    watch_lock: threading.Lock = None
    #: optional ``faults.FaultFabric`` (``http.500``, ``http.reset``)
    faults = None
    ack_registry: dict = None  # ack id → response entry
    ack_order: deque = None  # FIFO of ack ids for eviction
    ack_lock: threading.Lock = None
    #: the ``streamloop.StreamLoop`` that adopts watch streams; None keeps
    #: a handler thread for each (``MINISCHED_STREAMLOOP=0``)
    stream_loop = None
    #: repl.ReplRuntime when this server fronts a replicated store
    #: (DESIGN.md §27); None = the /repl/* routes answer 404
    repl = None
    #: shards.ShardInfo when this server fronts one leader group of a
    #: sharded write plane; None = unsharded: /shards/* answer 404 and no
    #: write is ever refused (the K=1 parity path)
    shard = None
    protocol_version = "HTTP/1.1"
    #: TCP_NODELAY on every connection: a chunked list body ends in small
    #: writes, which Nagle holds for the client's delayed ACK (about 40 ms
    #: a list on a kept-alive connection); JAX's façade leaves Nagle on
    disable_nagle_algorithm = True

    def log_message(self, *args) -> None:  # quiet
        pass

    def _inject_fault(self) -> bool:
        """Consult the fabric before routing: ``http.reset`` closes the
        connection without a single response byte (the client sees a
        transport error), ``http.500`` answers 503 and closes it (the
        body may be unread, and keep-alive reuse would misparse it as
        the next request).  True: the request was answered so.
        ``/healthz`` is exempt: readiness polling must not be lied to."""
        f = self.faults
        if f is None:
            return False
        path = self.path.partition("?")[0]
        if path == "/healthz":
            return False
        if f.should_fire("http.reset", path):
            try:
                self.connection.close()
            except OSError:
                pass
            self.close_connection = True
            return True
        if f.should_fire("http.500", path):
            self.close_connection = True
            self._error(503, "injected: control plane unavailable")
            return True
        return False

    def _send(self, code: int, payload: Any, rv: Optional[int] = None
              ) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if rv is not None:
            # the resource_version the response's state reflects
            self.send_header("X-Minisched-RV", str(rv))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> Any:
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n)) if n else {}

    def _error(self, code: int, msg: str) -> None:
        self._send(code, {"error": msg})

    def _int_param(self, query: str, name: str) -> Optional[int]:
        """One integer query parameter (None when absent).  A non-integer
        answers 400 here and raises ValueError, so the handler returns."""
        params = parse_qs(query) if query else {}
        if name not in params:
            return None
        try:
            return int(params[name][0])
        except ValueError:
            self._error(400, f"{name} must be an integer")
            raise

    def _shard_guard(self, kind: str, *namespaces: str) -> bool:
        """Refuse a write whose namespace this leader group does not own
        (421 ``wrong shard``) or that sits inside a split's freeze (503
        ``shard frozen``), before the store runs anything, so a refused
        request is safe to re-route or retry whole.  True: proceed (and
        the autosplit watcher's tally counts the namespaces)."""
        sh = self.shard
        if sh is None:
            return True
        eff = ["" if kind in _CLUSTER_SCOPED else (ns or "default")
               for ns in namespaces]
        try:
            for ns in dict.fromkeys(eff):
                sh.check_write(ns)
        except WrongShard as e:
            counters.inc("storage.shard.wrong_shard_refused")
            self._error(421, str(e))
            return False
        except ShardFrozen as e:
            counters.inc("storage.shard.frozen_refused")
            self._error(503, str(e))
            return False
        sh.note_writes(dict.fromkeys(eff))
        return True

    def _observe_request(self, verb: str, path: str, t0: float) -> None:
        hist.observe("http.request_s", time.monotonic() - t0, verb=verb,
                     route=_route_label(path))

    # -- GET ---------------------------------------------------------------
    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        t0 = time.monotonic()
        path, _, query = self.path.partition("?")
        try:
            self._handle_get(path, query)
        finally:
            # a watch stream (or the replication tail, the same shape) is
            # not a request: its latency is not one
            if "watch=true" not in query and path != "/repl/stream":
                self._observe_request("GET", path, t0)

    def _handle_get(self, path: str, query: str) -> None:
        if self._inject_fault():
            return
        if path == "/healthz":
            self._send(200, "ok")
            return
        if path == "/metrics":
            body = hist.render_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if path == "/debug/trace":
            # flight-recorder dump: the bounded span ring as JSONL
            body = trace.dump_jsonl().encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if path == "/net/partition":
            # the partition nemesis's control surface (faults/net.py):
            # a test inspects a replica child's link table
            self._send(200, GLOBAL_NET.describe())
            return
        if path.startswith("/repl/"):
            if self.repl is None:
                self._error(404, "replication not enabled on this server")
            else:
                self.repl.handle_get(self, path, query)
            return
        if path.startswith("/shards/"):
            self._shards_get(path, query)
            return
        try:
            kind, ns, name, _ = _route(path)
        except KeyError:
            self._error(404, f"no route {path}")
            return
        if "watch=true" in query:
            try:
                resume_rv = self._int_param(query, "resource_version")
            except ValueError:
                return  # 400 already sent
            self._watch(kind, ns, resume_rv)
            return
        try:
            min_rv = self._int_param(query, "min_rv")
        except ValueError:
            return  # 400 already sent
        # the rv of the state served, taken before the read: only-forward
        # rv movement keeps "at least this fresh" true
        applied = self.store.applied_rv()
        if min_rv is not None:
            counters.inc("wire.read.bounded_requests")
            if min_rv > applied:
                # a read bounded ahead of this replica's applied state:
                # refused retryably, never served stale — the client
                # waits out the lag or fails over to a fresher replica
                counters.inc("wire.read.not_yet_observed")
                self._send(504, {"error": (
                    f"resource_version {min_rv} not yet observed by this "
                    f"replica (applied {applied})")}, rv=applied)
                return
        try:
            if name:
                self._send(200, _encode(self.store.get(kind, ns, name)),
                           rv=applied)
            else:
                self._list(kind, ns)
        except KeyError as e:
            self._error(404, str(e))

    def _shards_get(self, path: str, query: str) -> None:
        """The sharded plane's discovery and split surface; 404 on an
        unsharded server, so a router can probe any façade."""
        from minisched_tpu_torch.controlplane import shards

        sh = self.shard
        if sh is None:
            self._error(404, "sharding not enabled on this server")
        elif path == "/shards/status":
            self._send(200, sh.describe(), rv=self.store.applied_rv())
        elif path == "/shards/handoff":
            ns = (parse_qs(query).get("namespace") or [""])[0]
            if not ns:
                self._error(400, "handoff requires ?namespace=")
                return
            self._send(200, shards.build_handoff(self.store, ns))
        elif path == "/shards/budget":
            # the home group's per-Node budget document; 404 elsewhere so
            # the mirrors can probe any replica
            if sh.topology.owner("") != sh.group_id:
                self._error(404, "budget doc lives on the home group")
                return
            self._send(200, shards.build_budget_doc(self.store, sh))
        else:
            self._error(404, f"no route {path}")

    def _list(self, kind: str, ns: str) -> None:
        """A list whose ``resource_version`` reflects exactly its items; a
        namespaced path filters.  Off the read plane the body is encoded
        once per (kind, namespace, rv) and streamed chunked from the
        shared bytes; with the plane off (``MINISCHED_COW_READS=0``) it is
        encoded per request under one lock hold.  The decoded bodies are
        byte-identical."""
        t0 = time.monotonic()
        counters.inc("wire.relist_requests")
        try:
            snap = self.store.read_plane()
            if snap is not None:
                self.store._maybe_fault("list", kind, "")

                def build() -> bytes:
                    items = [o for o in snap.maps.get(kind, {}).values()
                             if not ns or o.metadata.namespace == ns]
                    return json.dumps({
                        "items": [_encode(o) for o in items],
                        "resource_version": snap.rv}).encode()

                body = snap.list_body(kind, ns, build)
                counters.inc("wire.relist_bytes_shared", len(body))
                self._send_shared_body(200, body, rv=snap.rv)
            else:
                items, rv = self.store.list_with_rv(kind)
                if ns:
                    items = [o for o in items if o.metadata.namespace == ns]
                self._send(200, {"items": [_encode(o) for o in items],
                                 "resource_version": rv}, rv=rv)
        finally:
            hist.observe("http.list_s", time.monotonic() - t0,
                         kind=kind.lower())

    def _send_shared_body(self, code: int, body: bytes,
                          rv: Optional[int] = None) -> None:
        """Stream shared cached bytes chunked, memoryview slices of the
        one body straight to the socket; ``http.client`` de-chunks them
        into the bytes ``_send`` would have sent."""
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        if rv is not None:
            self.send_header("X-Minisched-RV", str(rv))
        self.end_headers()
        mv = memoryview(body)
        for off in range(0, len(mv), _LIST_CHUNK_BYTES):
            piece = mv[off:off + _LIST_CHUNK_BYTES]
            self.wfile.write(f"{len(piece):X}\r\n".encode())
            self.wfile.write(piece)
            self.wfile.write(b"\r\n")
        self.wfile.write(b"0\r\n\r\n")

    def _watch(self, kind: str, ns: str, resume_rv: Optional[int]) -> None:
        """JSON-lines event stream (chunked) until the client hangs up or
        the server shuts down.  The first line is SYNC: how many snapshot
        events follow (namespace-filtered), counted atomically with the
        registration, and the rv they reflect.  ``resume_rv`` (the
        ``?resource_version=N`` query) replays the retained history after
        N instead, SYNC count 0; past the history: 410 Gone."""
        try:
            watch, snapshot = self.store.watch(
                kind, send_initial=resume_rv is None, resume_rv=resume_rv,
                clone_snapshot=False)
        except NotYetObserved as e:
            # retryable, unlike the 410: this store has not applied the
            # resume cursor yet
            counters.inc("wire.read.not_yet_observed")
            self._error(504, str(e))
            return
        except HistoryCompacted as e:
            self._error(410, str(e))
            return
        with self.watch_lock:
            self.active_watches.add(watch)
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonlines")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        n_initial = sum(1 for o in snapshot
                        if not ns or o.metadata.namespace == ns)
        sync_line = _chunk_frame(json.dumps(
            {"type": "SYNC", "count": n_initial, "rv": watch.start_rv}
        ).encode() + b"\n")
        if self.stream_loop is not None:
            self._adopt(watch, ns, sync_line)
            return
        try:
            self.wfile.write(sync_line)
            self.wfile.flush()
            while True:
                events = watch.next_batch(timeout=0.5)
                if not events:
                    if watch.stopped:
                        break
                    self.wfile.write(_chunk_frame(b"\n"))  # keepalive
                    self.wfile.flush()
                    continue
                now = time.monotonic()
                for ev in events:
                    if ns and ev.obj.metadata.namespace != ns:
                        continue
                    self.wfile.write(event_wire_chunk(ev))
                    if ev.born:
                        hist.observe("watch.delivery_lag_s",
                                     max(now - ev.born, 0.0))
                self.wfile.flush()
            # orderly end of stream: the terminal chunk
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except OSError:
            # the client hung up mid-chunk: counted, and the watch is
            # unregistered at once below
            counters.inc("watch.disconnects")
        finally:
            self.close_connection = True
            watch.stop()
            with self.watch_lock:
                self.active_watches.discard(watch)

    def _adopt(self, watch: Any, ns: str, sync_line: bytes) -> None:
        """The stream-loop path: the SYNC line and the queued replay are
        written on this thread (blocking writes suit a large backlog),
        then the socket is detached into the loop and this thread
        returns.  The bytes are the thread path's."""
        handed_off = False
        try:
            self.wfile.write(sync_line)
            for ev in watch.next_batch(timeout=0):
                if ns and ev.obj.metadata.namespace != ns:
                    continue
                self.wfile.write(event_wire_chunk(ev))
            self.wfile.flush()
            handed_off = True
        except OSError:
            counters.inc("watch.disconnects")
        finally:
            if not handed_off:
                self.close_connection = True
                watch.stop()
                with self.watch_lock:
                    self.active_watches.discard(watch)
        if not handed_off:
            return
        self.close_connection = True
        with self.watch_lock:
            # the loop owns the stream now; shutdown reaches it through
            # StreamLoop.stop
            self.active_watches.discard(watch)
        sock = self.connection
        self.server.detach_socket(sock)
        try:
            self.stream_loop.adopt(sock, watch, ns)
        except RuntimeError:
            # the loop is stopping: back to the normal teardown
            self.server.undetach_socket(sock)
            watch.stop()

    # -- POST --------------------------------------------------------------
    def do_POST(self) -> None:  # noqa: N802
        t0 = time.monotonic()
        try:
            self._handle_post()
        finally:
            self._observe_request("POST", self.path.partition("?")[0], t0)

    def _handle_post(self) -> None:
        if self._inject_fault():
            return
        path = self.path.partition("?")[0]
        if path == "/api/v1/bindings":
            self._bind_many()
            return
        if path == "/net/partition":
            # cut/heal this process's outbound links (faults/net.py): how
            # a test partitions replica children it cannot reach into
            try:
                self._send(200, GLOBAL_NET.control(self._body()))
            except (KeyError, ValueError) as e:
                self._error(400, f"bad partition control: {e}")
            return
        if path.startswith("/repl/"):
            if self.repl is None:
                self._error(404, "replication not enabled on this server")
            else:
                self.repl.handle_post(self, path)
            return
        if path.startswith("/shards/"):
            self._shards_post(path)
            return
        try:
            kind, ns, name, sub = _route(path)
        except KeyError:
            self._error(404, f"no route {self.path}")
            return
        if sub == "binding":
            self._bind_one(ns or "default", name)
            return
        try:
            body = self._body()
        except ValueError as e:
            self._error(400, f"malformed body: {e}")
            return
        # a collection POST with an "items" list is a batch create (single
        # objects never encode with a top-level "items" key)
        if isinstance(body, dict) and isinstance(body.get("items"), list):
            self._create_many(kind, ns, body["items"],
                              return_objects=body.get("return_objects", True))
            return
        try:
            obj = _decode(REST_KINDS[kind], body)
        except Exception as e:  # any decode failure is the client's
            self._error(400, f"malformed body: {e}")
            return
        _fixup_namespace(kind, ns, obj)
        if not self._shard_guard(kind, obj.metadata.namespace):
            return
        try:
            self._send(201, _encode(self.store.create(kind, obj)))
        except NotLeader as e:
            # 503 with the "not leader" marker: this replica is fenced;
            # the client re-discovers the leader, it does not retry here
            self._error(503, str(e))
        except StorageDegraded as e:
            self._error(507, str(e))
        except KeyError as e:
            self._error(409, str(e))

    def _bind_one(self, namespace: str, name: str) -> None:
        try:
            data = self._body()
            node_name = data.get("node_name")
        except (ValueError, AttributeError) as e:
            self._error(400, f"malformed body: {e}")
            return
        if not node_name:
            self._error(400, "binding body requires node_name")
            return
        if not self._shard_guard("Pod", namespace):
            return
        try:
            pod = Client(self.store).pods(namespace).bind(Binding(
                name, namespace, node_name,
                expected_rv=data.get("expected_rv")))
            self._send(201, _encode(pod))
        except AlreadyBound as e:
            self._send(409, self._already_bound_entry(e, namespace, name))
        except (Conflict, OutOfCapacity) as e:
            self._error(409, str(e))
        except NotLeader as e:
            self._error(503, str(e))
        except StorageDegraded as e:
            self._error(507, str(e))
        except KeyError as e:
            self._error(404, str(e))

    def _shards_post(self, path: str) -> None:
        """``/shards/control`` (topology, freeze, unfreeze, budget_report
        on this façade's ShardInfo; the split coordinator sends every op to
        every replica of every group), ``/shards/seed`` (a handoff
        document's objects into this group's store, on its leader) and
        ``/shards/purge`` (the shipped objects out of the source after
        the flip).  Seed and purge bypass the guard: they move objects
        the topology says this group does not (yet, or any longer) own."""
        from minisched_tpu_torch.controlplane import shards

        sh = self.shard
        if sh is None:
            self._error(404, "sharding not enabled on this server")
            return
        try:
            body = self._body()
        except ValueError as e:
            self._error(400, f"malformed body: {e}")
            return
        try:
            if path == "/shards/control":
                sh.apply_control(body)
                self._send(200, sh.describe())
            elif path == "/shards/seed":
                self._send(200, shards.apply_seed(self.store, body))
            elif path == "/shards/purge":
                ns = body.get("namespace") or ""
                if not ns:
                    self._error(400, "purge requires namespace")
                    return
                self._send(200, shards.purge_namespace(
                    self.store, ns, names=body.get("names")))
            else:
                self._error(404, f"no route {path}")
        except NotLeader as e:
            self._error(503, str(e))
        except StorageDegraded as e:
            self._error(507, str(e))
        except (KeyError, ValueError) as e:
            self._error(400, f"bad shard control: {e}")

    def _already_bound_entry(self, err: BaseException, namespace: str,
                             name: str) -> dict:
        """The 409 AlreadyBound body, with the node the pod is bound to as
        a field: a retrying client compares it with the node it asked
        for."""
        entry = {"error": str(err), "type": "AlreadyBound"}
        try:
            entry["node"] = self.store.get("Pod", namespace,
                                           name).spec.node_name
        except KeyError:
            pass  # the pod vanished between the bind and the lookup
        return entry

    def _create_many(self, kind: str, ns: str, items: list,
                     return_objects: bool = True) -> None:
        """Batch create: decode each item (the single create's namespace
        rule), then one store transaction; one response entry per item:
        {"object"} (bare {} without ``return_objects``) or {"error",
        "type"}."""
        out: List[Any] = [None] * len(items)
        decoded = []
        for i, raw in enumerate(items):
            try:
                obj = _decode(REST_KINDS[kind], raw)
            except Exception as e:  # any decode failure is the client's
                out[i] = {"error": f"malformed item: {e}",
                          "type": "BadRequest"}
                continue
            _fixup_namespace(kind, ns, obj)
            decoded.append((i, obj))
        if not self._shard_guard(
                kind, *[o.metadata.namespace for _, o in decoded]):
            return
        try:
            results = self.store.create_many(
                kind, [o for _, o in decoded], return_objects=return_objects)
        except NotLeader as e:
            self._error(503, str(e))
            return
        except StorageDegraded as e:
            self._error(507, str(e))
            return
        for (i, _), res in zip(decoded, results):
            if isinstance(res, KeyError):
                out[i] = {"error": str(res), "type": "Conflict"}
            elif isinstance(res, StorageDegraded):
                out[i] = {"error": str(res), "type": "StorageDegraded"}
            elif isinstance(res, BaseException):
                out[i] = {"error": str(res), "type": "Error"}
            elif res is None:
                out[i] = {}
            else:
                out[i] = {"object": _encode(res)}
        self._send(200, {"items": out})

    def _bind_many(self) -> None:
        """Batch binding: a wave's placements in one request and one store
        transaction; per-item errors come back per entry.

        A request with a ``batch_id`` records each entry's outcome under
        ``{batch_id}/{index}`` (or the item's ``ack``).  A retried batch
        (the response to the first attempt was lost) answers the entries
        already decided from that registry, marked ``"acked": true``,
        and runs only the rest.  The registry is in memory (bounded FIFO);
        over a durable store each outcome is also written to the WAL
        (``record_acks``), so the registry outlives a restart."""
        try:
            data = self._body()
            items = data.get("items", [])
            return_objects = data.get("return_objects", True)
            batch_id = str(data.get("batch_id") or "")
            bindings = []
            ack_keys = []
            for i, it in enumerate(items):
                if not it.get("name") or not it.get("node_name"):
                    self._error(400,
                                "each binding requires name and node_name")
                    return
                bindings.append(Binding(
                    it["name"], it.get("namespace") or "default",
                    it["node_name"], expected_rv=it.get("expected_rv")))
                ack_keys.append(str(it.get("ack", i)))
        except (ValueError, AttributeError, TypeError) as e:
            # malformed JSON, a non-dict body or items: a 400, not a
            # dropped connection
            self._error(400, f"malformed body: {e}")
            return
        replayed: dict = {}
        if batch_id:
            with self.ack_lock:
                for i in range(len(bindings)):
                    entry = self.ack_registry.get(f"{batch_id}/{ack_keys[i]}")
                    if entry is not None:
                        replayed[i] = entry
        todo = [i for i in range(len(bindings)) if i not in replayed]
        # shard ownership of the entries still to run, before any runs: a
        # refused request ran nothing, so the router may re-split it, and
        # the decided entries keep answering from this group's registry
        if not self._shard_guard(
                "Pod", *[bindings[i].pod_namespace for i in todo]):
            return
        try:
            results = Client(self.store).pods().bind_many(
                [bindings[i] for i in todo], return_objects=return_objects)
        except NotLeader as e:
            self._error(503, str(e))
            return
        except StorageDegraded as e:
            # the whole transaction was refused before commit: retryable
            self._error(507, str(e))
            return
        out: List[Any] = [None] * len(bindings)
        fresh: dict = {}
        for i, res in zip(todo, results):
            b = bindings[i]
            if isinstance(res, AlreadyBound):
                entry = self._already_bound_entry(res, b.pod_namespace,
                                                  b.pod_name)
            elif isinstance(res, Conflict):
                entry = {"error": str(res), "type": "Conflict"}
            elif isinstance(res, OutOfCapacity):
                entry = {"error": str(res), "type": "OutOfCapacity"}
            elif isinstance(res, StorageDegraded):
                entry = {"error": str(res), "type": "StorageDegraded"}
            elif isinstance(res, BaseException):
                entry = {"error": str(res), "type": "NotFound"}
            elif res is not None:
                entry = {"object": _encode(res)}
            else:
                entry = {}
            out[i] = entry
            # the registry keeps the outcome, not the encoded pod; a
            # degraded entry never ran, so it is not an outcome
            if entry.get("type") != "StorageDegraded":
                fresh[i] = entry if "error" in entry else {"committed": True}
        for i, entry in replayed.items():
            if entry.get("committed"):
                ack: dict = {"acked": True}
                if return_objects:
                    b = bindings[i]
                    try:
                        ack["object"] = _encode(self.store.get(
                            "Pod", b.pod_namespace, b.pod_name))
                    except KeyError:
                        pass  # deleted since: the ack alone says it landed
                out[i] = ack
            else:
                out[i] = dict(entry, acked=True)
        if batch_id and fresh:
            with self.ack_lock:
                for i, entry in fresh.items():
                    ack_id = f"{batch_id}/{ack_keys[i]}"
                    if ack_id not in self.ack_registry:
                        self.ack_order.append(ack_id)
                    self.ack_registry[ack_id] = entry
                while len(self.ack_order) > _ACK_REGISTRY_CAP:
                    self.ack_registry.pop(self.ack_order.popleft(), None)
            # a durable store persists each outcome as a volatile ``ack``
            # record, so a batch retried across a server restart answers
            # from the recovered outcomes.  Best-effort: the bind's own
            # preconditions stay the backstop on a degraded disk or the
            # in-memory store
            record_acks = getattr(self.store, "record_acks", None)
            if record_acks is not None:
                try:
                    record_acks({f"{batch_id}/{ack_keys[i]}": e
                                 for i, e in fresh.items()})
                except Exception:
                    pass  # never fail a response whose binds committed
        self._send(200, {"items": out})

    # -- PUT, DELETE -------------------------------------------------------
    def do_PUT(self) -> None:  # noqa: N802
        t0 = time.monotonic()
        try:
            self._handle_put()
        finally:
            self._observe_request("PUT", self.path.partition("?")[0], t0)

    def _handle_put(self) -> None:
        if self._inject_fault():
            return
        path, _, query = self.path.partition("?")
        try:
            kind, ns, name, _ = _route(path)
        except KeyError:
            self._error(404, f"no route {path}")
            return
        try:
            expected_rv = self._int_param(query, "expected_rv")
        except ValueError:
            return  # 400 already sent
        try:
            obj = _decode(REST_KINDS[kind], self._body())
        except Exception as e:  # any decode failure is the client's
            self._error(400, f"malformed body: {e}")
            return
        # the URL is authoritative: a body naming another object is a
        # client error, not an update of that object
        if name and obj.metadata.name != name:
            self._error(400, f"body names {obj.metadata.name!r}, path "
                             f"names {name!r}")
            return
        if ns and obj.metadata.namespace != ns:
            self._error(400, f"body namespace {obj.metadata.namespace!r} "
                             f"!= {ns!r}")
            return
        if not self._shard_guard(kind, ns or obj.metadata.namespace):
            return
        try:
            self._send(200, _encode(self.store.update(
                kind, obj, expected_rv=expected_rv)))
        except Conflict as e:
            self._error(409, str(e))
        except NotLeader as e:
            self._error(503, str(e))
        except StorageDegraded as e:
            self._error(507, str(e))
        except KeyError as e:
            self._error(404, str(e))

    def do_DELETE(self) -> None:  # noqa: N802
        t0 = time.monotonic()
        try:
            self._handle_delete()
        finally:
            self._observe_request("DELETE", self.path.partition("?")[0], t0)

    def _handle_delete(self) -> None:
        if self._inject_fault():
            return
        try:
            kind, ns, name, _ = _route(self.path)
            if not self._shard_guard(kind, ns):
                return
            self.store.delete(kind, ns, name)
            self._send(200, {})
        except NotLeader as e:
            self._error(503, str(e))
        except StorageDegraded as e:
            self._error(507, str(e))
        except KeyError as e:
            self._error(404, str(e))


def start_api_server(store: Optional[ObjectStore] = None, port: int = 0,
                     faults: Any = None,
                     stream_buffer_bytes: Optional[int] = None,
                     stream_sndbuf_bytes: Optional[int] = None,
                     repl: Any = None, shard: Any = None
                     ) -> Tuple[ThreadingHTTPServer, str, Callable[[], None]]:
    """Boot the REST façade on ``port`` (0: ephemeral) and poll
    ``/healthz`` until it answers (k8sapiserver.go:231-249's readiness
    loop: 100 ms apart, 30 s at most).  Returns (server, base_url,
    shutdown_fn); the shutdown ends every watch stream first.
    ``faults``: a ``faults.FaultFabric`` whose ``http.500`` and
    ``http.reset`` points make the façade lossy (``_inject_fault``).

    Watch streams are handed to a selector stream loop (N watchers cost N
    sockets and one thread); ``MINISCHED_STREAMLOOP=0`` keeps a handler
    thread for each.  ``stream_buffer_bytes`` and ``stream_sndbuf_bytes``
    override the loop's out-buffer eviction bound and the adopted
    sockets' send buffer.  ``repl``: the replica's ``repl.ReplRuntime``,
    which serves ``/repl/*``.  ``shard``: the group's ``shards.ShardInfo``
    (the guard and ``/shards/*``); its ``ShardRuntime`` (lease journal
    and re-arm, budget sync, autosplit) is attached to the store here
    and stopped with the server."""
    store = store or ObjectStore()
    stream_loop = None
    if os.environ.get("MINISCHED_STREAMLOOP", "1") != "0":
        from minisched_tpu_torch.controlplane.streamloop import (
            DEFAULT_MAX_BUFFER_BYTES,
            DEFAULT_STREAM_SNDBUF_BYTES,
            StreamLoop,
        )

        stream_loop = StreamLoop(
            max_buffer_bytes=stream_buffer_bytes or DEFAULT_MAX_BUFFER_BYTES,
            sndbuf_bytes=stream_sndbuf_bytes or DEFAULT_STREAM_SNDBUF_BYTES)
    # seed the binding-ack registry from the WAL's ``ack`` records (a
    # durable store replays them): a batch retried across a restart then
    # answers from the recovered outcomes instead of re-executing
    recovered = getattr(store, "recovered_acks", None)
    acks = dict(recovered()) if recovered is not None else {}
    handler = type("BoundHandler", (_Handler,), {
        "store": store, "active_watches": set(),
        "watch_lock": threading.Lock(), "faults": faults,
        "ack_registry": acks,
        "ack_order": deque(acks), "ack_lock": threading.Lock(),
        "stream_loop": stream_loop, "repl": repl, "shard": shard})
    shard_runtime = None
    if shard is not None:
        from minisched_tpu_torch.controlplane.shards import (
            attach_shard_runtime,
        )

        shard_runtime = attach_shard_runtime(store, shard)
    server = _Server(("127.0.0.1", port), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="api-server")
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=1.0) as r:
                if r.status == 200:
                    break
        except OSError:
            pass
        time.sleep(0.1)
    else:
        server.shutdown()
        server.server_close()
        if stream_loop is not None:
            stream_loop.stop()
        if shard_runtime is not None:
            shard_runtime.stop()
        raise RuntimeError("API server failed /healthz within 30s")

    def shutdown() -> None:
        # end the watch streams first: their handler threads would
        # otherwise hold their store registrations forever
        with handler.watch_lock:
            watches = list(handler.active_watches)
        for w in watches:
            w.stop()
        if stream_loop is not None:
            stream_loop.stop()  # ends each adopted stream, closes it
        if shard_runtime is not None:
            shard_runtime.stop()
        server.shutdown()
        server.server_close()
        thread.join(timeout=2.0)

    return server, base, shutdown


class HTTPClient:
    """The in-process ``Client``'s facade over the wire (what the
    reference's scenario does with client-go against the httptest server,
    sched.go:70-143): the same methods, the same exceptions.  Requests
    ride the process's shared keep-alive pool for the endpoint (its
    default timeout is ``RemoteStore``'s, so both share one pool)."""

    def __init__(self, base_url: str, timeout: float = 30.0):
        from minisched_tpu_torch.controlplane.httppool import shared_pool

        self._base = base_url.rstrip("/")
        self._pool = shared_pool(self._base, timeout_s=timeout)

    def _req(self, method: str, path: str, payload: Any = None) -> Any:
        data = json.dumps(payload).encode() if payload is not None else None
        status, raw, replayed = self._pool.request(method, path, body=data)
        if status < 400:
            return json.loads(raw)
        body = raw.decode(errors="replace")
        # every error carries whether the pool retransmitted the request
        # (a stale keep-alive socket): ``bind`` needs it
        if status == 409 and "already bound" in body:
            raise self._mark(AlreadyBound(body), replayed)
        if status == 409 and "stale resource_version" in body:
            # == update(expected_rv) in process
            raise self._mark(Conflict(body), replayed)
        if status == 409 and "out of capacity" in body:
            raise self._mark(OutOfCapacity(body), replayed)
        if status == 409 and "already exists" in body:
            # == store.create in process
            raise self._mark(KeyError(body), replayed)
        if status == 404:
            raise self._mark(KeyError(body), replayed)
        if status == 410:
            raise self._mark(HistoryCompacted(body), replayed)
        if status == 507:
            raise self._mark(StorageDegraded(body), replayed)
        if status == 504 and "not yet observed" in body:
            raise self._mark(NotYetObserved(body), replayed)
        if status == 421:
            # == the shard-ownership refusal: typed, so a shard-aware
            # caller re-routes to the owning group
            raise self._mark(WrongShard(body), replayed)
        if status == 503 and "shard frozen" in body:
            raise self._mark(ShardFrozen(body), replayed)
        if status == 503 and "not leader" in body:
            # == the in-process fence refusal: typed, so a leader-aware
            # caller re-discovers the leader instead of retrying here
            raise self._mark(NotLeader(body), replayed)
        raise RuntimeError(f"HTTP {status}: {body}")

    @staticmethod
    def _mark(err: BaseException, replayed: bool) -> BaseException:
        err.replayed = replayed
        return err

    def close(self) -> None:
        """Drop the pool's idle keep-alive sockets (this reference's)."""
        self._pool.close()

    def _create_many(self, path: str, objs: List[Any],
                     return_objects: bool) -> List[Any]:
        """One batch-create request; the in-process ``create_many``'s
        result shape (the object, None without ``return_objects``, or
        the entry's exception)."""
        tp = type(objs[0]) if objs else None
        out = self._req("POST", path, {
            "items": [_encode(o) for o in objs],
            "return_objects": return_objects})["items"]
        res: List[Any] = []
        for entry in out:
            if "error" in entry:
                res.append(KeyError(entry["error"])
                           if entry.get("type") == "Conflict"
                           else RuntimeError(entry["error"]))
            else:
                res.append(_decode(tp, entry["object"])
                           if "object" in entry else None)
        return res

    class _Nodes:
        def __init__(self, c: "HTTPClient"):
            self._c = c

        def create(self, node: Node) -> Node:
            return _decode(Node, self._c._req("POST", "/api/v1/nodes",
                                              _encode(node)))

        def create_many(self, nodes: List[Node],
                        return_objects: bool = True) -> List[Any]:
            return self._c._create_many("/api/v1/nodes", nodes,
                                        return_objects)

        def get(self, name: str) -> Node:
            return _decode(Node, self._c._req("GET", f"/api/v1/nodes/{name}"))

        def list(self) -> List[Node]:
            out = self._c._req("GET", "/api/v1/nodes")
            return [_decode(Node, o) for o in out["items"]]

        def delete(self, name: str) -> None:
            self._c._req("DELETE", f"/api/v1/nodes/{name}")

    class _Pods:
        def __init__(self, c: "HTTPClient", ns: str):
            self._c = c
            self._ns = ns

        def _path(self, name: str = "", namespace: Optional[str] = None
                  ) -> str:
            p = f"/api/v1/namespaces/{namespace or self._ns}/pods"
            return f"{p}/{name}" if name else p

        def create(self, pod: Pod) -> Pod:
            return _decode(Pod, self._c._req("POST", self._path(),
                                             _encode(pod)))

        def create_many(self, pods: List[Pod],
                        return_objects: bool = True) -> List[Any]:
            return self._c._create_many(self._path(), pods, return_objects)

        def get(self, name: str, namespace: Optional[str] = None) -> Pod:
            return _decode(Pod, self._c._req("GET",
                                             self._path(name, namespace)))

        def list(self) -> List[Pod]:
            out = self._c._req("GET", self._path())
            return [_decode(Pod, o) for o in out["items"]]

        def update(self, pod: Pod) -> Pod:
            return _decode(Pod, self._c._req(
                "PUT", self._path(pod.metadata.name), _encode(pod)))

        def delete(self, name: str, namespace: Optional[str] = None) -> None:
            self._c._req("DELETE", self._path(name, namespace))

        def bind(self, binding: Binding) -> Pod:
            try:
                return _decode(Pod, self._c._req(
                    "POST", self._path(binding.pod_name,
                                       binding.pod_namespace) + "/binding",
                    {"node_name": binding.node_name}))
            except AlreadyBound as e:
                # an AlreadyBound answering a pool retransmission and
                # naming the node asked for is our first attempt having
                # committed before its socket died: success (one rule
                # with bind_many_remote: httppool.bind_already_ours)
                if getattr(e, "replayed", False):
                    from minisched_tpu_torch.controlplane.httppool import (
                        bind_already_ours,
                    )

                    try:
                        doc = json.loads(str(e))
                    except ValueError:
                        doc = {}
                    if bind_already_ours(doc.get("node") or "",
                                         doc.get("error") or str(e),
                                         binding.node_name):
                        try:
                            return self.get(binding.pod_name,
                                            binding.pod_namespace)
                        except KeyError:
                            # deleted since: the bind landed all the same
                            from minisched_tpu_torch.api.objects import (
                                make_pod,
                            )

                            p = make_pod(binding.pod_name,
                                         namespace=binding.pod_namespace)
                            p.spec.node_name = binding.node_name
                            return p
                raise

    def nodes(self) -> "HTTPClient._Nodes":
        return HTTPClient._Nodes(self)

    def pods(self, namespace: str = "default") -> "HTTPClient._Pods":
        return HTTPClient._Pods(self, namespace)
