"""gRPC shim: the device evaluator served to external callers.

A copy of ``minisched_tpu/controlplane/grpcserver.py``.  The wire
contract is ``proto/minisched_evaluator.proto``: each message wraps ONE
``bytes json = 1`` field holding the control plane's JSON codec
(``controlplane/codec.py``), framed with a hand-rolled protobuf codec
(``_wrap_json`` / ``_unwrap_json``, byte-identical to what
protoc-generated stubs emit for this shape) and registered through
``grpc.method_handlers_generic_handler``; no protobuf runtime is needed.
Raw-JSON request bodies (the pre-proto framing) are still accepted: the
two framings are unambiguous on the first byte.

Services: ``Health``; ``Evaluate`` (``controlplane/evaluate.py``
``evaluate_cluster``: the full default roster, mode "repair" or "wave",
on the server's ``device``; ``INVALID_ARGUMENT`` on a malformed
request); and, with a ``store``, ``List`` (``min_rv`` past the applied
rv refused ``UNAVAILABLE``) and the server-streaming ``Watch`` (a sync
line, then one message an event; ``resume_rv`` replays the retained
history, ``HistoryCompacted`` is ``OUT_OF_RANGE``; one hub thread encodes
each event once and fans it into per-stream buffers of
``DEFAULT_WATCH_STREAM_EVENTS``, past which a stream is evicted with
``OUT_OF_RANGE``).  Client and server keep grpc's default 4 MiB message
limit, as JAX's do: a larger request is refused ``RESOURCE_EXHAUSTED``.

One addition to JAX's wire: a Watch request may carry ``"batch": n``,
and the stream then sends up to ``n`` events a message as
``{"events": [event, ...]}`` (each event the one-event message's dict,
built from its memoized encode).  The sync line, the errors and a request
without ``batch`` are JAX's byte for byte, and a JAX server ignores the
key, so ``EvaluatorWatch`` reads both framings.  Why: the stream's
generator and grpc's completion-queue thread share the interpreter lock
with whatever else runs in the server's process, and each message costs
them lock hand-offs; beside the live engine binding config 5, one event a
message fell behind and was evicted, while batches keep up (PERF.md).

Usage::

    server, address, shutdown = start_grpc_server(store=client.store)
    out = EvaluatorClient(address).evaluate(nodes, pods)
"""

from __future__ import annotations

import json
import threading
import time
from concurrent import futures
from typing import Any, Callable, Optional, Tuple

from minisched_tpu_torch.controlplane.codec import KIND_TYPES, _encode
from minisched_tpu_torch.controlplane.evaluate import evaluate_cluster
from minisched_tpu_torch.controlplane.store import (
    HistoryCompacted,
    NotYetObserved,
)
from minisched_tpu_torch.observability import counters, hist

SERVICE = "minisched.Evaluator"


# ---------------------------------------------------------------------------
# proto framing: `message X { bytes json = 1; }` — field 1, wire type 2
# (length-delimited).  Encoding/decoding this one shape by hand keeps the
# wire byte-identical to protoc-generated stubs without a protobuf runtime.
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _wrap_json(payload: bytes) -> bytes:
    """Serialize ``message { bytes json = 1; }`` (proto3 omits empty)."""
    if not payload:
        return b""
    return b"\x0a" + _varint(len(payload)) + payload


def _unwrap_json(data: bytes) -> bytes:
    """Parse the message above; also accepts the legacy raw-JSON framing
    (first byte ``{`` / ``[`` / whitespace — never a field-1 tag)."""
    if not data:
        return b"{}"
    if data[0] != 0x0A:
        return data  # raw JSON (pre-proto framing)
    length, pos = _read_varint(data, 1)
    if pos + length > len(data):
        raise ValueError("truncated json field")
    return data[pos : pos + length]


# ---------------------------------------------------------------------------
# gRPC plumbing (generic handlers; JSON bytes on the wire)
# ---------------------------------------------------------------------------


class _SnapListCache:
    """Memoized gRPC list encodes keyed off the store's COW read plane:
    the wrapped encode per (kind, ns), valid while the snapshot object is
    the current one (``_cow_publish`` replaces it on every publish, so
    identity proves nothing changed).  With the plane off
    (``MINISCHED_COW_READS=0``) every list takes the locked
    ``list_with_rv`` path, encoded uncached."""

    def __init__(self, store: Any):
        self._store = store
        self._mu = threading.Lock()
        self._cache: dict = {}  # (kind, ns) -> (snap, wrapped bytes)

    def list_bytes(self, kind: str, namespace: str) -> bytes:
        read_plane = getattr(self._store, "read_plane", None)
        snap = read_plane() if read_plane is not None else None
        key = (kind, namespace)
        if snap is not None:
            with self._mu:
                hit = self._cache.get(key)
            if hit is not None and hit[0] is snap:
                counters.inc("grpc.list_cache.hits")
                return hit[1]
            items = [
                _encode(o) for o in snap.maps.get(kind, {}).values()
                if not namespace or o.metadata.namespace == namespace
            ]
            body = _wrap_json(json.dumps(
                {"items": items, "resource_version": snap.rv}
            ).encode())
            counters.inc("grpc.list_cache.encodes")
            with self._mu:
                self._cache[key] = (snap, body)
            return body
        objs, rv = self._store.list_with_rv(kind)
        items = [
            _encode(o) for o in objs
            if not namespace or o.metadata.namespace == namespace
        ]
        counters.inc("grpc.list_cache.encodes")
        return _wrap_json(json.dumps(
            {"items": items, "resource_version": rv}
        ).encode())


#: per-stream out-buffer bound, in EVENTS — the gRPC analog of the
#: stream loop's byte bound: a consumer that stops reading while the
#: store keeps mutating gets EVICTED (OUT_OF_RANGE → relist), never
#: buffered without limit on the server's heap.
DEFAULT_WATCH_STREAM_EVENTS = 8192


#: the most bytes of event JSON one batched watch message carries, well
#: under grpc's default 4 MiB receive limit; a larger event goes alone
WATCH_BATCH_BYTES = 1 << 20


def _batched(frames: list, batch: int) -> list:
    """A stream's messages for ``frames`` (each one event's
    ``_event_wire``): the frames themselves when ``batch`` is 1 (JAX's
    wire), else messages ``{"events": [...]}`` of at most ``batch`` events
    and ``WATCH_BATCH_BYTES`` of event JSON, joined from the memoized
    lines without a second encode."""
    if batch <= 1:
        return frames
    out: list = []
    group: list = []
    size = 0
    for frame in frames:
        line = _unwrap_json(frame)
        if group and (len(group) >= batch
                      or size + len(line) > WATCH_BATCH_BYTES):
            out.append(_wrap_json(b'{"events": [' + b", ".join(group)
                                  + b"]}"))
            group, size = [], 0
        group.append(line)
        size += len(line)
    if group:
        out.append(_wrap_json(b'{"events": [' + b", ".join(group) + b"]}"))
    return out


def _event_wire(ev: Any) -> bytes:
    """One watch event's framed gRPC bytes (field-1 wrap of the JSON
    line), encoded ONCE and memoized on the event object — the store
    fans the SAME WatchEvent instance into every watcher queue, so N
    streams serializing one mutation cost one encode (the REST façade's
    ``event_wire_chunk``, re-framed).  Distinct attribute from ``wire``:
    the HTTP chunk framing and the proto framing are different bytes."""
    wire = ev.grpc_wire
    if wire is None:
        wire = _wrap_json(
            json.dumps(
                {
                    "type": ev.type.value,
                    "object": _encode(ev.obj),
                    "resource_version": int(ev.rv),
                }
            ).encode()
        )
        ev.grpc_wire = wire
        counters.inc("grpc.watch.encoded")
    else:
        counters.inc("grpc.watch.shared")
    return wire


class _HubStream:
    """One gRPC watch stream's hub-side half: a bounded deque of framed
    bytes the hub fills and the rpc generator drains."""

    def __init__(self, watch: Any, bound: int):
        self.watch = watch
        self.cond = threading.Condition()
        self.buf: list = []
        self.bound = int(bound)
        self.evicted = False
        self.ended = False  # underlying store watch stopped
        self.done = False  # rpc generator detached (hub must drop us)

    def push(self, frames: list) -> None:
        with self.cond:
            if self.done:
                return
            if len(self.buf) + len(frames) > self.bound:
                # laggard: its unread history is gone from this buffer
                # just as surely as from a compacted ring — evict, the
                # consumer relists (stream loop's eviction, ported)
                self.evicted = True
                counters.inc("grpc.watch.evicted")
            else:
                self.buf.extend(frames)
            self.cond.notify_all()

    def finish(self) -> None:
        with self.cond:
            self.ended = True
            self.cond.notify_all()


class _WatchHub:
    """The §23 stream-loop handoff, ported to the gRPC facade: ONE hub
    thread drains every adopted store watch, pays each event's encode
    once (``_event_wire``), and fans framed bytes into bounded
    per-stream buffers.  The rpc generators (whose threads the gRPC
    runtime owns regardless) only pop bytes and yield — no store access,
    no JSON work, no per-stream encode.  Edge-triggered: each adopted
    watch's ``set_notify`` pokes the hub condvar, so an idle hub sleeps
    instead of polling hot."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._streams: list = []
        self._thread: Optional[threading.Thread] = None

    def adopt(self, watch: Any, bound: int) -> _HubStream:
        hs = _HubStream(watch, bound)
        with self._cond:
            self._streams.append(hs)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="grpc-watch-hub", daemon=True
                )
                self._thread.start()
        watch.set_notify(self._wake)
        counters.inc("grpc.watch.streams")
        return hs

    def _wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def _run(self) -> None:
        while True:
            with self._cond:
                self._streams = [s for s in self._streams if not s.done]
                streams = list(self._streams)
            moved = False
            for hs in streams:
                batch = hs.watch.next_batch(timeout=0)
                if batch:
                    moved = True
                    counters.inc("grpc.watch.events", len(batch))
                    hs.push([_event_wire(ev) for ev in batch])
                elif hs.watch.stopped:
                    hs.finish()
            with self._cond:
                if not moved:
                    # capped wait: set_notify wakes us on the event edge,
                    # the timeout only backstops a missed registration
                    self._cond.wait(timeout=0.25)


def _handlers(store: Any = None, device: Any = None):
    import grpc

    def health(request_bytes: bytes, context) -> bytes:
        t0 = time.monotonic()
        try:
            return _wrap_json(json.dumps({"ok": True}).encode())
        finally:
            hist.observe(
                "grpc.request_s", time.monotonic() - t0, method="Health"
            )

    def evaluate(request_bytes: bytes, context) -> bytes:
        t0 = time.monotonic()
        try:
            request = json.loads(_unwrap_json(request_bytes).decode("utf-8"))
            return _wrap_json(json.dumps(
                evaluate_cluster(request, device=device)).encode())
        except (ValueError, KeyError) as err:
            # evaluate_cluster re-raises malformed-payload TypeErrors as
            # ValueError; evaluator bugs deliberately fall through as
            # server errors
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(err))
        finally:
            # aborts and evaluator crashes are observed too: latency of
            # the ANSWER, whatever the answer was
            hist.observe(
                "grpc.request_s", time.monotonic() - t0, method="Evaluate"
            )

    rpcs = {
        "Health": grpc.unary_unary_rpc_method_handler(
            health,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        ),
        "Evaluate": grpc.unary_unary_rpc_method_handler(
            evaluate,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        ),
    }
    if store is not None:
        cache = _SnapListCache(store)

        def list_objects(request_bytes: bytes, context) -> bytes:
            t0 = time.monotonic()
            try:
                request = json.loads(
                    _unwrap_json(request_bytes).decode("utf-8")
                )
                kind = request.get("kind", "")
                if kind not in KIND_TYPES:
                    raise ValueError(f"unknown kind {kind!r}")
                # rv-bounded read, same contract as the REST façade's
                # ?min_rv= (DESIGN.md §29): a bound past this replica's
                # applied rv is refused RETRYABLY (UNAVAILABLE, the
                # gRPC analog of the 504), never answered stale
                min_rv = int(request.get("min_rv", 0) or 0)
                if min_rv > 0:
                    counters.inc("wire.read.bounded_requests")
                    applied = int(
                        getattr(store, "applied_rv", lambda: 0)() or 0
                    )
                    if min_rv > applied:
                        counters.inc("wire.read.not_yet_observed")
                        context.abort(
                            grpc.StatusCode.UNAVAILABLE,
                            f"resource_version {min_rv} not yet observed "
                            f"by this replica (applied {applied})",
                        )
                return cache.list_bytes(
                    kind, str(request.get("namespace", ""))
                )
            except (ValueError, KeyError) as err:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(err))
            finally:
                hist.observe(
                    "grpc.request_s", time.monotonic() - t0, method="List"
                )

        rpcs["List"] = grpc.unary_unary_rpc_method_handler(
            list_objects,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        )

        hub = _WatchHub()

        def watch_stream(request_bytes: bytes, context):
            try:
                request = json.loads(
                    _unwrap_json(request_bytes).decode("utf-8")
                )
                kind = request.get("kind", "")
                if kind not in KIND_TYPES:
                    raise ValueError(f"unknown kind {kind!r}")
                resume_rv = request.get("resume_rv")
                send_initial = bool(request.get("send_initial", True))
                batch = int(request.get("batch", 1) or 1)
            except (ValueError, KeyError) as err:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(err))
            try:
                w, snapshot = store.watch(
                    kind,
                    send_initial=send_initial and resume_rv is None,
                    resume_rv=(
                        int(resume_rv) if resume_rv is not None else None
                    ),
                    clone_snapshot=False,
                )
            except HistoryCompacted as err:
                # the REST 410: the consumer's cursor predates the
                # retained tail — relist and re-watch
                context.abort(grpc.StatusCode.OUT_OF_RANGE, str(err))
            except NotYetObserved as err:
                # the REST 504: a follower lagging the resume point —
                # retryable, wait out the replication lag
                context.abort(grpc.StatusCode.UNAVAILABLE, str(err))
            sync = len(snapshot) if (send_initial and resume_rv is None) \
                else 0
            hs = hub.adopt(w, DEFAULT_WATCH_STREAM_EVENTS)
            try:
                yield _wrap_json(json.dumps(
                    {
                        "sync": sync,
                        "resource_version": int(
                            getattr(store, "applied_rv", lambda: 0)() or 0
                        ),
                    }
                ).encode())
                while context.is_active():
                    with hs.cond:
                        while (
                            not hs.buf
                            and not hs.evicted
                            and not hs.ended
                        ):
                            if not hs.cond.wait(timeout=1.0):
                                break
                        frames, hs.buf = hs.buf, []
                        evicted, ended = hs.evicted, hs.ended
                    for message in _batched(frames, batch):
                        yield message
                    if evicted:
                        context.abort(
                            grpc.StatusCode.OUT_OF_RANGE,
                            "watch stream evicted: consumer fell "
                            f"behind {DEFAULT_WATCH_STREAM_EVENTS} "
                            "buffered events — relist and re-watch",
                        )
                    if ended:
                        return
            finally:
                hs.done = True
                w.stop()

        rpcs["Watch"] = grpc.unary_stream_rpc_method_handler(
            watch_stream,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        )
    return grpc.method_handlers_generic_handler(SERVICE, rpcs)


def start_grpc_server(
    port: int = 0, max_workers: int = 4, store: Any = None,
    device: Any = None,
) -> Tuple[Any, str, Callable[[], None]]:
    """Serve the evaluator; returns (server, address, shutdown_fn) — the
    start_api_server shape (controlplane/httpserver.py).  With a
    ``store``, the ``List`` and ``Watch`` rpcs serve it; without one,
    they are unimplemented (evaluator-only shim).  ``device=None``
    evaluates on the card; ``device="cpu"`` on the CPU twins."""
    import grpc

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((_handlers(store, device),))
    bound_port = server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    address = f"127.0.0.1:{bound_port}"

    def shutdown() -> None:
        server.stop(grace=1.0).wait()

    return server, address, shutdown


class EvaluatorWatch:
    """Iterator half of ``EvaluatorClient.watch``: decodes each framed
    stream message to its JSON dict, one dict an event whether the server
    sent one event a message or batches (``messages`` counts the
    messages read); ``cancel()`` aborts the rpc (the server's generator
    unwinds and stops the store watch)."""

    def __init__(self, call: Any):
        self._call = call
        self._pending: list = []
        self.messages = 0

    def __iter__(self) -> "EvaluatorWatch":
        return self

    def __next__(self) -> dict:
        if self._pending:
            return self._pending.pop()
        raw = next(self._call)
        self.messages += 1
        msg = json.loads(_unwrap_json(raw).decode("utf-8"))
        events = msg.get("events")
        if events is None:
            return msg
        self._pending = events[::-1]
        return self._pending.pop()

    def cancel(self) -> None:
        self._call.cancel()


class EvaluatorClient:
    """Minimal Python client over the JSON-payload contract (any gRPC
    stack can do the same with bytes in/out)."""

    def __init__(self, address: str):
        import grpc

        self._channel = grpc.insecure_channel(address)

    def _call(self, method: str, payload: dict, timeout: float = 120.0) -> dict:
        fn = self._channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        raw = fn(
            _wrap_json(json.dumps(payload).encode()), timeout=timeout
        )
        return json.loads(_unwrap_json(raw).decode("utf-8"))

    def health(self) -> dict:
        return self._call("Health", {})

    def list(self, kind: str, namespace: str = "",
             timeout: float = 120.0) -> dict:
        """{"items": [encoded objects], "resource_version": rv} — the
        snapshot-consistent list rpc (requires the server to have been
        started with a store)."""
        return self._call(
            "List", {"kind": kind, "namespace": namespace}, timeout=timeout
        )

    def watch(
        self,
        kind: str,
        send_initial: bool = True,
        resume_rv: Optional[int] = None,
        timeout: Optional[float] = None,
        batch: int = 1,
    ) -> "EvaluatorWatch":
        """Open the server-streaming Watch rpc; returns an iterator of
        decoded JSON messages — the sync line first, then one dict per
        event (schema: the .proto's comments).  ``batch`` > 1 asks the
        server for up to that many events a message (the iterator still
        yields one dict an event).  ``cancel()`` tears the stream down
        server-side."""
        fn = self._channel.unary_stream(
            f"/{SERVICE}/Watch",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        payload: dict = {"kind": kind, "send_initial": send_initial}
        if resume_rv is not None:
            payload["resume_rv"] = int(resume_rv)
        if batch > 1:
            payload["batch"] = int(batch)
        call = fn(
            _wrap_json(json.dumps(payload).encode()), timeout=timeout
        )
        return EvaluatorWatch(call)

    def evaluate(
        self,
        nodes,
        pods,
        assigned=(),
        pvcs=(),
        pvs=(),
        mode: str = "repair",
        timeout: float = 120.0,
    ) -> dict:
        return self._call(
            "Evaluate",
            {
                "nodes": [_encode(n) for n in nodes],
                "pods": [_encode(p) for p in pods],
                "assigned": [_encode(p) for p in assigned],
                "pvcs": [_encode(c) for c in pvcs],
                "pvs": [_encode(v) for v in pvs],
                "mode": mode,
            },
            timeout=timeout,
        )

    def close(self) -> None:
        self._channel.close()
