"""Selector-based watch-stream fanout: N watchers, N sockets, ONE thread.

The thread-per-watcher wire path (``httpserver._watch``) pins an OS
thread for the whole life of every watch stream — fine at informer
counts, fatal at the ROADMAP's thousands-of-watchers regime: 1k watchers
= 1k blocked threads before the first event flows.  ``StreamLoop``
decouples watcher count from thread count.  A copy of
``minisched_tpu/controlplane/streamloop.py`` (``:1-467``):

* After the handshake and the snapshot/resume replay (written inline by
  the handler thread, whose blocking writes are the right tool for a
  possibly-huge backlog), the handler DETACHES the connection's socket
  and hands it here; the handler thread returns to the pool immediately.
* One event-loop thread owns every detached socket through a
  ``selectors`` multiplexer: store-side ``Watch`` queues edge-trigger a
  wakeup pipe (``Watch.set_notify``), the loop drains them
  non-blockingly, frames each event ONCE via the memoized
  ``event_wire_chunk``, and writes from per-socket bounded out-buffers.
* Backpressure composes with the existing degrade-the-laggard story: a
  consumer too slow at the SOCKET level grows its out-buffer to the
  bound and is evicted (``wire.evicted_outbuf``) exactly like the
  store-level queue eviction — the stream dies, the client reconnects
  through resume/410→relist.  Store-level eviction
  (``watch.fanout.evicted_slow``) and server shutdown surface to the
  loop as ``watch.stopped`` and end the stream with the terminal chunk,
  byte-identical to the thread path.  Client hangups are counted in the
  same ``watch.disconnects`` the thread path uses and pruned
  immediately.

The handshake's registration snapshot comes off the COW
read plane (``store._watch_cow``): registration is a lock-free reference
grab, and the snapshot-replay events a cold-boot storm writes inline are
SHARED ``WatchEvent`` objects — ``event_wire_chunk`` memoizes their wire
bytes on first use, so N watchers replaying the same snapshot cost one
encode per object, not N (``watch.fanout.shared``).  Shared replay
events carry ``born == 0.0`` and are skipped by the delivery-lag
observation below — replay is catch-up, not fanout.

``MINISCHED_STREAMLOOP=0`` disables adoption entirely and restores the
thread-per-watcher path exactly (see ``start_api_server``).
"""

from __future__ import annotations

import os
import selectors
import socket
import threading
import time
import traceback
from typing import Any, List, Optional

from minisched_tpu_torch.observability import counters

# safe non-cycle: httpserver imports THIS module only lazily (inside
# start_api_server), so the wire-framing definitions resolve at module
# load from either import order
from minisched_tpu_torch.controlplane.httpserver import (  # noqa: E402
    _chunk_frame,
    event_wire_chunk,
)

#: per-stream out-buffer bound, in BYTES.  The store-side Watch queue is
#: bounded in EVENTS (65536) — once frames land here they are bytes the
#: kernel refused, so the bound is a byte budget: a consumer this far
#: behind at the socket level is evicted onto the resume path rather
#:  than pinning encoded frames for the life of the wedge.  Sized to
#: absorb a full wave's bind fanout of ~200-byte frames for one stream.
DEFAULT_MAX_BUFFER_BYTES = 8 * 1024 * 1024

#: idle keepalive cadence — matches the thread path's 0.5s ``chunk(b"\n")``
#: so clients (and their read timeouts) can't tell the paths apart
KEEPALIVE_S = 0.5

#: SO_SNDBUF cap applied to every adopted socket.  Linux autotunes a
#: loopback TCP send buffer to 4MB+ even when the receiver's window is
#: tiny — so ONE wedged client pins ~4MB of kernel memory and the
#: out-buffer bound (the eviction trigger) may not fill for megabytes of
#: backlog.  Capping sndbuf makes per-stream memory ≈ sndbuf + out-buffer
#: BOUNDED, and makes the laggard visible to the eviction policy while
#: healthy consumers never notice (the loop's buffered writes absorb
#: bursts above it).  The kernel doubles the set value.
DEFAULT_STREAM_SNDBUF_BYTES = 128 * 1024

#: terminal chunk: the standard chunked-transfer end marker the thread
#: path writes on orderly stream end
_TERMINAL = b"0\r\n\r\n"

#: the idle keepalive frame, prebuilt once from the ONE framing
#: definition (1000 idle streams would otherwise rebuild it ~2000×/s)
_KEEPALIVE_FRAME = _chunk_frame(b"\n")


class _Stream:
    """One adopted watch socket: its store watch, namespace filter, and
    pending out-bytes.  Owned exclusively by the loop thread after
    adoption (the adopt queue is the only cross-thread handoff)."""

    __slots__ = (
        "sock", "watch", "ns", "buf", "last_tx", "closing", "closed",
        "want_write",
    )

    def __init__(self, sock: socket.socket, watch: Any, ns: str):
        self.sock = sock
        self.watch = watch
        self.ns = ns
        self.buf = bytearray()
        self.last_tx = time.monotonic()
        #: terminal chunk queued (watch ended): close once buf drains
        self.closing = False
        self.closed = False
        #: registered for EVENT_WRITE (kernel buffer was full)
        self.want_write = False


class StreamLoop:
    """The single-threaded selector loop owning all detached watch
    sockets.  ``adopt`` is the only entry point other threads use."""

    def __init__(
        self,
        max_buffer_bytes: int = DEFAULT_MAX_BUFFER_BYTES,
        keepalive_s: float = KEEPALIVE_S,
        sndbuf_bytes: Optional[int] = DEFAULT_STREAM_SNDBUF_BYTES,
    ):
        self._max_buffer = max(int(max_buffer_bytes), 4096)
        self._keepalive_s = keepalive_s
        self._sndbuf_bytes = sndbuf_bytes
        self._sel = selectors.DefaultSelector()
        # wakeup pipe: Watch notify callbacks and adopt() write one byte
        # to interrupt the selector wait (writes are non-blocking; a full
        # pipe is already a wakeup)
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._lock = threading.Lock()
        self._adopt_q: List[_Stream] = []
        self._pending: set = set()  # streams whose watch signalled events
        self._streams: set = set()
        self._stopped = False
        self._last_sweep = 0.0
        self._thread = threading.Thread(
            target=self._run, name="watch-streamloop", daemon=True
        )
        self._thread.start()

    # -- cross-thread entry points -----------------------------------------
    def adopt(self, sock: socket.socket, watch: Any, ns: str) -> None:
        """Take ownership of a handshaken watch socket (handler thread
        calls this once, then returns).  The caller must have flushed
        everything it wrote; event order is preserved because the watch
        queue is FIFO and the handler drained it before handing off."""
        sock.setblocking(False)
        if self._sndbuf_bytes:
            try:
                sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_SNDBUF, self._sndbuf_bytes
                )
            except (OSError, AttributeError):
                pass  # non-TCP test doubles etc.: the cap is best-effort
        stream = _Stream(sock, watch, ns)
        with self._lock:
            if self._stopped:
                raise RuntimeError("stream loop is stopped")
            self._adopt_q.append(stream)
        counters.inc("wire.streams_adopted")
        # edge-trigger: any queued/arriving event (or stop/evict) marks
        # the stream pending and pokes the selector.  set_notify fires
        # the callback immediately if events are already queued, so the
        # gap between the handler's drain and this registration is safe.
        watch.set_notify(lambda: self._mark_pending(stream))
        self._wake()

    def stop(self) -> None:
        """Shut the loop down: stop every owned watch, best-effort
        terminal chunk, close every socket, join the thread."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        self._wake()
        self._thread.join(timeout=5.0)
        # anything the loop didn't get to (or adopted-but-unregistered)
        with self._lock:
            leftovers = list(self._streams) + self._adopt_q
            self._adopt_q = []
        for stream in leftovers:
            self._close_stream(stream, graceful=True, unregister=False)
        try:
            self._sel.close()
        except Exception:
            pass
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass

    def stream_count(self) -> int:
        with self._lock:
            return len(self._streams)

    # -- loop internals -----------------------------------------------------
    def _wake(self) -> None:
        try:
            os.write(self._wake_w, b"\x00")
        except (BlockingIOError, OSError):
            pass  # pipe full or closing: a wakeup is already pending

    def _mark_pending(self, stream: _Stream) -> None:
        # called from mutator threads under the watch condvar: O(1),
        # lock-free beyond our own mutex, never blocks on the socket
        with self._lock:
            if stream.closed:
                return
            self._pending.add(stream)
        self._wake()

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stopped:
                    return
            try:
                self._run_once()
            except Exception:
                # the thread that owns EVERY stream must never die: in
                # the thread-per-watcher path an unexpected exception
                # killed one handler; here it would silently wedge all
                # 1k streams until their read timeouts.  Log, breathe,
                # keep serving the others.
                traceback.print_exc()
                time.sleep(0.05)

    def _guarded(self, fn, stream: _Stream) -> None:
        """Run one per-stream step; an unexpected exception (an
        unserializable event, a selector edge) kills THAT stream only —
        same blast radius the thread path had."""
        try:
            fn(stream)
        except Exception:
            traceback.print_exc()
            try:
                self._disconnect(stream)
            except Exception:
                pass

    def _run_once(self) -> None:
        for key, mask in self._sel.select(self._keepalive_s / 2):
            if key.data is None:  # wakeup pipe
                try:
                    while os.read(self._wake_r, 4096):
                        pass
                except (BlockingIOError, OSError):
                    pass
                continue
            stream = key.data
            if mask & selectors.EVENT_READ:
                self._guarded(self._on_readable, stream)
            if not stream.closed and mask & selectors.EVENT_WRITE:
                self._guarded(self._flush, stream)
        # adoptions: register and do a first drain (events may have
        # queued between the handler's inline replay and now)
        with self._lock:
            adopts, self._adopt_q = self._adopt_q, []
        for stream in adopts:
            try:
                self._sel.register(
                    stream.sock, selectors.EVENT_READ, stream
                )
            except (ValueError, KeyError, OSError):
                self._disconnect(stream, registered=False)
                continue
            with self._lock:
                self._streams.add(stream)
            counters.set_gauge("wire.streams_active", len(self._streams))
            self._guarded(self._drain_watch, stream)
        # watches that signalled new events (or stop/evict).  A
        # stream signalled between the adopt swap above and here may
        # not be REGISTERED yet (still queued for the next
        # iteration's adoption): skip it — adoption always does a
        # first drain, and draining an unregistered stream would
        # turn a first-write pushback (sel.modify on an unknown fd)
        # into a spurious disconnect.
        with self._lock:
            pending, self._pending = self._pending, set()
        for stream in pending:
            if not stream.closed and stream in self._streams:
                self._guarded(self._drain_watch, stream)
        # periodic sweep: evict wedged streams still over the bound
        # (they may get no further deliveries to trigger the check in
        # _drain_watch) and write idle keepalives, same cadence/bytes
        # as the thread path.  TIME-GATED: under a sustained event rate
        # the loop wakes per notify, and an O(streams) scan per wakeup
        # would tax every delivery at 1k watchers for work that only
        # needs to run at keepalive cadence.
        now = time.monotonic()
        if now - self._last_sweep < self._keepalive_s / 2:
            return
        self._last_sweep = now
        for stream in list(self._streams):
            if stream.closed:
                continue
            if len(stream.buf) > self._max_buffer:
                self._guarded(self._evict_if_still_over, stream)
            elif (
                not stream.closing
                and not stream.buf
                and now - stream.last_tx >= self._keepalive_s
            ):
                stream.buf += _KEEPALIVE_FRAME
                counters.inc("wire.keepalives")
                self._guarded(self._flush, stream)

    def _evict_if_still_over(self, stream: _Stream) -> None:
        """The out-buffer eviction rule, gated on EXISTING lag (the same
        contract the store's ``_deliver_many`` follows:
        one oversized fanout batch must not evict caught-up watchers —
        the bound is soft by one batch).  Give the kernel one more
        chance to take the backlog; a stream STILL over the bound has
        had at least one delivery (or loop tick) to drain and is the
        socket-level laggard: die like a dropped stream (abrupt close,
        no terminal chunk — the client must treat it as a network
        failure and resume), freeing the buffer now."""
        self._flush(stream)
        if not stream.closed and len(stream.buf) > self._max_buffer:
            counters.inc("wire.evicted_outbuf")
            self._close_stream(stream, graceful=False)

    def _drain_watch(self, stream: _Stream) -> None:
        """Move queued watch events into the out-buffer (encode-once via
        the memoized wire chunk), then flush what the kernel will take."""
        # eviction BEFORE the fresh batch: only lag left over from
        # previous deliveries counts (see _evict_if_still_over) — a
        # healthy consumer hit by one huge create_many fanout buffers it
        # whole and drains; a wedged one dies at its NEXT delivery or
        # loop tick, so over-bound memory is pinned for at most one
        # tick, not the life of the wedge.
        if len(stream.buf) > self._max_buffer:
            self._evict_if_still_over(stream)
            if stream.closed:
                return
        watch = stream.watch
        events = watch.next_batch(timeout=0)
        if events:
            from minisched_tpu_torch.observability import hist

            now = time.monotonic()
            ns = stream.ns
            for ev in events:
                if ns and ev.obj.metadata.namespace != ns:
                    continue
                stream.buf += event_wire_chunk(ev)
                if ev.born:
                    # store-fanout→socket-write lag for THIS stream
                    hist.observe(
                        "watch.delivery_lag_s", max(now - ev.born, 0.0)
                    )
        if watch.stopped and not stream.closing:
            # store-side end of stream: eviction, server shutdown, or an
            # explicit stop — orderly terminal chunk, then close, exactly
            # like the thread path's exit
            stream.buf += _TERMINAL
            stream.closing = True
        if stream.buf:
            self._flush(stream)

    def _flush(self, stream: _Stream) -> None:
        sock = stream.sock
        buf = stream.buf
        try:
            while buf:
                n = sock.send(buf)
                del buf[:n]
        except (BlockingIOError, InterruptedError):
            counters.inc("wire.partial_writes")
        except OSError:
            self._disconnect(stream)
            return
        stream.last_tx = time.monotonic()
        if buf and not stream.want_write:
            stream.want_write = True
            try:
                self._sel.modify(
                    sock,
                    selectors.EVENT_READ | selectors.EVENT_WRITE,
                    stream,
                )
            except (ValueError, KeyError, OSError):
                self._disconnect(stream)
                return
        elif not buf:
            if stream.want_write:
                stream.want_write = False
                try:
                    self._sel.modify(sock, selectors.EVENT_READ, stream)
                except (ValueError, KeyError, OSError):
                    self._disconnect(stream)
                    return
            if stream.closing:
                # terminal chunk fully on the wire: orderly close
                self._close_stream(stream, graceful=True)

    def _on_readable(self, stream: _Stream) -> None:
        """Watch clients never send after the request — readable means
        hangup (EOF/RST) or stray bytes we discard like the thread path's
        never-read rfile."""
        try:
            data = stream.sock.recv(4096)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._disconnect(stream)
            return
        if not data:
            self._disconnect(stream)

    def _disconnect(self, stream: _Stream, registered: bool = True) -> None:
        """Client hung up (or the socket died): same accounting as the
        thread path's OSError branch — count it, stop the watch so the
        store prunes the registration immediately, free the buffer."""
        if stream.closed:
            return
        counters.inc("watch.disconnects")
        self._close_stream(stream, graceful=False, unregister=registered)

    def _close_stream(
        self,
        stream: _Stream,
        graceful: bool,
        unregister: bool = True,
    ) -> None:
        if stream.closed:
            return
        stream.closed = True
        stream.buf = bytearray()
        try:
            stream.watch.set_notify(None)
        except Exception:
            pass
        try:
            stream.watch.stop()
        except Exception:
            pass
        if unregister:
            try:
                self._sel.unregister(stream.sock)
            except (KeyError, ValueError, OSError):
                pass
        if graceful:
            # best-effort terminal bytes for shutdown paths that didn't
            # queue them (a closing stream already wrote its own)
            if not stream.closing:
                try:
                    stream.sock.send(_TERMINAL)
                except OSError:
                    pass
        try:
            stream.sock.close()
        except OSError:
            pass
        with self._lock:
            self._streams.discard(stream)
            self._pending.discard(stream)
            n = len(self._streams)
        counters.set_gauge("wire.streams_active", n)
