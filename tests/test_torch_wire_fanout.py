"""The port's selector stream loop (``controlplane/streamloop.py``), on the
CPU: the cases of ``tests/test_wire_fanout.py`` against the port's
façade — many watch streams on one loop thread with one encode an event,
the replay written inline before live events, a socket-level laggard
evicted and resumed exactly once, ``MINISCHED_STREAMLOOP=0`` keeping a
thread a stream, and the out-buffer eviction.  The loop adopts a stream
after the SYNC line is written, so the adoption count is awaited against
a deadline here (JAX's copy reads it at once).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

from minisched_tpu_torch.api.objects import make_pod
from minisched_tpu_torch.controlplane.httpserver import start_api_server
from minisched_tpu_torch.controlplane.store import ObjectStore
from minisched_tpu_torch.observability import counters


class ChunkLineReader:
    """Minimal incremental reader for the watch verb's wire format:
    chunked-transfer frames each carrying (part of) JSON lines.  Feeds on
    raw socket bytes; yields decoded JSON objects (keepalive blank lines
    skipped).  ``eof`` flips on the terminal chunk or socket EOF."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = bytearray()
        self.payload = bytearray()
        self.eof = False

    def _parse_chunks(self) -> None:
        while True:
            nl = self.buf.find(b"\r\n")
            if nl < 0:
                return
            size = int(bytes(self.buf[:nl]), 16)
            if size == 0:
                self.eof = True
                return
            start, end = nl + 2, nl + 2 + size
            if len(self.buf) < end + 2:
                return  # incomplete frame
            self.payload += self.buf[start:end]
            del self.buf[: end + 2]

    def next_json(self, timeout: float = 5.0):
        """The next JSON line (None on timeout/EOF)."""
        deadline = time.monotonic() + timeout
        while True:
            nl = self.payload.find(b"\n")
            if nl >= 0:
                line = bytes(self.payload[:nl]).strip()
                del self.payload[: nl + 1]
                if not line:
                    continue  # keepalive
                return json.loads(line)
            if self.eof:
                return None
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            self.sock.settimeout(remaining)
            try:
                data = self.sock.recv(65536)
            except socket.timeout:
                return None
            except OSError:
                self.eof = True
                return None
            if not data:
                self.eof = True
                return None
            self.buf += data
            self._parse_chunks()

    def drain_available(self) -> list:
        """Parse everything already received (non-blocking), then until
        EOF/error — what an evicted client can still salvage."""
        out = []
        self.sock.settimeout(0.2)
        while True:
            try:
                data = self.sock.recv(65536)
            except (socket.timeout, OSError):
                break
            if not data:
                self.eof = True
                break
            self.buf += data
            self._parse_chunks()
        while True:
            nl = self.payload.find(b"\n")
            if nl < 0:
                break
            line = bytes(self.payload[:nl]).strip()
            del self.payload[: nl + 1]
            if line:
                out.append(json.loads(line))
        return out


def open_watch_socket(
    base: str, path: str = "/api/v1/pods?watch=true", rcvbuf: int = 0
):
    """One raw HTTP watch stream: returns (socket, reader) with response
    headers consumed and the stream positioned at the first chunk."""
    host, port = base.split("//")[1].split(":")
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    if rcvbuf:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
    s.connect((host, int(port)))
    s.sendall(
        f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode()
    )
    # read headers
    hdr = bytearray()
    s.settimeout(5.0)
    while b"\r\n\r\n" not in hdr:
        data = s.recv(4096)
        assert data, "connection closed before headers"
        hdr += data
    head, _, rest = bytes(hdr).partition(b"\r\n\r\n")
    assert b"200" in head.split(b"\r\n", 1)[0], head
    assert b"Transfer-Encoding: chunked" in head, head
    r = ChunkLineReader(s)
    r.buf += rest
    r._parse_chunks()
    return s, r


def test_many_watchers_one_loop_thread():
    """50 concurrent real HTTP watch streams: every handler thread
    returns to the pool after the handshake (thread count stays flat),
    the loop owns all 50 sockets, and one mutation reaches all 50
    streams through the encode-once fanout."""
    store = ObjectStore()
    base_threads = threading.active_count()
    server, base, shutdown = start_api_server(store)
    handler = server.RequestHandlerClass
    try:
        adopted0 = counters.get("wire.streams_adopted")
        streams = [open_watch_socket(base) for _ in range(50)]
        for _s, r in streams:
            sync = r.next_json()
            assert sync["type"] == "SYNC" and sync["count"] == 0
        # a stream is adopted after its SYNC line is written: await the
        # count against a deadline, not at once
        deadline = time.monotonic() + 10.0
        while (counters.get("wire.streams_adopted") < adopted0 + 50
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert counters.get("wire.streams_adopted") == adopted0 + 50
        loop = handler.stream_loop
        assert loop is not None
        deadline = time.monotonic() + 5.0
        while loop.stream_count() < 50 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert loop.stream_count() == 50
        # handler threads exited after detach: the process grew by the
        # serve_forever thread + the ONE loop thread (plus at most a
        # transiently-dying handler), NOT by 50 pinned watch threads
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if threading.active_count() <= base_threads + 3:
                break
            time.sleep(0.05)
        assert threading.active_count() <= base_threads + 3, (
            threading.enumerate()
        )

        enc0 = counters.get("watch.fanout.encoded")
        shr0 = counters.get("watch.fanout.shared")
        store.create("Pod", make_pod("fan1"))
        for _s, r in streams:
            ev = r.next_json()
            assert ev["type"] == "ADDED"
            assert ev["object"]["metadata"]["name"] == "fan1"
        # one encode, 49 shared reuses — the encode-once claim over the wire
        assert counters.get("watch.fanout.encoded") == enc0 + 1
        assert counters.get("watch.fanout.shared") == shr0 + 49
    finally:
        for s, _r in streams:
            s.close()
        shutdown()


def test_snapshot_replay_inline_then_live_events_in_order():
    """The handshake + snapshot replay happen BEFORE detach (handler
    thread, blocking writes); live events follow through the loop in
    order with no seam: SYNC(count=N), N ADDED replays, then live."""
    store = ObjectStore()
    for i in range(5):
        store.create("Pod", make_pod(f"seed{i}"))
    server, base, shutdown = start_api_server(store)
    try:
        s, r = open_watch_socket(base)
        sync = r.next_json()
        assert sync == {
            "type": "SYNC", "count": 5, "rv": store.resource_version
        }
        seen = [r.next_json()["object"]["metadata"]["name"] for _ in range(5)]
        assert sorted(seen) == [f"seed{i}" for i in range(5)]
        store.create("Pod", make_pod("live0"))
        ev = r.next_json()
        assert ev["object"]["metadata"]["name"] == "live0"
        s.close()
    finally:
        shutdown()


def test_evicted_watcher_resumes_exactly_once_over_wire():
    """Eviction-resume parity over REAL sockets (extends the queue-level
    coverage in test_churn): a watcher too slow at the socket level is
    evicted (bounded out-buffer, ``wire.evicted_outbuf``), reconnects
    with ``resource_version=<last seen>``, and observes every mutation
    EXACTLY once across the two streams — nothing missed, nothing
    duplicated.  A fast watcher on the same store is untouched."""
    store = ObjectStore()
    # small out-buffer + small client receive window: the laggard's
    # frames pile up server-side fast
    server, base, shutdown = start_api_server(
        store, stream_buffer_bytes=4096
    )
    try:
        slow_s, slow_r = open_watch_socket(base, rcvbuf=4096)
        fast_s, fast_r = open_watch_socket(base)
        assert slow_r.next_json()["type"] == "SYNC"
        assert fast_r.next_json()["type"] == "SYNC"

        # fat pods: each frame ~32KiB, so unread events overflow kernel
        # buffers + the 4KiB out-buffer quickly
        pad = "x" * 32768
        all_rvs = []
        ev0 = counters.get("wire.evicted_outbuf")
        fast_seen = []
        fast_stop = threading.Event()

        def consume_fast():
            while not fast_stop.is_set():
                ev = fast_r.next_json(timeout=1.0)
                if ev is not None:
                    fast_seen.append(ev["rv"])
                elif fast_r.eof:
                    return

        t = threading.Thread(target=consume_fast, daemon=True)
        t.start()
        # slow client reads the first 3 events, then stops consuming.
        # The mutations are PACED (sustained churn, not one burst): the
        # fast consumer must be able to keep up on one core — only the
        # wedged watcher may fall behind.
        slow_seen = []
        for i in range(60):
            p = make_pod(f"fat{i:03d}", labels={"pad": pad})
            all_rvs.append(
                store.create("Pod", p).metadata.resource_version
            )
            if i < 3:
                ev = slow_r.next_json()
                if ev is not None:
                    slow_seen.append(ev["rv"])
            time.sleep(0.01)
        # the laggard must get evicted (socket dies under it); keep
        # mutating until the kernel's autotuned buffers fill
        deadline = time.monotonic() + 20.0
        j = 0
        while (
            counters.get("wire.evicted_outbuf") == ev0
            and time.monotonic() < deadline
        ):
            p = make_pod(f"tick{j:04d}", labels={"pad": pad})
            all_rvs.append(
                store.create("Pod", p).metadata.resource_version
            )
            j += 1
            time.sleep(0.02)
        assert counters.get("wire.evicted_outbuf") > ev0

        # salvage what the kernel already delivered, then resume
        for ev in slow_r.drain_available():
            slow_seen.append(ev["rv"])
        assert slow_r.eof  # the eviction killed the stream abruptly
        slow_s.close()
        assert slow_seen, "slow watcher saw nothing before eviction"
        last = max(slow_seen)
        # FIFO delivery: what the evicted client salvaged is a clean
        # PREFIX of the mutation sequence — the loss starts after `last`
        assert slow_seen == [rv for rv in all_rvs if rv <= last]
        s2, r2 = open_watch_socket(
            base, path=f"/api/v1/pods?watch=true&resource_version={last}"
        )
        sync = r2.next_json()
        assert sync["type"] == "SYNC" and sync["count"] == 0
        expect = [rv for rv in all_rvs if rv > last]
        resumed = []
        while len(resumed) < len(expect):
            ev = r2.next_json(timeout=10.0)
            assert ev is not None, (
                f"resume stalled: {len(resumed)}/{len(expect)}"
            )
            resumed.append(ev["rv"])
        # EXACTLY once: pre-eviction prefix + resumed tail = the full
        # mutation sequence, nothing missed, nothing duplicated
        assert resumed == expect
        assert not (set(slow_seen) & set(resumed))
        assert slow_seen + resumed == all_rvs
        s2.close()
        # the fast watcher rode through the whole episode un-evicted
        fast_stop.set()
        t.join(timeout=20.0)
        assert len(fast_seen) >= 60
        fast_s.close()
    finally:
        shutdown()


def test_streamloop_killswitch_restores_thread_path(monkeypatch):
    """MINISCHED_STREAMLOOP=0: no stream loop exists, no stream is ever
    adopted, and the watch verb serves from its dedicated handler thread
    exactly as before — same SYNC line, same frames, same teardown."""
    monkeypatch.setenv("MINISCHED_STREAMLOOP", "0")
    store = ObjectStore()
    server, base, shutdown = start_api_server(store)
    try:
        assert server.RequestHandlerClass.stream_loop is None
        adopted0 = counters.get("wire.streams_adopted")
        s, r = open_watch_socket(base)
        assert r.next_json()["type"] == "SYNC"
        store.create("Pod", make_pod("threaded"))
        ev = r.next_json()
        assert ev["object"]["metadata"]["name"] == "threaded"
        assert counters.get("wire.streams_adopted") == adopted0
        s.close()
    finally:
        shutdown()


def test_outbuf_eviction_unit():
    """Unit-level: a socket whose kernel never accepts bytes (send
    always blocks) grows its out-buffer to the bound and is evicted —
    abrupt close, watch stopped, registration pruned."""
    from minisched_tpu_torch.controlplane.streamloop import StreamLoop

    class BlockedSocket:
        """Wraps one end of a socketpair; send pretends the kernel
        buffer is permanently full."""

        def __init__(self, sock):
            self._sock = sock
            self.closed = False

        def fileno(self):
            return self._sock.fileno()

        def setblocking(self, flag):
            self._sock.setblocking(flag)

        def send(self, data):
            raise BlockingIOError()

        def recv(self, n):
            raise BlockingIOError()

        def close(self):
            self.closed = True
            self._sock.close()

    store = ObjectStore()
    loop = StreamLoop(max_buffer_bytes=4096)
    a, b = socket.socketpair()
    wrapped = BlockedSocket(a)
    try:
        watch, _ = store.watch("Pod", send_initial=False)
        loop.adopt(wrapped, watch, "")
        ev0 = counters.get("wire.evicted_outbuf")
        pad = "y" * 2048
        deadline = time.monotonic() + 10.0
        i = 0
        while (
            counters.get("wire.evicted_outbuf") == ev0
            and time.monotonic() < deadline
        ):
            store.create("Pod", make_pod(f"blk{i}", labels={"pad": pad}))
            i += 1
            time.sleep(0.02)
        assert counters.get("wire.evicted_outbuf") == ev0 + 1
        deadline = time.monotonic() + 5.0
        while not watch.stopped and time.monotonic() < deadline:
            time.sleep(0.02)
        assert watch.stopped
        assert wrapped.closed
        assert loop.stream_count() == 0
        # the store pruned the dead registration on its next fanout
        store.create("Pod", make_pod("after"))
        with store.locked():
            assert not [
                w for w in store._watches.get("Pod", ()) if not w.stopped
            ]
    finally:
        loop.stop()
        b.close()


#: ``python3 -c`` body running ``bench.role_wire_fanout`` in a process of
#: its own (its thread-count gate counts the whole process's threads), the
#: sampled-against-live p99 replaced by a check that every sampled delivery
#: reached the live histogram; prints the record and that check's inputs
_FANOUT_CHILD = """
import json
from minisched_tpu_torch import bench
from minisched_tpu_torch.observability import hist
seen = {}
def reached(name, sampled_p99, role):
    seen.update(name=name, count=hist.GLOBAL.merged(name)[3], p99=sampled_p99)
    return {"lo_s": None, "le_s": None}
bench._crosscheck_live_p99 = reached
rec = bench.role_wire_fanout()
rec.pop("metrics_snapshot", None)
print(json.dumps({"rec": rec, "seen": seen}))
"""


def test_wire_fanout_role_at_a_small_size():
    """``bench.role_wire_fanout`` (``--only wire_fanout``) at 30 watchers,
    one of them wedged, with a small out-buffer so it is evicted, in a
    process of its own: ``bench.py``'s gates hold (thread count, the
    shared encode, the eviction resumed exactly once, every event
    delivered, p99 delivery latency under its gate).  The sampled p99 is
    held against the live ``watch.delivery_lag_s`` on the card's host
    only: under the suite's parallel workers the client thread's
    scheduler wake-ups (tens of ms) exceed the server-side lag it is
    compared with.  Here every sampled delivery must be in the live
    histogram."""
    env = dict(os.environ, BENCH_WIRE_WATCHERS="30", BENCH_WIRE_SLOW="1",
               BENCH_WIRE_WINDOW_S="4", BENCH_WIRE_OUTBUF="8192",
               BENCH_WIRE_SNDBUF="4096", BENCH_WIRE_PAD="2048")
    proc = subprocess.run([sys.executable, "-c", _FANOUT_CHILD], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    rec, seen = out["rec"], out["seen"]
    assert seen["name"] == "watch.delivery_lag_s"
    assert seen["count"] >= rec["delivery_samples"] > 0
    assert seen["p99"] == rec["delivery_p99_s"]
    assert rec["evictions"] >= 1 and rec["resumed_exactly_once"] >= 1
    assert rec["fanout_encoded"] * 10 <= rec["fanout_shared"]
