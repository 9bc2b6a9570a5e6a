"""The port's read-plane chaos (JAX ``tests/test_read_chaos.py``) on the
CPU: the follower-serving read plane under real process-level failure.

The port's copies of JAX's tests, under JAX's names.  A 3-replica
process plane of the port's replica children (``controlplane/replproc``)
serves rv-bounded reads from every replica (watermark stamped,
unsatisfiable bounds typed 504, watch fanout live on a follower façade
over real HTTP); interleaved reads across randomly chosen replicas under
6-writer load hold session-monotonic rvs and read-your-writes at the
returned watermark (seeded by ``MINISCHED_CHAOS_SEED``).  The soak keeps
JAX's ``slow`` mark.  Every wait has its own deadline and every plane is
stopped in ``finally``.
"""

from __future__ import annotations

import http.client
import json
import os
import random
import threading
import time
import urllib.parse

import pytest

from minisched_tpu_torch.api.objects import make_pod
from minisched_tpu_torch.controlplane.durable import DurableObjectStore
from minisched_tpu_torch.controlplane.httpserver import start_api_server
from minisched_tpu_torch.controlplane.remote import (
    RemoteClient,
    RemoteStore,
    _TRANSIENT_ERRORS,
)
from minisched_tpu_torch.controlplane.repl import ReplRuntime, WalFollower
from minisched_tpu_torch.controlplane.replproc import ReplicatedPlane
from minisched_tpu_torch.controlplane.store import (
    HistoryCompacted,
    NotYetObserved,
)

TTL_S = 1.0
SEED = int(os.environ.get("MINISCHED_CHAOS_SEED", "1234"))


def _http_get(base_url, path):
    u = urllib.parse.urlparse(base_url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _partition_arbiter(leader, others) -> None:
    for o in others:
        leader.net_control({
            "op": "cut", "src": leader.replica_id, "dst": o.replica_id,
            "channel": "arbiter",
        })
        o.net_control({
            "op": "cut", "src": o.replica_id, "dst": leader.replica_id,
            "channel": "arbiter",
        })


def _heal_all(plane) -> None:
    for r in plane.replicas:
        if r.alive():
            r.net_control({"op": "heal_all"})


def _wait_fenced(sup, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        s = sup.status()
        if s is not None and (s.get("role") != "leader" or s.get("fenced")):
            return
        time.sleep(0.05)
    raise AssertionError(
        f"{sup.replica_id} still an unfenced leader after {timeout_s}s"
    )


def test_every_replica_serves_bounded_reads(tmp_path):
    """Process-plane smoke: all three replicas answer rv-bounded reads
    with the X-Minisched-RV watermark; a bound the replica has not
    applied yet is a typed 504 (never a silently stale 200); and a
    watch attached to a FOLLOWER façade observes replicated creates
    live over real HTTP — §23 fanout runs on every replica."""
    plane = ReplicatedPlane(str(tmp_path), n=3, fsync=True, ttl_s=TTL_S)
    try:
        url = plane.start()
        client = RemoteClient(url, timeout_s=10.0)
        for i in range(8):
            client.pods().create(make_pod(f"pre-{i}"))
        rv = int(client.store.list_with_rv("Pod")[1])
        leader = plane.leader()
        assert leader is not None
        followers = [r for r in plane.replicas if r is not leader]

        # watch on a follower BEFORE the next writes: live fanout proof
        frs = RemoteStore(followers[0].base_url, timeout_s=10.0)
        w, snap = frs.watch("Pod", resume_rv=rv)
        assert snap == []

        for r in plane.replicas:
            deadline = time.monotonic() + 10.0
            while True:
                st, hdrs, body = _http_get(
                    r.base_url, f"/api/v1/pods?min_rv={rv}"
                )
                if st == 200:
                    break
                assert st == 504 and b"not yet observed" in body, (
                    f"{r.replica_id}: HTTP {st} {body[:120]}"
                )
                assert time.monotonic() < deadline, (
                    f"{r.replica_id} never applied rv {rv}"
                )
                time.sleep(0.05)
            assert int(hdrs["X-Minisched-RV"]) >= rv
            assert len(json.loads(body)["items"]) == 8
            # a bound from the future is typed-retryable, not stale
            st, _h, body = _http_get(
                r.base_url, f"/api/v1/pods?min_rv={rv + 1000}"
            )
            assert st == 504 and b"not yet observed" in body, r.replica_id

        client.pods().create(make_pod("fanout-live"))
        ev = w.next(timeout=10.0)
        assert ev is not None and ev.obj.metadata.name == "fanout-live"
        assert ev.rv > rv
        w.stop()
        frs.close()
    finally:
        plane.stop()


class _InprocReadPlane:
    """In-process leader + 2 served followers (each façade carries a
    follower ReplRuntime so /repl/status routes writes) — cheap enough
    for the tier-1 property test's thousands of interleaved reads."""

    def __init__(self, tmp_path):
        self.leader = DurableObjectStore(
            str(tmp_path / "leader.wal"), fsync=False
        )
        self.runtime = ReplRuntime(
            self.leader, "r0", peers=[], cluster_size=3, ack_timeout_s=10.0
        )
        self.runtime.promote()
        _srv, self.leader_url, self._shutdown = start_api_server(
            self.leader, port=0, repl=self.runtime
        )
        self.followers = []
        for i in range(2):
            fid = f"r{i + 1}"
            fstore = DurableObjectStore(
                str(tmp_path / f"{fid}.wal"), fsync=False
            )
            fstore.fence("r0")
            tail = WalFollower(fstore, self.leader_url, fid)
            tail.start()
            frt = ReplRuntime(fstore, fid, peers=[], cluster_size=3)
            frt.leader_id = "r0"
            _fs, furl, fshutdown = start_api_server(
                fstore, port=0, repl=frt
            )
            self.followers.append((fid, fstore, tail, furl, fshutdown, frt))

    def urls(self):
        return [self.leader_url] + [f[3] for f in self.followers]

    def close(self):
        for _fid, _fs, _tail, _furl, fshutdown, frt in self.followers:
            fshutdown()
            frt.close()
        self._shutdown()
        for _fid, fstore, tail, _furl, _sd, _rt in self.followers:
            tail.stop()
        for _fid, fstore, tail, _furl, _sd, _rt in self.followers:
            tail.join(timeout=5.0)
            fstore.close()
        self.runtime.close()
        self.leader.close()


def test_property_interleaved_reads_across_replicas(tmp_path):
    """Property test: under 6-writer load, a session that
    interleaves lists across RANDOMLY-chosen replicas (leader included)
    never sees its rv watermark move backwards, and every write acked
    at rv ≤ the returned watermark is present in the listing
    (read-your-writes once applied_rv passes the ack)."""
    rng = random.Random(SEED)
    plane = _InprocReadPlane(tmp_path)
    acked: dict = {}
    acked_mu = threading.Lock()
    stop = threading.Event()
    errs: list = []

    def writer(w: int) -> None:
        wc = RemoteClient(plane.leader_url, timeout_s=10.0)
        i = 0
        while not stop.is_set():
            name = f"w{w}-{i:04d}"
            try:
                created = wc.pods().create(make_pod(name))
            except Exception as e:  # pragma: no cover - fail the audit
                errs.append(f"writer {w}: {e!r}")
                return
            with acked_mu:
                acked[name] = created.metadata.resource_version
            i += 1
            time.sleep(0.002)

    writers = [
        threading.Thread(target=writer, args=(w,)) for w in range(6)
    ]
    bases = None
    try:
        for t in writers:
            t.start()
        urls = plane.urls()
        rs = RemoteStore(urls[1], endpoints=[urls[2], urls[0]],
                         timeout_s=10.0)
        bases = rs._endpoints
        last_rv = 0
        deadline = time.monotonic() + 4.0
        reads = 0
        while time.monotonic() < deadline:
            rs._read_base = rng.choice(bases)
            with acked_mu:
                floor = dict(acked)
            pods, rv = rs.list_with_rv("Pod")
            assert rv >= last_rv, (
                f"rv regressed {last_rv} -> {rv} on {rs._read_base}"
            )
            last_rv = rv
            present = {p.metadata.name for p in pods}
            missing = {
                n for n, arv in floor.items()
                if arv <= rv and n not in present
            }
            assert not missing, (
                f"read at rv {rv} on {rs._read_base} is missing acked "
                f"writes: {sorted(missing)[:5]}"
            )
            reads += 1
        assert reads >= 20, f"property loop too quiet: {reads} reads"
        assert rs.session_rv >= last_rv
        rs.close()
    finally:
        stop.set()
        for t in writers:
            t.join(timeout=10.0)
        plane.close()
    assert not errs, errs
    assert len(acked) >= 100, f"writers too quiet: {len(acked)} acked"


class _Watcher:
    """One endpoint-aware watch consumer: opens on its home replica,
    records every delivered (rv, name), and on stream death resumes at
    its last delivered rv — the exactly-once contract under audit."""

    def __init__(self, idx: int, home: str, others: list):
        self.idx = idx
        self.rs = RemoteStore(home, endpoints=others, timeout_s=10.0)
        self.rvs: list = []
        self.names: set = set()
        self.last_rv = 0
        self.resumes = 0
        self.errs: list = []
        self._thread = threading.Thread(
            target=self._run, name=f"watcher-{idx}", daemon=True
        )

    def start(self, stop_evt, target_rv):
        self._stop = stop_evt
        self._target = target_rv
        self._thread.start()

    def join(self, timeout):
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def _open(self):
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            try:
                if self.last_rv > 0:
                    w, _ = self.rs.watch("Pod", resume_rv=self.last_rv)
                    self.resumes += 1
                else:
                    w, _ = self.rs.watch("Pod")
                return w
            except HistoryCompacted as e:
                self.errs.append(f"resume {self.last_rv} compacted: {e}")
                return None
            except (NotYetObserved, RuntimeError):
                time.sleep(0.2)
            except _TRANSIENT_ERRORS:
                time.sleep(0.2)
        self.errs.append(f"could not (re)open a stream at {self.last_rv}")
        return None

    def _run(self):
        w = self._open()
        if w is None:
            return
        while True:
            ev = w.next(timeout=0.5)
            if ev is not None:
                if ev.rv <= self.last_rv:
                    self.errs.append(
                        f"duplicate/regressed rv {ev.rv} after "
                        f"{self.last_rv}"
                    )
                    continue
                self.rvs.append(ev.rv)
                self.last_rv = ev.rv
                self.names.add(ev.obj.metadata.name)
                continue
            if self._stop.is_set() and self.last_rv >= self._target[0] > 0:
                break
            if w.stopped:
                w = self._open()
                if w is None:
                    return
        w.stop()

    def close(self):
        self.rs.close()


@pytest.mark.slow
def test_read_plane_survives_leader_loss_soak(tmp_path):
    """The chaos-read acceptance soak: ≥200 live watch streams spread
    across all three replicas, writers hammering, then (1) an arbiter
    partition fences the leader and a follower wins, heal, (2) the new
    leader is SIGKILLed.  Audits: every watcher's delivered rvs are
    strictly increasing with no duplicates (exactly-once across every
    resume), at least one stream death forced a real cross-replica
    resume, and every watcher's ADDED union covers every acked create
    — zero acked-write loss observed through the READ plane."""
    n_watchers = int(os.environ.get("MINISCHED_READ_WATCHERS", "210"))
    plane = ReplicatedPlane(str(tmp_path), n=3, fsync=True, ttl_s=TTL_S)
    acked: dict = {}
    acked_mu = threading.Lock()
    stop_writers = threading.Event()
    stop_watch = threading.Event()
    target_rv = [0]
    werrs: list = []

    def writer(wi: int, plane_url: list) -> None:
        i = 0
        client = RemoteClient(plane_url[0], timeout_s=10.0, retries=0)
        while not stop_writers.is_set():
            name = f"w{wi}-{i:04d}"
            try:
                created = client.pods().create(make_pod(name))
            except KeyError:
                pass  # retransmit of a committed create: the ack stands
            except Exception:
                time.sleep(0.2)
                try:
                    won = plane.wait_for_leader(timeout_s=10 * TTL_S)
                except RuntimeError:
                    continue
                plane_url[0] = won["url"]
                client = RemoteClient(
                    plane_url[0], timeout_s=10.0, retries=0
                )
                continue
            with acked_mu:
                acked[name] = created.metadata.resource_version
            i += 1
        if i == 0:
            werrs.append(f"writer {wi} never acked a single write")

    watchers: list = []
    try:
        url = plane.start()
        bases = [r.base_url for r in plane.replicas]
        for i in range(n_watchers):
            home = bases[i % len(bases)]
            others = [b for b in bases if b != home]
            watchers.append(_Watcher(i, home, others))
        for wt in watchers:
            wt.start(stop_watch, target_rv)

        shared_url = [url]
        writers = [
            threading.Thread(target=writer, args=(wi, shared_url))
            for wi in range(3)
        ]
        for t in writers:
            t.start()
        time.sleep(1.5)  # build load with every stream live

        # disruption 1: the leader loses the arbiter majority — it must
        # fence (watchers on it see a quiet stream, not stale events)
        # and a follower wins; heal afterwards
        old = plane.leader()
        assert old is not None
        _partition_arbiter(old, [r for r in plane.replicas if r is not old])
        _wait_fenced(old, 2 * TTL_S + 1.0)
        plane.wait_for_leader(timeout_s=10 * TTL_S, exclude=old.replica_id)
        time.sleep(1.0)
        _heal_all(plane)
        time.sleep(1.0)

        # disruption 2: SIGKILL whoever leads now — every stream parked
        # on it dies mid-flight and must resume on a survivor
        victim = plane.leader()
        assert victim is not None
        victim.kill()
        plane.wait_for_leader(
            timeout_s=10 * TTL_S, exclude=victim.replica_id
        )
        time.sleep(1.5)  # writers ack against the new leader

        stop_writers.set()
        for t in writers:
            t.join(timeout=30.0)
        assert not werrs, werrs
        assert len(acked) >= 50, f"soak too quiet: {len(acked)} acked"

        # release the watchers once they have the full acked history
        target_rv[0] = max(acked.values())
        stop_watch.set()
        deadline = time.monotonic() + 60.0
        laggards = []
        for wt in watchers:
            if not wt.join(max(0.1, deadline - time.monotonic())):
                laggards.append(
                    f"watcher {wt.idx} stuck at rv {wt.last_rv} "
                    f"(target {target_rv[0]}, errs {wt.errs[:2]})"
                )
        assert not laggards, laggards[:5]

        # audit 1: exactly-once per watcher — strictly increasing, no
        # duplicate rv ever delivered (regressions were recorded live)
        bad = [
            f"watcher {wt.idx}: {wt.errs[:3]}"
            for wt in watchers if wt.errs
        ]
        assert not bad, bad[:5]
        for wt in watchers:
            assert wt.rvs == sorted(wt.rvs), f"watcher {wt.idx} disorder"
            assert len(wt.rvs) == len(set(wt.rvs)), (
                f"watcher {wt.idx} duplicate rvs"
            )

        # audit 2: the kill really severed streams — resumes happened
        assert sum(wt.resumes for wt in watchers) >= 1, (
            "no watcher ever resumed: the kill was not observed"
        )

        # audit 3: zero acked-write loss through the read plane — every
        # watcher saw every acked create
        want = set(acked)
        for wt in watchers:
            missing = want - wt.names
            assert not missing, (
                f"watcher {wt.idx} missing {len(missing)} acked "
                f"creates: {sorted(missing)[:5]}"
            )
    finally:
        stop_writers.set()
        stop_watch.set()
        for wt in watchers:
            wt.close()
        plane.stop()
