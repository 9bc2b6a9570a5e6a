"""The port's replicated-plane chaos on the CPU: SIGKILL the LEADER,
keep the data.

The port's copies of JAX's ``tests/test_repl_chaos.py`` (TTL 1 s and
JAX's gates, under JAX's names; the soak keeps JAX's ``slow`` mark): a
3-replica plane of the port's replica children takes client load, the
leader is SIGKILLed, a follower must win the store-leader lease within
``2·TTL + 1 s`` and serve every acked write.  Then chip smoke phase 31's
flow (``live.run_config5_replicated``) at 100 nodes and 1,000 pods with
the device engine on ``device="cpu"``: config 5 scheduled through a
leader SIGKILL, the old leader restarted as a fenced follower, and every
bind watched before the kill on the node the same run without
replication chose.  Every wait has a deadline and every plane is
stopped in ``finally``.
"""

from __future__ import annotations

import threading
import time

import pytest

from minisched_tpu_torch.api.objects import make_pod
from minisched_tpu_torch.controlplane.fsck import wal_compare
from minisched_tpu_torch.controlplane.remote import RemoteClient
from minisched_tpu_torch.controlplane.replproc import ReplicatedPlane
from minisched_tpu_torch.faults import wal_double_binds

TTL_S = 1.0


def _names(client) -> set:
    return {p.metadata.name for p in client.pods().list()}


def test_leader_kill_failover_smoke(tmp_path):
    """One SIGKILL: every write acked before the kill survives on the
    promoted follower, promotion lands within ~2 TTLs of the kill, and
    the new leader accepts writes (2-of-3 alive still quorums)."""
    plane = ReplicatedPlane(str(tmp_path), n=3, fsync=True, ttl_s=TTL_S)
    try:
        url = plane.start()
        client = RemoteClient(url, timeout_s=10.0)
        acked = []
        for i in range(20):
            client.pods().create(make_pod(f"pre-{i:03d}"))
            acked.append(f"pre-{i:03d}")
        old = plane.leader()
        assert old is not None
        t_kill = time.monotonic()
        old.kill()
        won = plane.wait_for_leader(
            timeout_s=10 * TTL_S, exclude=old.replica_id
        )
        elapsed = time.monotonic() - t_kill
        assert elapsed <= 2 * TTL_S + 1.0, (
            f"promotion took {elapsed:.2f}s (ttl {TTL_S}s)"
        )
        survivor = RemoteClient(won["url"], timeout_s=10.0)
        assert set(acked) <= _names(survivor), "acked writes lost"
        # the halved plane still quorums: 1 live follower = majority-1
        survivor.pods().create(make_pod("post-failover"))
        assert "post-failover" in _names(survivor)
    finally:
        plane.stop()


@pytest.mark.slow
def test_leader_kill_soak_under_load(tmp_path):
    """The acceptance soak: writers hammer the plane THROUGH a leader
    SIGKILL; the deposed replica restarts mid-run and must rejoin
    fenced + catch up.  Ends in the standing audits — every acked
    mutation present on the final leader, live replica WALs
    identical/prefix, zero double binds across the full history."""
    plane = ReplicatedPlane(str(tmp_path), n=3, fsync=True, ttl_s=TTL_S)
    acked: set = set()
    acked_mu = threading.Lock()
    stop = threading.Event()
    errs: list = []

    def writer(w: int, plane_url: list) -> None:
        i = 0
        client = RemoteClient(plane_url[0], timeout_s=10.0, retries=0)
        while not stop.is_set():
            name = f"w{w}-{i:04d}"
            try:
                client.pods().create(make_pod(name))
            except KeyError:
                # a retransmission of a create that DID commit before
                # its socket died: the object exists, the ack stands
                pass
            except Exception:
                # mid-failover: rebind to whoever leads now and retry
                # the SAME name — only a returned ack admits it to the
                # acked set
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
                acked.add(name)
            i += 1
        if i == 0:
            errs.append(f"writer {w} never acked a single write")

    try:
        url = plane.start()
        shared_url = [url]
        writers = [
            threading.Thread(target=writer, args=(w, shared_url))
            for w in range(4)
        ]
        for t in writers:
            t.start()
        # let load build, then murder the leader mid-write
        time.sleep(2.0)
        old = plane.leader()
        assert old is not None
        t_kill = time.monotonic()
        old.kill()
        won = plane.wait_for_leader(
            timeout_s=10 * TTL_S, exclude=old.replica_id
        )
        promote_s = time.monotonic() - t_kill
        assert promote_s <= 2 * TTL_S + 1.0, (
            f"promotion took {promote_s:.2f}s (ttl {TTL_S}s)"
        )
        time.sleep(2.0)  # writers keep acking against the new leader
        # the deposed ex-leader rejoins: follower, fenced, catching up
        old.restart()
        deadline = time.monotonic() + 20.0
        rejoined = None
        while time.monotonic() < deadline:
            s = old.status()
            if s is not None and s.get("role") == "follower" \
                    and s.get("fenced"):
                rejoined = s
                break
            time.sleep(0.1)
        assert rejoined is not None, "ex-leader never rejoined fenced"
        time.sleep(2.0)
        stop.set()
        for t in writers:
            t.join(timeout=30.0)
        assert not errs, errs
        assert len(acked) >= 50, f"soak too quiet: {len(acked)} acked"

        # audit 1: zero acked-write loss on the final leader
        final = plane.wait_for_leader(timeout_s=10 * TTL_S)
        client = RemoteClient(final["url"], timeout_s=10.0)
        missing = acked - _names(client)
        assert not missing, f"{len(missing)} acked writes lost: " \
            f"{sorted(missing)[:5]}"

        # audit 2: the ex-leader caught back up to the live plane's rv
        want_rv = int(client.store.list_with_rv("Pod")[1])
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            s = old.status()
            if s is not None and int(s.get("rv", 0)) >= want_rv:
                break
            time.sleep(0.1)
        s = old.status()
        assert s is not None and int(s.get("rv", 0)) >= want_rv, (
            f"ex-leader stuck at {s and s.get('rv')} < {want_rv}"
        )
    finally:
        plane.stop()

    # audit 3 (offline, post-shutdown): replica histories never forked —
    # every pair of WALs is identical or a clean prefix
    paths = [r.wal_path for r in plane.replicas]
    for i in range(len(paths)):
        for j in range(i + 1, len(paths)):
            cmp = wal_compare(paths[i], paths[j])
            assert cmp["identical"] or cmp["prefix"], (
                f"{paths[i]} vs {paths[j]} diverged: {cmp['diverged']}"
            )
    # audit 4: the full-history double-bind audit stays clean
    for p in paths:
        assert wal_double_binds(p) == []


def test_config5_replicated_through_a_leader_kill_places_as_without(
        tmp_path):
    """Chip smoke phase 31's flow (``live.run_config5_replicated``) at 100
    nodes and 1,000 pods, the device engine on ``device="cpu"`` (serial,
    waves of 64) behind ``RemoteClient(leader, endpoints=[r1, r2])``: the
    leader SIGKILLed once a watch on ``r2`` saw 60 binds, a new leader
    within ``2·TTL + 1 s``, every plain pod bound and no special pod, the
    old leader back as a fenced follower, WALs identical or prefixes, no
    double bind, fsck clean.  Every bind watched before the kill is on
    the node the same run without replication (``run_config5_live`` in
    process, same waves) chose."""
    from minisched_tpu_torch.live import (
        run_config5_live,
        run_config5_replicated,
    )

    run = run_config5_replicated(
        str(tmp_path / "plane"), n_nodes=100, n_pods=1_000, kill_binds=60,
        device="cpu", chunk=250, timeout_s=120.0, max_wave=64,
        ttl_s=TTL_S, pipeline=False)
    assert run.n_plain == 980 and 60 <= run.seen_at_kill < 980
    assert run.old_leader == "r0" and run.new_leader in ("r1", "r2")
    assert run.promote_s <= 2 * TTL_S + 1.0
    assert run.waves >= 2 and run.loop_errors == 0
    assert run.assumed_left == 0 and run.waiting_left == 0
    assert run.audit == {"bound": 980, "nodes": 100}
    assert sum(1 for v in run.placements.values() if v) == 980
    assert all(n == 0 for n in run.double_binds.values())
    assert len(run.double_binds) == 4 and len(run.wal_pairs) == 3
    assert run.fsck_rc == 0 and run.threads_left == []
    assert run.catchup_s >= 0 and run.quorum_wait["before"]["groups"] > 0
    ref = run_config5_live(100, 1_000, max_wave=64, device="cpu",
                           pipeline=False)
    assert ref.loop_errors == 0
    moved = {n: (node, ref.first_drain[n]) for n, node in run.seen.items()
             if ref.first_drain[n] != node}
    assert not moved, moved
