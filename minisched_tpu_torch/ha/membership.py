"""Membership: who is scheduling, and which pods are whose.

A copy of ``minisched_tpu/ha/membership.py``.  Each engine joins the
plane by acquiring a member lease (``member-<id>``), then heartbeats it
at ttl/3.  The live member set is derived by reading the lease
namespace (the Lease informer's cache when attached, so renewals, joins
and releases propagate as events; a consistent ``list_with_rv``
otherwise) and filtering out leases expired by the wall clock.  Any
change to the derived set bumps this member's local **epoch** and fires
the registered callbacks (``ha/plane.py`` adopts and sheds queue
contents there).

The shard map is a **rendezvous (highest-random-weight) hash** of pod
uid over the sorted member ids (``shard_owner``): deterministic from
the member set alone, the same in every process, so two engines that
agree on who is alive agree on every pod's owner without a coordination
round; and minimal-churn by construction, since removing one member
reassigns exactly that member's pods.  The sharded write plane
(``controlplane/shards.py``) places namespaces with the same function.

The epoch is a local monotonic version of this member's view, published
through the lease on every renewal, so observers can watch every
survivor move past a kill.  Correctness never depends on epochs
agreeing across members: placement conflicts in the rebalance window
are arbitrated by the store's bind preconditions.

The port's, beyond JAX's, so that neither a consumer of the view nor a
lagging cache makes a live member look dead (under load, with the
resync on the heartbeat thread, ticks ran past ttl/3 and members
dropped live peers):

* two threads where JAX has one.  The heartbeat thread only renews, on
  a fixed schedule that a slow renewal does not push back; the view
  thread recomputes (the callbacks, which re-queue whole shards, run
  there), at the same interval and at once on a Lease event, and
  collects dead leases.  A Lease event wakes the view thread, so the
  Lease informer's dispatch never runs a callback;
* a start at join: ``ha/plane.start_ha_engine`` starts the threads
  right after ``join``, where JAX starts them once the engine runs
  (seconds on a card, longer than a TTL of 2 s);
* a member of the view whose lease reads expired in the informer's
  cache is read again from the store before it is dropped
  (``ha.expiry_unconfirmed`` counts the live ones), so a cache that
  lags the TTL (a held or busy dispatch) drops no live peer;
* a changed view is published at once: the view change wakes the
  heartbeat to renew with the new epoch (JAX's renews at the next
  tick);
* each renewal's seconds land in ``ha.heartbeat_s``, the seconds
  between the starts of successive renewals in ``ha.renew_gap_s`` (above
  the TTL the lease lapsed; the widest in the gauge
  ``ha.renew_gap_max_ms``), and each view tick's in ``ha.view_s``.
"""

from __future__ import annotations

import threading
import time
import traceback
from hashlib import blake2s
from typing import (Any, Callable, Dict, List, Optional, Sequence, Set,
                    Tuple)

from minisched_tpu_torch.ha.lease import HA_NAMESPACE, LeaseLost, LeaseManager
from minisched_tpu_torch.observability import counters, hist

__all__ = ["DEFAULT_TTL_S", "MEMBER_PREFIX", "Membership", "shard_owner"]

#: default member-lease TTL: it bounds expiry, and with it the worst-case
#: detection of an orphaned shard; renewal runs every ttl/3, so two
#: missed heartbeats still keep the lease alive
DEFAULT_TTL_S = 5.0

MEMBER_PREFIX = "member-"


def shard_owner(uid: str, members: Sequence[str]) -> Optional[str]:
    """Rendezvous hash: the member with the highest blake2s score for
    this uid owns it (None for no members).  Ties (a 2^-64 curiosity)
    go to the smaller id, so the map stays a pure function."""
    best: Optional[str] = None
    best_score = -1
    for m in members:
        score = int.from_bytes(
            blake2s(f"{m}|{uid}".encode(), digest_size=8).digest(), "big")
        if score > best_score or (score == best_score
                                  and (best is None or m < best)):
            best, best_score = m, score
    return best


#: callback signature: (epoch, members, joined ids, lost ids)
ChangeCallback = Callable[[int, Tuple[str, ...], Set[str], Set[str]], None]


class Membership:
    """One engine's membership in the HA plane."""

    def __init__(self, client: Any, member_id: str,
                 ttl_s: float = DEFAULT_TTL_S, namespace: str = HA_NAMESPACE,
                 clock=time.time,
                 heartbeat_interval_s: Optional[float] = None):
        self.member_id = member_id
        self.ttl_s = float(ttl_s)
        self._leases = LeaseManager(client, namespace=namespace, clock=clock)
        self._clock = clock
        self._interval = (heartbeat_interval_s
                          if heartbeat_interval_s is not None
                          else self.ttl_s / 3.0)
        self._mu = threading.Lock()
        self._members: Tuple[str, ...] = ()
        self._epoch = 0
        self._lease = None  # our member Lease (latest stored copy)
        self._informer: Any = None
        self._stop = threading.Event()
        #: the port's: a view change wakes the heartbeat to publish it,
        #: and a Lease event wakes the view thread to recompute
        self._kick = threading.Event()
        self._wake = threading.Event()
        self._threads: List[threading.Thread] = []
        #: fired (not under the membership lock) on every epoch bump; an
        #: exception is contained: a consumer bug must not stop the
        #: heartbeat
        self.on_change: List[ChangeCallback] = []

    # -- introspection ------------------------------------------------------
    @property
    def lease_name(self) -> str:
        return MEMBER_PREFIX + self.member_id

    @property
    def epoch(self) -> int:
        with self._mu:
            return self._epoch

    def members(self) -> Tuple[str, ...]:
        with self._mu:
            return self._members

    def owns(self, uid: str) -> bool:
        """Does this member's shard contain ``uid``?  Until our own lease
        write has come back through the view (join races the first
        recompute) we count ourselves in: a plane of one at least."""
        with self._mu:
            members = self._members
        if self.member_id not in members:
            members = tuple(sorted((*members, self.member_id)))
        return shard_owner(uid, members) == self.member_id

    def owns_pod(self, pod: Any) -> bool:
        """The shard filter the engine wires (``Scheduler.shard_filter``):
        by uid, or by ``namespace/name`` when the uid is empty."""
        return self.owns(pod.metadata.uid or pod.metadata.key)

    # -- lifecycle ----------------------------------------------------------
    def join(self, timeout_s: float = 30.0) -> None:
        """Acquire our member lease (a stale lease of an earlier
        incarnation of this id is taken over once expired), then derive
        the first member view."""
        deadline = time.monotonic() + timeout_s
        while True:
            got = self._leases.acquire(self.lease_name, self.member_id,
                                       self.ttl_s)
            if got is not None:
                self._lease = got
                break
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"member {self.member_id!r}: lease "
                    f"{self.lease_name!r} held by a live peer")
            # a live holder under our name is an earlier incarnation whose
            # lease has not expired yet: wait out the TTL, do not spin
            time.sleep(min(0.2, self.ttl_s / 4.0))
        counters.inc("ha.member_join")
        self.recompute()

    def attach(self, informer_factory: Any) -> None:
        """Ride the watch path: Lease events (renewals, joins, releases)
        recompute through the factory's Lease informer, so a peer's
        graceful release rebalances at once, not at the next tick.  The
        port's: once the threads run, an event wakes the view thread,
        which recomputes, and the informer's dispatch runs no callback."""
        from minisched_tpu_torch.controlplane.informer import (
            ResourceEventHandlers,
        )

        inf = informer_factory.informer_for("Lease")
        inf.add_event_handlers(
            ResourceEventHandlers(on_batch=lambda _events: self._on_leases()))
        self._informer = inf

    def _on_leases(self) -> None:
        if self._threads and not self._stop.is_set():
            self._wake.set()
        else:
            self.recompute()  # no view thread: recompute here, as JAX's

    def start(self) -> None:
        """Start the heartbeat and view threads.  The heartbeat renews
        our lease every interval; the view thread re-derives the member
        view (expiry is a clock event: no watch event fires when a peer
        merely stops renewing, so the tick is what detects a death) and
        collects long-dead leases."""
        if any(t.is_alive() for t in self._threads):
            return
        self._stop.clear()
        self._kick.clear()
        self._wake.clear()
        self._threads = [
            threading.Thread(target=self._beat, daemon=True,
                             name=f"ha-heartbeat-{self.member_id}"),
            threading.Thread(target=self._view, daemon=True,
                             name=f"ha-view-{self.member_id}")]
        for t in self._threads:
            t.start()

    def _beat(self) -> None:
        """Renew at a fixed rate: a late renewal is followed by the next
        one on the schedule, not an interval after it ended; a view
        change renews at once in between."""
        due = time.monotonic()
        last: Optional[float] = None
        widest = 0.0
        while True:
            self._kick.wait(max(0.0, due - time.monotonic()))
            if self._stop.is_set():
                return
            self._kick.clear()
            t0 = time.monotonic()
            if t0 >= due:
                due += self._interval
                if due <= t0:
                    due = t0 + self._interval
            if self._renew():
                if last is not None:
                    hist.observe("ha.renew_gap_s", t0 - last)
                    if t0 - last > widest:
                        widest = t0 - last
                        counters.set_gauge("ha.renew_gap_max_ms",
                                           int(widest * 1000))
                last = t0
            hist.observe("ha.heartbeat_s", time.monotonic() - t0)

    def _view(self) -> None:
        """Recompute every interval and at once on a Lease event; collect
        dead leases every interval."""
        gc_due = time.monotonic() + self._interval
        while not self._stop.is_set():
            self._wake.wait(self._interval)
            if self._stop.is_set():
                return
            self._wake.clear()
            t0 = time.monotonic()
            try:
                self.recompute()
            except Exception:  # a consumer bug must not stop the view
                traceback.print_exc()
            if t0 >= gc_due:
                gc_due = t0 + self._interval
                self._gc()
            hist.observe("ha.view_s", time.monotonic() - t0)

    def _renew(self) -> bool:
        """Renew our lease with the current epoch (re-acquire it when our
        TTL lapsed and a peer saw it); False when the store was not
        reached."""
        lease = self._lease
        try:
            if lease is not None:
                self._lease = self._leases.renew(lease, epoch=self.epoch)
            else:
                self._lease = self._leases.acquire(
                    self.lease_name, self.member_id, self.ttl_s)
            return self._lease is not None
        except LeaseLost:
            # our TTL lapsed and a peer saw it: re-acquire (our own
            # expired lease can be taken over) and let the epochs settle
            try:
                self._lease = self._leases.acquire(
                    self.lease_name, self.member_id, self.ttl_s)
            except Exception:
                return False
            return self._lease is not None
        except Exception:
            # store unreachable: keep the old handle; the next renewal
            # retries, and renew's re-read absorbs a write that landed
            return False

    def _gc(self) -> None:
        try:
            self._leases.gc_expired()
        except Exception:
            pass  # housekeeping, never load-bearing

    def heartbeat_once(self) -> None:
        """One tick in the caller's thread: renew, recompute, publish a
        view this tick changed at once (JAX's publishes it a tick
        later), collect dead leases."""
        published = self.epoch
        self._renew()
        self.recompute()
        if self.epoch != published:
            self._renew()
        self._gc()

    def recompute(self) -> None:
        """Re-derive the live member set; on a change bump the epoch and
        fire the callbacks.  Reads the informer cache once it has synced
        (an unsynced cache reads as empty, which would make this member
        a plane of one and admit every pod), a consistent list before.
        The port's: a member of the view whose lease reads expired in the
        cache is read again from the store, and kept if live there."""
        cached = False
        try:
            if (self._informer is not None
                    and self._informer.wait_for_cache_sync(timeout=0)):
                leases = [l for l in self._informer.lister()
                          if l.metadata.namespace == self._leases._ns]
                cached = True
            else:
                leases, _rv = self._leases.list()
        except Exception:
            return  # plane unreachable: keep the last view
        now = self._clock()
        live: Set[str] = set()
        expired: Dict[str, str] = {}  # holder -> lease name
        for l in leases:
            if not l.metadata.name.startswith(MEMBER_PREFIX):
                continue  # a coordination lease, not a member's
            holder = l.spec.holder or l.metadata.name[len(MEMBER_PREFIX):]
            if l.expired(now):
                expired[holder] = l.metadata.name
            else:
                live.add(holder)
        if cached:
            for holder in sorted(set(self.members()) & set(expired)):
                try:
                    fresh = self._leases.get(expired[holder])
                except Exception:
                    continue  # unreachable: the cache's reading stands
                if (fresh is not None and fresh.spec.holder == holder
                        and not fresh.expired(self._clock())):
                    del expired[holder]
                    live.add(holder)
                    counters.inc("ha.expiry_unconfirmed")
        new = tuple(sorted(live))
        with self._mu:
            if new == self._members:
                return
            old = self._members
            self._members = new
            self._epoch += 1
            epoch = self._epoch
        joined = set(new) - set(old)
        lost = set(old) - set(new)
        self._kick.set()  # publish the new epoch without waiting a tick
        counters.inc("ha.epoch_bump")
        if lost:
            counters.inc("ha.member_lost", len(lost))
            # lost with a stale lease: died (its TTL ran out); lost
            # without one: released gracefully
            died = lost & set(expired)
            if died:
                counters.inc("ha.lease_expired", len(died))
        for cb in list(self.on_change):
            try:
                cb(epoch, new, joined, lost)
            except Exception:  # a consumer bug must not stop the view
                traceback.print_exc()

    def stop(self, release: bool = True) -> None:
        """Leave the plane.  ``release=True`` deletes our lease so peers
        rebalance at once; ``release=False`` abandons it, which every peer
        sees as a crash (the in-process kill switch)."""
        self._stop.set()
        self._kick.set()
        self._wake.set()
        me = threading.current_thread()
        for t in self._threads:
            if t is not me:
                t.join(timeout=max(2.0, 2 * self._interval))
        self._threads = []
        if release:
            try:
                self._leases.release(self.lease_name, self.member_id)
            except Exception:
                pass  # teardown with the plane down: peers time us out
