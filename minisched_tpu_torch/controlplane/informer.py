"""Informer machinery: cached watches with event-handler fanout.

A copy of ``minisched_tpu/controlplane/informer.py`` (``:39-636``): the
client-go ``SharedInformerFactory`` surface — handler registration with
filtering and a batch fast path, ``start``, ``wait_for_cache_sync``,
cache reads (``lister``, ``get``, ``get_many``) and the dispatch gate
the wave engine closes around a bind.

Each informer runs ONE dispatch thread that drains its store watch and
invokes the registered handlers in order; late-registration cache
replays run on that thread too, so handlers are never called
concurrently and always observe events in cache order.  Handlers run on
these threads: they must never touch a CUDA tensor (only the engine
thread evaluates on the card).

The reconnect path (JAX ``:68-500``): the watch opens on the dispatch
thread with bounded backoff (``_open_initial``), so a control plane down
at boot delays the sync instead of failing the service.  When the watch
dies (a remote stream lost, a slow watcher evicted, the server
restarted) the informer resumes from the last resource_version it saw;
on 410 it sleeps a deterministic jitter (``MINISCHED_RELIST_JITTER_S``,
a blake2s hash of the fault seed, kind, instance and ordinal) and
relists, delivering the difference to its cache as events (unchanged
objects suppressed, changed ones MODIFIED, vanished ones DELETED).
``on_reconnect`` callbacks then run (the engine revalidates its assume
ledger), and ``staleness_s`` reports how long the cache has gone without
a live stream.

Left out: a lagging replica's ``NotYetObserved`` only backs off here;
the endpoint rotation it waits for comes with replication (ROADMAP item
7).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import traceback
from dataclasses import dataclass
from hashlib import blake2s
from typing import Any, Callable, Dict, List, Optional, Tuple

from minisched_tpu_torch.controlplane.store import (
    EventType,
    HistoryCompacted,
    NotYetObserved,
    ObjectStore,
    WatchEvent,
)
from minisched_tpu_torch.observability import counters

Handler = Callable[[Any], None]
UpdateHandler = Callable[[Any, Any], None]


@dataclass
class ResourceEventHandlers:
    """AddFunc/UpdateFunc/DeleteFunc bundle (cache.ResourceEventHandlerFuncs)."""

    on_add: Optional[Handler] = None
    on_update: Optional[UpdateHandler] = None
    on_delete: Optional[Handler] = None
    # FilteringResourceEventHandler (eventhandler.go:20-35)
    filter: Optional[Callable[[Any], bool]] = None
    #: batch fast path: when set, the dispatch thread hands the handler a
    #: whole LIST of normalized WatchEvents in one call instead of one
    #: call per event — a wave's thousands of bind events then cost the
    #: consumer one lock hold.  The batch handler sees the same events in
    #: the same order and must apply ``filter`` itself (it receives the
    #: raw batch); on_add/on_update/on_delete are ignored when set.
    #: CONTRACT: the handler must contain errors PER EVENT internally — a
    #: raise aborts its remaining batch for this consumer while other
    #: consumers still apply it (the per-event path loses exactly one
    #: event; a batch handler that lets an exception escape loses the
    #: tail of the batch).
    on_batch: Optional[Callable[[List["WatchEvent"]], None]] = None


#: per-process informer construction ordinal — the jitter salt that
#: spreads a mass 410 across informers of the SAME kind (one per
#: factory, many factories per storm) while staying deterministic for
#: a fixed construction order
_instance_ids = itertools.count()


class Informer:
    def __init__(self, store: ObjectStore, kind: str):
        self._store = store
        self._kind = kind
        # fabric-deterministic relist jitter (see _relist_jitter): the
        # schedule is a blake2s hash of (fault seed, kind, instance,
        # ordinal), FaultFabric style — byte-for-byte reproducible for a
        # fixed seed, no shared RNG to race on
        self._instance = next(_instance_ids)
        self._jitter_n = 0
        self._handlers: List[ResourceEventHandlers] = []
        self._lock = threading.Lock()
        self._cache: Dict[str, Any] = {}
        # late-registration replays, delivered by the dispatch thread so
        # handler invocation stays single-threaded and ordered w.r.t. the
        # cache state the snapshot was taken from
        self._pending_replays: List[Tuple[ResourceEventHandlers, List[WatchEvent]]] = []
        self._thread: Optional[threading.Thread] = None
        self._watch = None
        self._synced = threading.Event()
        self._stop = threading.Event()
        # dispatch gate (set = running).  The wave engine clears it for the
        # host-side stretch of a wave (snapshot/table build) so handler
        # work for the previous wave's thousands of bind events lands in
        # the GIL-free device-call window instead of contending with the
        # engine's own Python.  Soft pause: the timed wait bounds how long
        # a forgotten gate can stall the stream.
        self._gate = threading.Event()
        self._gate.set()
        #: degraded-mode gauges: how many times the watch died and was
        #: re-opened, and when this informer last made progress (either a
        #: delivered batch or a verified-quiet live stream) — consumers
        #: read ``staleness_s()`` to decide how much to trust the cache
        self.reconnects = 0
        #: of those, how many re-opened as a RESUME (history replay from
        #: the last seen resource_version) vs. a full relist
        self.resumes = 0
        self._last_progress_t = time.monotonic()
        # highest mutation resource_version this dispatch thread has seen
        # (only it writes); what a reconnect resumes from
        self._last_rv = 0
        #: callbacks invoked (on the dispatch thread) after every
        #: successful reconnect, resume or relist — consumers whose
        #: derived state assumes an unbroken stream re-arbitrate here
        #: (the engine revalidates its assume ledger against the
        #: authoritative store: a control-plane restart may have lost or
        #: landed binds its pre-crash memory is wrong about)
        self.on_reconnect: List[Callable[[], None]] = []

    def add_event_handlers(self, handlers: ResourceEventHandlers) -> None:
        with self._lock:
            self._handlers.append(handlers)
            # client-go replays the cache as adds to late registrants; the
            # dispatch thread delivers (see _drain_replays).  Replay is
            # keyed on CACHE content, not on the synced flag: a handler
            # registered mid-sync (the informer already dispatched k of N
            # snapshot events with no handlers attached) must still see
            # those k objects.  It may then see a duplicate ADD for an
            # object whose live event also arrives — every consumer
            # (queue, caches, index) dedupes ADDs by uid.
            replay = [
                WatchEvent(EventType.ADDED, obj)
                for obj in self._cache.values()
            ]
            if replay:
                self._pending_replays.append((handlers, replay))

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._synced.clear()
        # the initial watch opens ON the dispatch thread (see _open_initial)
        # so a control plane that is lossy AT BOOT delays sync instead of
        # crashing the service — the same degraded mode as a mid-run drop
        self._watch = None
        self._initial = 0
        self._thread = threading.Thread(
            target=self._run, name=f"informer-{self._kind}", daemon=True
        )
        self._thread.start()

    def _open_watch(
        self, backoff: float, resume_rv: Optional[int] = None
    ) -> Optional[Tuple[List[Any], str]]:
        """Open a watch (initial or reconnect) with bounded backoff — a
        watch open is one HTTP request on the remote store, exactly as
        droppable as the stream it starts.  Assigns ``self._watch`` and
        returns ``(payload, mode)``, or None only on shutdown:

        * ``([], "resume")`` — resumed from ``resume_rv``; the server
          replays only the missed tail and the cache needs no diffing.
        * ``(items, "list")`` — relisted through the LIST verb (the
          memoized COW payload: a storm of these costs the server ONE
          encode) and the watch resumes from the list's rv, so the
          stream carries only events after it — no snapshot replay.
        * ``(snapshot, "stream")`` — full snapshot replay on the stream,
          the pre-COW relist; kept as the never-410 fallback when the
          history floor has been raised past the list's own rv.

        A 410 on the resume path jitters (``_relist_jitter``) before
        relisting so a mass eviction spreads instead of stampeding, then
        relists without burning a backoff interval — the server is
        demonstrably up."""
        while not self._stop.is_set():
            try:
                if resume_rv is not None:
                    try:
                        watch, _ = self._store.watch(
                            self._kind, send_initial=False,
                            resume_rv=resume_rv,
                        )
                        payload: List[Any] = []
                        mode = "resume"
                    except HistoryCompacted:
                        counters.inc("informer.relist_on_410")
                        self._relist_jitter()
                        resume_rv = None
                        continue
                    except NotYetObserved:
                        # a lagging replica has not applied our cursor
                        # yet: the cache is FINE — keep
                        # the resume_rv, wait out the replication lag
                        # (or an endpoint-aware store's next rotation)
                        # with a short bounded backoff.  Relisting here
                        # would throw away a valid cache for nothing.
                        counters.inc("informer.resume_not_yet_observed")
                        self._stop.wait(backoff)
                        backoff = min(backoff * 2, 2.0)
                        continue
                else:
                    watch, payload, mode = self._open_relist()
            except Exception as err:
                print(
                    f"informer-{self._kind}: watch open failed ({err!r});"
                    f" retrying in {backoff:.1f}s"
                )
                counters.inc("informer.open_retry")
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 10.0)
                continue
            self._watch = watch
            if self._stop.is_set():
                # stop() raced the open: it sets _stop BEFORE reading
                # _watch, so either it saw this watch (and stopped it) or
                # we see _stop here — stop it ourselves (stop is
                # idempotent) so no orphan registration accretes events
                watch.stop()
                return None
            return payload, mode
        return None

    def _open_relist(self) -> Tuple[Any, List[Any], str]:
        """One relist, list+watch style: LIST (epoch-consistent items +
        rv, served from the shared COW payload cache) then a watch
        RESUMING from that rv — the stream replays exactly the events
        after the list, deletes included, so there is no gap and no
        double-delivery.  Only when the history floor has been raised
        past the list's rv with no write since (410 on a just-listed rv)
        fall back to the full snapshot replay on the stream, which never
        410s."""
        items, rv = self._store.list_with_rv(self._kind)
        try:
            watch, _ = self._store.watch(
                self._kind, send_initial=False, resume_rv=rv
            )
            return watch, items, "list"
        except HistoryCompacted:
            watch, snapshot = self._store.watch(
                self._kind, send_initial=True
            )
            return watch, snapshot, "stream"

    def _relist_jitter(self) -> None:
        """Deterministic pre-relist sleep in ``[0, MINISCHED_RELIST_JITTER_S)``
        — a mass 410 (ring compaction evicting a crowd at once) otherwise
        has every informer relist on the same tick.  The delay is a
        blake2s hash of (fault-fabric seed, kind, instance, ordinal), so
        a chaos run replays the exact same spread."""
        max_s = float(os.environ.get("MINISCHED_RELIST_JITTER_S", "0.2"))
        if max_s <= 0.0:
            return
        fabric = getattr(self._store, "faults", None)
        seed = getattr(fabric, "seed", 0) or 0
        self._jitter_n += 1
        h = blake2s(
            f"{seed}:informer.relist_jitter:{self._kind}"
            f":{self._instance}:{self._jitter_n}".encode(),
            digest_size=4,
        ).digest()
        counters.inc("informer.relist_jitter_s")  # sleeps taken, not seconds
        self._stop.wait(int.from_bytes(h, "big") / 2**32 * max_s)

    def _open_initial(self) -> bool:
        opened = self._open_watch(backoff=0.1)
        if opened is None:
            return False
        payload, mode = opened
        self._advance_cursor_to_snapshot()
        if mode == "list":
            # cache is current the moment the list payload is folded in;
            # the stream owes us nothing before sync
            self._initial = 0
            self._apply_relist(payload)
        else:
            self._initial = len(payload)
        return True

    def _advance_cursor_to_snapshot(self) -> None:
        """After a full-snapshot open, the resume cursor is the rv the
        snapshot REFLECTS (Watch.start_rv, taken atomically with the
        registration) — not the max event rv seen: object rvs undercount
        deletes, and a cursor left low would make a later resume replay
        history this snapshot already folded in (double-dispatched
        DELETEDs, older objects clobbering newer cache entries).  Safe
        even if the stream dies mid-replay: _reconnect's mid_replay guard
        forces a relist then."""
        self._last_rv = max(
            self._last_rv, getattr(self._watch, "start_rv", 0)
        )

    def _drain_replays(self) -> None:
        while True:
            with self._lock:
                if not self._pending_replays:
                    return
                handlers, events = self._pending_replays.pop(0)
            self._invoke(handlers, events)

    def _run(self) -> None:
        if not self._open_initial():
            return  # stopped before the control plane ever answered
        seen = 0
        if self._initial == 0:
            self._synced.set()
        # reflector resync state: >0 means the next N stream events are a
        # reconnect's snapshot replay, to be DIFFED against the cache
        # (unchanged objects suppressed, changed delivered as MODIFIED,
        # vanished delivered as DELETED at replay end)
        self._replay_pending = 0
        self._replay_seen: set = set()
        while not self._stop.is_set():
            self._drain_replays()
            batch = self._watch.next_batch(timeout=0.1)
            if batch or not self._watch.stopped:
                # a delivered batch, or a live-but-quiet stream: either way
                # the cache is current as of now.  The stamp freezes while
                # the watch is down (reconnect backoff) — that widening gap
                # is exactly what staleness_s() reports.
                self._last_progress_t = time.monotonic()
            if batch and not self._gate.is_set():
                # a gated batch is HELD, not dropped: the engine closes the
                # gate just before delivering a wave's bind events and
                # opens it entering the next device call, so this work
                # runs in that GIL-free window.  The timed wait bounds a
                # forgotten gate; processing then proceeds regardless.
                self._gate.wait(timeout=2.0)
            if not batch:
                if self._watch.stopped:
                    if self._stop.is_set() or not self._reconnect():
                        return
                continue
            # normalize the whole batch under ONE cache-lock hold (DELETED
            # resolves to the cached object, MODIFIED picks up old_obj)
            normalized: List[WatchEvent] = []
            with self._lock:
                for ev in batch:
                    if ev.rv > self._last_rv:
                        # the resume cursor: what a reconnect replays from
                        self._last_rv = ev.rv
            # feed the cursor into an endpoint-aware store's session
            # floor: a relist after failover is then
            # min_rv-bounded at what this stream already delivered, so
            # the cache can never be rebuilt from an older replica
            observe = getattr(self._store, "observe_rv", None)
            if observe is not None:
                observe(self._last_rv)
            with self._lock:
                for ev in batch:
                    key = ev.obj.metadata.key
                    if self._replay_pending > 0:
                        self._replay_pending -= 1
                        self._replay_seen.add(key)
                        old = self._cache.get(key)
                        self._cache[key] = ev.obj
                        if old is not None:
                            same = (
                                old.metadata.resource_version
                                == ev.obj.metadata.resource_version
                            )
                            if not same:
                                normalized.append(
                                    WatchEvent(EventType.MODIFIED, ev.obj, old)
                                )
                            # unchanged: consumers already saw this state
                        else:
                            normalized.append(
                                WatchEvent(EventType.ADDED, ev.obj)
                            )
                        if self._replay_pending == 0:
                            normalized.extend(self._finish_replay_locked())
                        continue
                    if ev.type == EventType.DELETED:
                        old = self._cache.pop(key, None)
                        if old is not None:
                            ev = WatchEvent(EventType.DELETED, old, rv=ev.rv)
                    elif ev.type == EventType.MODIFIED:
                        ev = WatchEvent(
                            EventType.MODIFIED, ev.obj, self._cache.get(key),
                            rv=ev.rv,
                        )
                        self._cache[key] = ev.obj
                    else:
                        self._cache[key] = ev.obj
                    normalized.append(ev)
                handlers = list(self._handlers)
            for h in handlers:
                self._invoke(h, normalized)
            seen += len(normalized)
            if seen >= self._initial:
                self._synced.set()

    def _finish_replay_locked(self) -> List[WatchEvent]:
        """End of a reconnect's snapshot replay: everything cached that
        the replay did NOT mention was deleted while the watch was down."""
        gone = [k for k in self._cache if k not in self._replay_seen]
        out = [
            WatchEvent(EventType.DELETED, self._cache.pop(key)) for key in gone
        ]
        self._replay_seen = set()
        return out

    def _apply_relist(self, items: List[Any]) -> None:
        """Fold a LIST payload into the cache and dispatch the normalized
        diff — the synchronous twin of the stream replay-diff in _run
        (unchanged objects suppressed, changed delivered as MODIFIED,
        vanished as DELETED).  Runs on the dispatch thread only, so
        handler ordering is preserved."""
        with self._lock:
            seen: set = set()
            normalized: List[WatchEvent] = []
            for obj in items:
                key = obj.metadata.key
                seen.add(key)
                old = self._cache.get(key)
                self._cache[key] = obj
                if old is None:
                    normalized.append(WatchEvent(EventType.ADDED, obj))
                elif (
                    old.metadata.resource_version
                    != obj.metadata.resource_version
                ):
                    normalized.append(
                        WatchEvent(EventType.MODIFIED, obj, old)
                    )
                # unchanged: consumers already saw this state
            for key in [k for k in self._cache if k not in seen]:
                normalized.append(
                    WatchEvent(EventType.DELETED, self._cache.pop(key))
                )
            handlers = list(self._handlers)
        for h in handlers:
            self._invoke(h, normalized)

    def _reconnect(self) -> bool:
        """The watch died underneath us (remote stream failure — the
        in-process store's watch only stops via Informer.stop): re-open
        it, retrying with backoff until stopped.  RESUME first — the
        server replays exactly the events after the last seen
        resource_version (missed deletes included), so the cache needs no
        diffing and consumers never re-see what they already processed.
        Only when that history is compacted away (server restarted past
        the tail, ring overflow → 410) fall back to the full snapshot
        replay, client-go-reflector style: the replayed snapshot is
        diffed against the cache by the _run loop so consumers converge
        on the post-outage state.  Returns False only when the informer
        is shutting down."""
        with self._lock:
            mid_replay = self._replay_pending > 0
        # a reconnect DURING an unfinished relist must relist again, not
        # resume: the aborted replay-diff never ran _finish_replay_locked,
        # so deletes that happened in the original outage are still only
        # detectable by a full snapshot diff — and the partial replay has
        # already advanced _last_rv past their events, so a resume would
        # never see them and the cache would retain deleted objects
        # until some future 410 forced a relist.
        resume_rv = (
            None if mid_replay or not self._last_rv else self._last_rv
        )
        opened = self._open_watch(backoff=0.5, resume_rv=resume_rv)
        if opened is None:
            return False
        payload, mode = opened
        self.reconnects += 1
        counters.inc("informer.reconnect")
        if mode == "resume":
            self.resumes += 1
            counters.inc("informer.resume")
            with self._lock:
                self._replay_pending = 0
                self._replay_seen = set()
            self._notify_reconnect()
            return True
        self._advance_cursor_to_snapshot()
        if mode == "list":
            # list+watch relist: the diff lands synchronously here, and
            # the resumed stream carries only events AFTER the list's rv
            # — nothing on the stream is a replay, so the replay-diff
            # machinery stays disarmed
            with self._lock:
                self._replay_pending = 0
                self._replay_seen = set()
            self._apply_relist(payload)
            self._notify_reconnect()
            return True
        stale: List[WatchEvent] = []
        with self._lock:
            self._replay_pending = len(payload)
            self._replay_seen = set()
            if self._replay_pending == 0:
                # empty server: everything we cached is gone
                stale = self._finish_replay_locked()
            handlers = list(self._handlers)
        if stale:
            for h in handlers:
                self._invoke(h, stale)
        self._notify_reconnect()
        return True

    def _notify_reconnect(self) -> None:
        for cb in list(self.on_reconnect):
            try:
                cb()
            except Exception:  # a consumer hook must not kill the stream
                traceback.print_exc()

    def _invoke(self, h: ResourceEventHandlers, events: List[WatchEvent]) -> None:
        """One handler over a batch: a registered ``on_batch`` takes the
        whole list in one call; otherwise events dispatch one at a time.
        Every handler sees events in cache order either way."""
        if h.on_batch is not None:
            try:
                h.on_batch(events)
            except Exception:  # handler errors must not kill the stream
                traceback.print_exc()
            return
        for ev in events:
            self._invoke_one(h, ev)

    def _invoke_one(self, h: ResourceEventHandlers, ev: WatchEvent) -> None:
        try:
            if h.filter is not None and not h.filter(ev.obj):
                # on MODIFIED, client-go also fires delete when an object
                # falls out of the filter; the reference relies only on the
                # add path (eventhandler.go:20-35), keep it simple.
                return
            if ev.type == EventType.ADDED and h.on_add:
                h.on_add(ev.obj)
            elif ev.type == EventType.MODIFIED and h.on_update:
                h.on_update(ev.old_obj, ev.obj)
            elif ev.type == EventType.DELETED and h.on_delete:
                h.on_delete(ev.obj)
        except Exception:  # handler errors must not kill the stream
            traceback.print_exc()

    def wait_for_cache_sync(self, timeout: float = 5.0) -> bool:
        return self._synced.wait(timeout)

    def staleness_s(self) -> float:
        """Seconds since this informer last KNEW it was current (live
        stream observed).  Grows while the watch is down; snaps back to ~0
        once the reconnect's replay lands."""
        return time.monotonic() - self._last_progress_t

    def lister(self) -> List[Any]:
        with self._lock:
            return list(self._cache.values())

    def get(self, key: str) -> Optional[Any]:
        """O(1) cache lookup by ``namespace/name`` key (None if absent)."""
        with self._lock:
            return self._cache.get(key)

    def get_many(self, keys: List[str]) -> List[Optional[Any]]:
        """Bulk ``get`` under ONE lock hold — the wave engine resolves a
        whole assume-cache's worth of keys per snapshot, and a lock
        round-trip per key races the dispatch thread's batch normalization
        (which holds the same lock for the full batch)."""
        with self._lock:
            return [self._cache.get(k) for k in keys]

    def pause_dispatch(self) -> None:
        self._gate.clear()

    def resume_dispatch(self) -> None:
        self._gate.set()

    def stop(self) -> None:
        self._stop.set()
        if self._watch is not None:
            self._watch.stop()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class SharedInformerFactory:
    """Factory + lifecycle for per-kind informers
    (scheduler/scheduler.go:54,72-73)."""

    def __init__(self, store: ObjectStore):
        self._store = store
        self._informers: Dict[str, Informer] = {}
        self._started = False

    def informer_for(self, kind: str) -> Informer:
        if kind not in self._informers:
            self._informers[kind] = Informer(self._store, kind)
            if self._started:
                # factory already running: the late informer joins live
                # (its watch replays the current snapshot, so it syncs)
                self._informers[kind].start()
        return self._informers[kind]

    def start(self) -> None:
        self._started = True
        for inf in self._informers.values():
            inf.start()

    def wait_for_cache_sync(self, timeout: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout
        for inf in self._informers.values():
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not inf.wait_for_cache_sync(remaining):
                return False
        return True

    def staleness(self) -> Dict[str, Dict[str, float]]:
        """Per-kind staleness gauge (see Informer.staleness_s) plus
        reconnect counts — the degraded-mode dashboard line."""
        return {
            kind: {
                "staleness_s": round(inf.staleness_s(), 3),
                "reconnects": inf.reconnects,
                "resumes": inf.resumes,
            }
            for kind, inf in self._informers.items()
        }

    def pause_dispatch(self) -> None:
        """Hold event dispatch for every informer (see Informer._gate)."""
        for inf in self._informers.values():
            inf.pause_dispatch()

    def resume_dispatch(self) -> None:
        for inf in self._informers.values():
            inf.resume_dispatch()

    def shutdown(self) -> None:
        for inf in self._informers.values():
            inf.resume_dispatch()
            inf.stop()
