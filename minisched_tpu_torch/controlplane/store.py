"""In-memory, versioned object store with watch semantics.

A copy of the in-process core of ``minisched_tpu/controlplane/store.py``
(``:36-1283``), the control plane the live engine runs against:

* every mutation bumps one monotonically increasing resource version;
* watchers receive ADDED / MODIFIED / DELETED events in mutation order;
* reads return copies — mutating a returned object never changes the
  store.  The store never mutates a stored object either: updates
  replace the entry, so events carry the stored objects themselves;
* per-node request aggregates of the bound pods (``_pod_node_agg``) are
  kept exact on every Pod commit; the capacity-checked bind transaction
  (``client._PodAPI.bind_many``) reads them.

One lock guards the maps, and events are queued to watchers while it is
held, so every watcher sees mutation order.  Delivery is decoupled
through per-watcher queues: a slow consumer never stalls a mutator.

Watch resume (JAX ``store.py:1138-1200``): every event is also kept in
a per-kind history ring, bounded by count and by an estimate of its
bytes; ``watch(kind, resume_rv=N)`` replays the retained events after N
instead of the snapshot, and raises ``HistoryCompacted`` (the REST
façade's 410) when the ring no longer reaches back to N or N is ahead of
the store.

``applied_rv()`` and ``NotYetObserved`` are the surface the gRPC
servicer reads; in process the applied rv is the current rv and
``NotYetObserved`` is never raised.

The durability seams (JAX ``store.py:1048-1136``) are hooks the base
store leaves empty and ``durable.DurableObjectStore`` fills: every
mutation calls ``_commit_record`` (or ``_on_batch_commit`` per batch
item) BEFORE its object enters the maps, and a batch calls
``_flush_log`` before its fanout, so no watcher sees a version a crash
could roll back; ``_visible_rv`` stamps snapshots with the published rv.
``restore_object``, ``set_resource_version``, the history floor
(``set_history_floor``: a reopened store refuses resumes from before its
checkpoint) and ``_rebuild_node_agg`` are recovery's surface.
``fault_injector`` (called as (op, kind, key) before each mutation and
read) and ``faults`` (a ``faults.FaultFabric``) are None until a caller
arms them.

The copy-on-write read plane (JAX ``store.py:428-610``): every publish
point swaps in one immutable ``_ReadSnapshot`` (maps and the rv they
reflect), and ``get``, ``list``, ``list_with_rv``, ``applied_rv`` and a
full-snapshot ``watch`` read it without the lock; the snapshot memoizes
the encoded REST list body per (kind, namespace) and the shared replay
events of a watch open.  ``MINISCHED_COW_READS=0`` (read at
construction) keeps the locked reads.

Per-watcher queues are bounded (``DEFAULT_WATCH_QUEUE_EVENTS``, JAX
``:162-262``): a watcher whose live backlog reaches the bound is evicted
(``watch.fanout.evicted_slow``) and dies like a dropped stream; the
snapshot or resume replay it was registered with is exempt.  Its
consumer reconnects through resume or 410 and relist.

``is_fenced()`` is False here; the durable store's replication half
(``durable.py``) fences a follower, which answers a watch resumed ahead
of it with ``NotYetObserved``.

``WrongShard``, ``ShardFrozen`` and ``ShardFrozenTimeout`` (JAX
``:90-125``) are the sharded write plane's refusals (``shards.py``);
the store itself never raises them, the façade's shard guard does.

Left out: the ``watch.drop`` fault point (ROADMAP item 8).
"""

from __future__ import annotations

import enum
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class EventType(enum.Enum):
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"


class Conflict(Exception):
    """Optimistic-concurrency failure: the caller's ``expected_rv``
    precondition did not match the stored object's resource_version."""


class NotLeader(Exception):
    """A mutation reached a fenced replica, one that follows a leader's
    replicated WAL and must not accept writes of its own (a durable
    store's ``fence``); the REST façade answers it 503 ``not leader``."""


class WrongShard(Exception):
    """A write reached a leader group that does not own the object's
    namespace (the sharded write plane, ``shards.py``): the façade
    refuses it before executing anything, since accepting it would fork
    the namespace's history across two WALs.  On the wire: 421 with a
    ``wrong shard`` marker.  Never retried blindly: the shard router
    refreshes its topology from ``/shards/status`` and re-routes."""


class ShardFrozen(Exception):
    """A write hit a namespace inside a split's write freeze: the
    namespace is mid-handoff between leader groups.  On the wire: 503
    with a ``shard frozen`` marker, transient (the remote client waits
    the window out under its own deadline).  Reads are never frozen."""


class ShardFrozenTimeout(ShardFrozen):
    """A frozen-namespace wait outlived its deadline
    (``RemoteStore(frozen_deadline_s=)``): the split is stuck or its
    coordinator died before the lease expired.  A ShardFrozen, so
    handlers of "frozen" still catch it, but final for this call."""


class HistoryCompacted(Exception):
    """A watch resume asked for history older than the store retains
    (ring overflow) or newer than it holds: the apiserver's 410 Gone.
    The consumer must relist."""


#: events retained for watch resume, per kind (JAX's defaults): a kind's
#: ring overflowing advances that kind's floor, below which a resume is
#: refused with HistoryCompacted
DEFAULT_HISTORY_EVENTS = 65536
#: the same ring's budget in estimated bytes, per kind; whichever cap
#: trips first evicts
DEFAULT_HISTORY_BYTES = 64 * 1024 * 1024


class NotYetObserved(Exception):
    """An rv-bounded read reached a replica whose applied rv is still
    below the bound: retryable (gRPC ``UNAVAILABLE``, the REST 504),
    unlike HistoryCompacted.  The in-process store is its own leader and
    never raises it; the gRPC servicer catches it as JAX's does."""


class StorageDegraded(Exception):
    """The durable store cannot persist mutations (ENOSPC or EIO on the
    WAL append, or the degraded latch a prior failure set).  The store
    stays readable; every mutation is refused with this error before it
    touches memory, so nothing is acknowledged that a restart would lose.
    The REST façade answers 507; the engine parks the pod and retries
    once the store's recovery probe re-arms appends.  The in-memory store
    never raises it."""


@dataclass
class WatchEvent:
    type: EventType
    obj: Any
    old_obj: Any = None
    #: the resource_version of the mutation that produced this event
    rv: int = 0
    #: the REST façade's framed wire bytes, encoded once per event and
    #: shared by every stream (``httpserver.event_wire_chunk``)
    wire: Optional[bytes] = None
    #: the gRPC servicer's framed bytes, likewise encoded once per event
    #: (``grpcserver._event_wire``)
    grpc_wire: Optional[bytes] = None
    #: monotonic birth stamp (the fanout's time), from which the delivery
    #: paths observe ``watch.delivery_lag_s``; 0 on replayed events
    born: float = field(default=0.0, repr=False, compare=False)

    def __post_init__(self) -> None:
        if not self.born:
            self.born = time.monotonic()


#: per-watcher queue bound, in events: a watcher whose live backlog
#: reaches it is evicted and recovers through resume or 410 and relist,
#: so one wedged stream never pins every event for the process's life.
#: Well above one wave's bind fanout
DEFAULT_WATCH_QUEUE_EVENTS = 65536


class Watch:
    """A subscription to one kind's event stream."""

    def __init__(self, store: "ObjectStore", kind: str,
                 max_queued: int = DEFAULT_WATCH_QUEUE_EVENTS):
        self._store = store
        self._kind = kind
        self._cond = threading.Condition()
        self._events: List[WatchEvent] = []
        self._stopped = False
        self._max_queued = max(int(max_queued), 1)
        #: set once the watch is registered: the replay delivered before
        #: registration is exempt from eviction, only live lag evicts
        self._live = False
        #: queued events that are still that replay (consumed first): the
        #: bound applies to the queue minus these
        self._replay_pending = 0
        #: the resource_version the watch starts after: the snapshot's
        #: for a full open, the resume cursor for a resumed one
        self.start_rv = 0
        #: edge-trigger hook (``set_notify``): called on each delivery,
        #: eviction and stop, so one thread can drain many watches
        self._notify_cb: Optional[Callable[[], None]] = None

    def _evict_locked(self) -> None:
        """Slow-watcher eviction (caller holds the condition): stop, free
        the queue and wake the consumer with end of stream; the store's
        fanout prunes the registration."""
        from minisched_tpu_torch.observability import counters

        self._stopped = True
        self._events.clear()
        self._replay_pending = 0
        counters.inc("watch.fanout.evicted_slow")
        self._cond.notify_all()
        if self._notify_cb is not None:
            self._notify_cb()

    # called by the store while it holds its lock; only touches this
    # watch's own condition and queue, so it cannot block on user code
    def _deliver_many(self, events: List[WatchEvent]) -> None:
        if not events:
            return
        with self._cond:
            if self._stopped:
                return
            # gated on the lag already queued, not on this batch's size:
            # one large batch never evicts a watcher that has caught up
            if (self._live and len(self._events) - self._replay_pending
                    >= self._max_queued):
                self._evict_locked()
                return
            self._events.extend(events)
            self._cond.notify_all()
            if self._notify_cb is not None:
                self._notify_cb()

    def _wait_locked(self, timeout: Optional[float]) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        # predicate loop: a spurious wakeup is not end-of-stream
        while not self._events and not self._stopped:
            if deadline is None:
                self._cond.wait()
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    break

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        with self._cond:
            self._wait_locked(timeout)
            if not self._events:
                return None
            if self._replay_pending:
                self._replay_pending -= 1  # the replay drains first
            return self._events.pop(0)

    def next_batch(self, timeout: Optional[float] = None) -> List[WatchEvent]:
        """Drain everything queued in one condvar hold (empty list on
        timeout or stop): a wave's thousands of bind events cost the
        informer one lock round-trip."""
        with self._cond:
            self._wait_locked(timeout)
            out, self._events = self._events, []
            self._replay_pending = 0
            return out

    def kill(self) -> None:
        """Die as a dropped stream would: stop and wake the consumer with
        end of stream, without deregistering (the fanout prunes it)."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
            if self._notify_cb is not None:
                self._notify_cb()

    def stop(self) -> None:
        self.kill()
        self._store._remove_watch(self._kind, self)

    def set_notify(self, cb: Optional[Callable[[], None]]) -> None:
        """Install the edge-trigger hook.  Fires once immediately when
        events are already queued or the watch is already stopped, so a
        registration can never miss the edge that happened just before
        it."""
        with self._cond:
            self._notify_cb = cb
            pending = bool(self._events) or self._stopped
            if pending and cb is not None:
                cb()

    @property
    def stopped(self) -> bool:
        return self._stopped


def _walk_bytes(x: Any) -> int:
    """Footprint estimate (proportional, not exact): strings and
    containers by length, objects through ``__dict__``, private fields
    skipped."""
    if x is None:
        return 8
    if isinstance(x, str):
        return 56 + len(x)
    if isinstance(x, (int, float, bool)):
        return 32
    if isinstance(x, dict):
        return 64 + sum(_walk_bytes(k) + _walk_bytes(v) for k, v in x.items())
    if isinstance(x, (list, tuple, set, frozenset)):
        return 56 + sum(_walk_bytes(v) for v in x)
    d = getattr(x, "__dict__", None)
    if d is not None:
        return 64 + sum(_walk_bytes(v) for k, v in d.items()
                        if not k.startswith("_"))
    return 64


def approx_obj_bytes(obj: Any) -> int:
    """The history ring's per-object size estimate.  The spec walk is
    memoized on the spec, which is never mutated once stored and which a
    bind shares between the pending and the bound pod."""
    total = 256
    meta = getattr(obj, "metadata", None)
    if meta is not None:
        total += 128 + _walk_bytes(meta.labels) + _walk_bytes(meta.annotations)
    spec = getattr(obj, "spec", None)
    if spec is not None:
        d = getattr(spec, "__dict__", None)
        if d is None:
            total += _walk_bytes(spec)
        else:
            memo = d.get("_approx_bytes_memo")
            if memo is None:
                memo = d["_approx_bytes_memo"] = _walk_bytes(spec)
            total += memo
    return total


def compute_node_agg(pods) -> Dict[str, List[int]]:
    """Per-node ``[milli_cpu, memory, pods]`` summed over BOUND pods —
    the independent recompute of ``ObjectStore._pod_node_agg``."""
    agg: Dict[str, List[int]] = {}
    for pod in pods:
        node = pod.spec.node_name
        if not node:
            continue
        req = pod.resource_requests()
        a = agg.get(node)
        if a is None:
            a = agg[node] = [0, 0, 0]
        a[0] += req.milli_cpu
        a[1] += req.memory
        a[2] += req.pods
    return agg


class _ReadSnapshot:
    """One immutable view of the published store state: ``maps`` (kind →
    {key → stored object}) and the ``rv`` they reflect, swapped in as one
    reference at every publish point.  A reader grabs ``store._snap``
    once and holds a consistent epoch without the store lock; sharing the
    stored objects is safe because the store never mutates one.

    Two memos live and die with the snapshot, filled lazily off the store
    lock; a miss serializes on the snapshot's own ``_mu`` so a relist
    storm encodes once.  ``list_bodies``: (kind, namespace) → the encoded
    REST list body (``store.list_cache.encodes`` / ``.hits``).
    ``replay_events``: kind → the shared ADDED events a full-snapshot
    watch open replays (``born`` 0: a replay is not fanout), so the wire
    memo encodes each object once however many streams replay it."""

    __slots__ = ("maps", "rv", "list_bodies", "replay_events", "_mu")

    def __init__(self, maps: Dict[str, Dict[str, Any]], rv: int) -> None:
        self.maps = maps
        self.rv = rv
        self.list_bodies: Dict[Tuple[str, str], bytes] = {}
        self.replay_events: Dict[str, List[WatchEvent]] = {}
        self._mu = threading.Lock()

    def list_body(self, kind: str, ns: str,
                  build: Callable[[], bytes]) -> bytes:
        """The memoized encoded list payload for (kind, namespace)."""
        from minisched_tpu_torch.observability import counters

        body = self.list_bodies.get((kind, ns))
        if body is None:
            with self._mu:
                body = self.list_bodies.get((kind, ns))
                if body is None:
                    body = build()
                    self.list_bodies[(kind, ns)] = body
                    counters.inc("store.list_cache.encodes")
                    return body
        counters.inc("store.list_cache.hits")
        return body

    def replay_events_for(self, kind: str) -> List[WatchEvent]:
        evs = self.replay_events.get(kind)
        if evs is None:
            with self._mu:
                evs = self.replay_events.get(kind)
                if evs is None:
                    evs = []
                    for obj in self.maps.get(kind, {}).values():
                        ev = WatchEvent(EventType.ADDED, obj,
                                        rv=obj.metadata.resource_version)
                        ev.born = 0.0  # replay, not fanout
                        evs.append(ev)
                    self.replay_events[kind] = evs
        return evs


class ObjectStore:
    """Versioned multi-kind object store + watch hub."""

    def __init__(self, history_events: int = DEFAULT_HISTORY_EVENTS,
                 history_bytes: int = DEFAULT_HISTORY_BYTES,
                 watch_queue_events: int = DEFAULT_WATCH_QUEUE_EVENTS
                 ) -> None:
        self._lock = threading.RLock()
        #: per-watcher queue bound (``DEFAULT_WATCH_QUEUE_EVENTS``)
        self._watch_queue_events = max(int(watch_queue_events), 1)
        # per kind: (event, estimated bytes) in mutation order, and the
        # highest rv no longer retained (a resume below it is refused)
        self._history: Dict[str, deque] = {}
        self._history_cap = max(int(history_events), 0)
        self._history_byte_cap = max(int(history_bytes), 0)
        self._history_bytes_used: Dict[str, int] = {}
        self._history_floors: Dict[str, int] = {}
        #: the floor of every kind whatever its ring holds: a durable
        #: reopen sets it to the checkpoint's rv
        self._history_floor_min = 0
        self._objects: Dict[str, Dict[str, Any]] = {}  # kind -> key -> obj
        self._watches: Dict[str, List[Watch]] = {}
        self._rv = 0
        #: the sequence behind generated uids (``<kind>-<n:08d>``, as the
        #: JAX store names them), per store
        self._uid_seq = 0
        # node name → [milli_cpu, memory bytes, pod count] summed over the
        # pods bound there, folded in by every Pod commit
        self._pod_node_agg: Dict[str, List[int]] = {}
        #: fault-injection hook, called as (op, kind, key) before every
        #: mutation and read; raising fails the call as a flaky store
        #: would; ``faults.FaultFabric.as_store_injector()`` is one
        self.fault_injector: Optional[Callable[[str, str, str], None]] = None
        #: the fault fabric the durable store's disk points read
        #: (``disk.enospc``, ``wal.append``, ``wal.bitflip``, ...); None
        self.faults: Any = None
        #: the copy-on-write read plane: the published view lock-free
        #: readers serve from; None with ``MINISCHED_COW_READS=0``
        self._snap: Optional[_ReadSnapshot] = (
            _ReadSnapshot({}, 0)
            if os.environ.get("MINISCHED_COW_READS", "1") != "0" else None)

    # -- helpers -----------------------------------------------------------
    def _maybe_fault(self, op: str, kind: str, key: str) -> None:
        fi = self.fault_injector  # one read: the hook may be cleared
        if fi is not None:
            fi(op, kind, key)

    def _bump(self) -> int:
        self._rv += 1
        return self._rv

    def _stamp_new(self, kind: str, obj: Any) -> Any:
        """The stored copy of a created object: uid (when unset),
        resource_version and creation time stamped (caller holds the
        lock)."""
        stored = obj.clone()
        if not stored.metadata.uid:
            self._uid_seq += 1
            stored.metadata.uid = f"{kind.lower()}-{self._uid_seq:08d}"
        stored.metadata.resource_version = self._bump()
        if not stored.metadata.creation_timestamp:
            stored.metadata.creation_timestamp = time.time()
        return stored

    def _node_agg_track(self, kind: str, old: Any, new: Any) -> None:
        """Fold one Pod mutation into the per-node request aggregates
        (caller holds the lock).  ``old``/``new`` are the stored objects
        before/after (None for create/delete)."""
        if kind != "Pod":
            return
        agg = self._pod_node_agg
        for obj, sign in ((old, -1), (new, 1)):
            if obj is None:
                continue
            node = obj.spec.node_name
            if not node:
                continue
            req = obj.resource_requests()
            a = agg.get(node)
            if a is None:
                a = agg[node] = [0, 0, 0]
            a[0] += sign * req.milli_cpu
            a[1] += sign * req.memory
            a[2] += sign * req.pods
            if sign < 0 and not (a[0] or a[1] or a[2]):
                del agg[node]  # bound pods all gone: don't accrete names

    def _rebuild_node_agg(self) -> None:
        """Recompute the per-node aggregates from the live objects: the
        recovery paths (WAL replay, checkpoint restore) write
        ``_objects`` directly and call this once at the end."""
        with self._lock:
            self._pod_node_agg = {}
            for pod in self._objects.get("Pod", {}).values():
                self._node_agg_track("Pod", None, pod)

    def _cow_publish(self, kinds) -> None:
        """Swap the read-plane snapshot (caller holds the lock, after the
        commit and its fanout): fresh copies of the maps of ``kinds``,
        every other kind's frozen map reused, the published rv, installed
        as one reference.  Readers of the old snapshot keep their epoch;
        a publisher's own mutation is in the snapshot before its call
        returns.  Empty ``kinds`` refreshes the rv only."""
        snap = self._snap
        if snap is None:
            return  # MINISCHED_COW_READS=0: reads take the lock
        if kinds:
            maps = dict(snap.maps)
            for kind in kinds:
                maps[kind] = dict(self._objects.get(kind, ()))
        else:
            maps = snap.maps
        self._snap = _ReadSnapshot(maps, self._visible_rv())

    def read_plane(self) -> Optional[_ReadSnapshot]:
        """The current read snapshot (None with the plane off): the REST
        façade and the gRPC servicer serve list bodies from it."""
        return self._snap

    def _record_history(self, kind: str, event: WatchEvent) -> None:
        """Append one event to the kind's resume ring (caller holds the
        lock); overflow by count or by bytes advances the kind's floor.
        The ring keeps its own event without ``old_obj`` (a resume never
        sends it) and apart from the fanned-out one (whose memoized wire
        bytes must not stay pinned in the ring)."""
        if self._history_cap <= 0:
            return
        ring = self._history.get(kind)
        if ring is None:
            ring = self._history[kind] = deque()
        event = WatchEvent(event.type, event.obj, rv=event.rv)
        cost = approx_obj_bytes(event.obj) + 96
        used = self._history_bytes_used.get(kind, 0) + cost
        while ring and (len(ring) >= self._history_cap
                        or (self._history_byte_cap > 0
                            and used > self._history_byte_cap)):
            dropped, dropped_cost = ring.popleft()
            used -= dropped_cost
            self._history_floors[kind] = max(
                self._history_floors.get(kind, 0), dropped.rv)
        ring.append((event, cost))
        self._history_bytes_used[kind] = used

    def history_stats(self, kind: str) -> Dict[str, int]:
        """(events retained, estimated bytes retained) for one kind."""
        with self._lock:
            return {"events": len(self._history.get(kind, ())),
                    "bytes": self._history_bytes_used.get(kind, 0)}

    def _floor_for(self, kind: str) -> int:
        return max(self._history_floor_min, self._history_floors.get(kind, 0))

    def set_history_floor(self, rv: int) -> None:
        """Raise the resume floor of every kind (never lowers it): the
        durable store's replay sets it to the checkpoint's rv, since the
        events at or before it cannot be replayed."""
        with self._lock:
            self._history_floor_min = max(self._history_floor_min, rv)

    @property
    def history_floor(self) -> int:
        """The floor of every kind (a kind's ring overflow can sit higher;
        ``watch`` checks both)."""
        with self._lock:
            return self._history_floor_min

    def _fanout(self, kind: str, events: List[WatchEvent]) -> None:
        # events carry the STORED objects: the store never mutates an
        # object after it lands, so observers can never see one change
        for ev in events:
            self._record_history(kind, ev)
        for w in list(self._watches.get(kind, ())):
            if w.stopped:
                # killed or evicted: pruned here, as a dropped stream
                self._remove_watch(kind, w)
                continue
            w._deliver_many(events)

    # -- CRUD --------------------------------------------------------------
    def create(self, kind: str, obj: Any) -> Any:
        with self._lock:
            objs = self._objects.setdefault(kind, {})
            key = obj.metadata.key
            self._maybe_fault("create", kind, key)
            if key in objs:
                raise KeyError(f"{kind} {key!r} already exists")
            stored = self._stamp_new(kind, obj)
            # durability before commit: the record lands before the object
            # enters the maps, so a failed append means the mutation never
            # happened (the rv it took is a gap; gaps are legal)
            self._commit_record(kind, "put", stored,
                                stored.metadata.resource_version)
            objs[key] = stored
            self._node_agg_track(kind, None, stored)
            self._fanout(kind, [WatchEvent(
                EventType.ADDED, stored, rv=stored.metadata.resource_version)])
            self._cow_publish((kind,))
            return stored.clone()

    def create_many(self, kind: str, objs: List[Any],
                    return_objects: bool = True) -> List[Any]:
        """Batch create under ONE lock hold and one fanout.  Returns a list
        aligned with ``objs``: the stored clone (None with
        ``return_objects=False``), or the exception for that entry
        (KeyError on conflict) — one failed item never aborts the rest.
        Every record lands (``_on_batch_commit``, then one ``_flush_log``)
        before the batch's fanout."""
        out: List[Any] = []
        events: List[WatchEvent] = []
        with self._lock:
            objs_map = self._objects.setdefault(kind, {})
            for obj in objs:
                key = obj.metadata.key
                try:
                    self._maybe_fault("create", kind, key)
                    if key in objs_map:
                        raise KeyError(f"{kind} {key!r} already exists")
                    stored = self._stamp_new(kind, obj)
                    # a refused append fails this item only
                    self._on_batch_commit(kind, stored)
                    objs_map[key] = stored
                    self._node_agg_track(kind, None, stored)
                    out.append(stored.clone() if return_objects else None)
                    events.append(WatchEvent(
                        EventType.ADDED, stored,
                        rv=stored.metadata.resource_version))
                except Exception as err:  # returned per item, not lost
                    out.append(err)
            self._flush_log()
            self._fanout(kind, events)
            self._cow_publish((kind,))
        return out

    def get(self, kind: str, namespace: str, name: str) -> Any:
        snap = self._snap
        if snap is not None:
            # lock-free: one reference grab is the whole read
            self._maybe_fault("get", kind, f"{namespace}/{name}")
            obj = snap.maps.get(kind, {}).get(f"{namespace}/{name}")
            if obj is None:
                raise KeyError(f"{kind} {namespace}/{name} not found")
            return obj.clone()
        with self._lock:
            self._maybe_fault("get", kind, f"{namespace}/{name}")
            obj = self._objects.get(kind, {}).get(f"{namespace}/{name}")
            if obj is None:
                raise KeyError(f"{kind} {namespace}/{name} not found")
            return obj.clone()

    def list(self, kind: str) -> List[Any]:
        snap = self._snap
        if snap is not None:
            self._maybe_fault("list", kind, "")
            return [o.clone() for o in snap.maps.get(kind, {}).values()]
        with self._lock:
            self._maybe_fault("list", kind, "")
            return [o.clone() for o in self._objects.get(kind, {}).values()]

    def list_with_rv(self, kind: str) -> Tuple[List[Any], int]:
        """(snapshot, the resource_version it reflects): off the read
        plane, whose maps and rv were published together; with the plane
        off, under one lock hold (the published rv, ``_visible_rv``)."""
        snap = self._snap
        if snap is not None:
            self._maybe_fault("list", kind, "")
            return ([o.clone() for o in snap.maps.get(kind, {}).values()],
                    snap.rv)
        with self._lock:
            self._maybe_fault("list", kind, "")
            return ([o.clone() for o in self._objects.get(kind, {}).values()],
                    self._visible_rv())

    def update(self, kind: str, obj: Any,
               expected_rv: Optional[int] = None) -> Any:
        """``expected_rv``: the write commits only if the stored object
        still carries that version — otherwise Conflict."""
        with self._lock:
            objs = self._objects.setdefault(kind, {})
            key = obj.metadata.key
            self._maybe_fault("update", kind, key)
            old = objs.get(key)
            if old is None:
                raise KeyError(f"{kind} {key!r} not found")
            if (expected_rv is not None
                    and old.metadata.resource_version != expected_rv):
                raise Conflict(
                    f"stale resource_version for {kind} {key}: expected "
                    f"{expected_rv}, have {old.metadata.resource_version}")
            stored = obj.clone()
            stored.metadata.uid = old.metadata.uid
            stored.metadata.creation_timestamp = old.metadata.creation_timestamp
            stored.metadata.resource_version = self._bump()
            self._commit_record(kind, "put", stored,
                                stored.metadata.resource_version)
            objs[key] = stored
            self._node_agg_track(kind, old, stored)
            self._fanout(kind, [WatchEvent(
                EventType.MODIFIED, stored, old,
                rv=stored.metadata.resource_version)])
            self._cow_publish((kind,))
            return stored.clone()

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._lock:
            objs = self._objects.get(kind, {})
            key = f"{namespace}/{name}"
            self._maybe_fault("delete", kind, key)
            old = objs.get(key)
            if old is None:
                raise KeyError(f"{kind} {key!r} not found")
            rv = self._bump()
            self._commit_record(kind, "del", old, rv)
            objs.pop(key, None)
            self._node_agg_track(kind, old, None)
            self._fanout(kind, [WatchEvent(EventType.DELETED, old, rv=rv)])
            self._cow_publish((kind,))

    def mutate(self, kind: str, namespace: str, name: str,
               fn: Callable[[Any], Any]) -> Any:
        """Read-modify-write under the store lock."""
        with self._lock:
            obj = self.get(kind, namespace, name)
            updated = fn(obj) or obj
            return self.update(kind, updated)

    def mutate_many(
        self,
        kind: str,
        items: List[Tuple[str, str, Callable[[Any], Any]]],
        return_objects: bool = True,
        clone_for_write: bool = True,
        prepare: Optional[Callable[["ObjectStore"], None]] = None,
    ) -> List[Any]:
        """Many read-modify-writes under ONE lock hold and one fanout — the
        wave engine's batch bind.  ``items``: (namespace, name, fn)
        triples.  Returns a list aligned with ``items``: the updated
        object (None with ``return_objects=False``), or the exception
        that item raised — one failed bind never aborts the rest.

        ``clone_for_write=False`` hands ``fn`` the STORED object: it must
        return a NEW object (with its own metadata) and leave the stored
        one untouched, sharing what it does not change.  ``prepare`` runs
        under the lock before the items, with this store: the
        capacity-checked bind derives its node budgets there, atomically
        with the commits."""
        out: List[Any] = []
        events: List[WatchEvent] = []
        with self._lock:
            if prepare is not None:
                prepare(self)
            objs = self._objects.setdefault(kind, {})
            for namespace, name, fn in items:
                key = f"{namespace}/{name}"
                try:
                    self._maybe_fault("update", kind, key)
                    old = objs.get(key)
                    if old is None:
                        raise KeyError(f"{kind} {key!r} not found")
                    if clone_for_write:
                        work = old.clone()
                        work = fn(work) or work
                    else:
                        work = fn(old)
                    work.metadata.uid = old.metadata.uid
                    work.metadata.creation_timestamp = (
                        old.metadata.creation_timestamp)
                    work.metadata.resource_version = self._bump()
                    # durability before commit: a refused append fails
                    # this item, memory stays clean
                    self._on_batch_commit(kind, work)
                    objs[key] = work
                    self._node_agg_track(kind, old, work)
                    out.append(work.clone() if return_objects else None)
                    events.append(WatchEvent(
                        EventType.MODIFIED, work, old,
                        rv=work.metadata.resource_version))
                except Exception as err:  # returned per item, not lost
                    out.append(err)
            # the batch's records are forced to disk before its events
            # become visible; one batched fanout, under the lock
            self._flush_log()
            self._fanout(kind, events)
            self._cow_publish((kind,))
        return out

    # -- durability hooks (the durable store overrides them) ---------------
    def _on_batch_commit(self, kind: str, obj: Any) -> None:
        """Per-item durability hook of the batch paths (``create_many``,
        ``mutate_many``), called with the lock held before the item's
        object enters the maps."""

    def _commit_record(self, kind: str, op: str, obj: Any, rv: int) -> None:
        """Single-op durability hook, called with the lock held before
        the in-memory commit and the fanout.  ``op`` is "put" or "del";
        ``obj`` is the stored object (put) or the removed one (del)."""

    def _flush_log(self) -> None:
        """The batch paths' durability barrier: force the pending records
        to disk before their events become visible."""

    def _visible_rv(self) -> int:
        """The resource_version the published state reflects (caller
        holds the lock): ``_rv`` here; the group-commit durable store
        publishes reserved rvs only after its barrier, so its visible rv
        lags the counter while mutations are staged.  Snapshot stamps
        (``watch``'s start_rv, ``list_with_rv``) use this."""
        return self._rv

    @property
    def resource_version(self) -> int:
        with self._lock:
            return self._rv

    def is_fenced(self) -> bool:
        """True when the store refuses writes because it follows a
        leader's replicated stream (``durable.DurableObjectStore.fence``);
        an in-memory store always leads."""
        return False

    def applied_rv(self) -> int:
        """The rv watermark of the state this store would serve right
        now: the read plane's stamp, or the published rv under the lock
        with the plane off."""
        snap = self._snap
        if snap is not None:
            return snap.rv
        with self._lock:
            return self._visible_rv()

    def locked(self):
        """The store's lock as a context manager, for multi-call reads
        that need one consistent view."""
        return self._lock

    def restore_object(self, kind: str, obj: Any) -> None:
        """Checkpoint-restore insert: keeps the object's uid and
        resource_version (``create`` would re-stamp both) and fans out
        ADDED."""
        with self._lock:
            objs = self._objects.setdefault(kind, {})
            key = obj.metadata.key
            if key in objs:
                raise KeyError(f"{kind} {key!r} already exists")
            stored = obj.clone()
            self._commit_record(kind, "put", stored,
                                stored.metadata.resource_version)
            objs[key] = stored
            self._node_agg_track(kind, None, stored)
            self._rv = max(self._rv, stored.metadata.resource_version)
            self._fanout(kind, [WatchEvent(
                EventType.ADDED, stored,
                rv=stored.metadata.resource_version)])
            self._cow_publish((kind,))

    def set_resource_version(self, rv: int) -> None:
        """Fast-forward the version counter (checkpoint restore), never
        backwards."""
        with self._lock:
            self._rv = max(self._rv, rv)
            self._cow_publish(())

    def close(self) -> None:
        """Release the store's resources: nothing in memory (the durable
        store closes its log)."""

    # -- watch -------------------------------------------------------------
    def watch(self, kind: str, send_initial: bool = True,
              resume_rv: Optional[int] = None,
              clone_snapshot: bool = True) -> Tuple[Watch, List[Any]]:
        """Open a watch; returns (watch, current snapshot).
        ``send_initial`` replays the snapshot as ADDED events into the
        watch (list+watch), atomically with the registration.

        ``resume_rv`` resumes instead: the watch first delivers the
        retained events with rv > resume_rv (copies, no snapshot), then
        goes live, atomically with the registration.  HistoryCompacted
        when the ring no longer reaches back to resume_rv, or resume_rv
        is ahead of the store.  ``clone_snapshot=False`` returns the
        stored objects themselves, for a caller that only counts them.
        A full open reads the read plane (``_watch_cow``) when it is on.
        The replay queued at the open is exempt from the queue bound."""
        snap = self._snap
        if snap is not None and resume_rv is None:
            return self._watch_cow(kind, snap, send_initial, clone_snapshot)
        with self._lock:
            w = Watch(self, kind, self._watch_queue_events)
            if resume_rv is not None:
                floor = self._floor_for(kind)
                if resume_rv < floor:
                    raise HistoryCompacted(
                        f"resource_version {resume_rv} compacted away "
                        f"for {kind} (floor {floor})")
                if resume_rv > self._rv:
                    if self.is_fenced():
                        raise NotYetObserved(
                            f"resource_version {resume_rv} not yet "
                            f"observed by this replica (applied {self._rv})")
                    # the consumer saw versions a crash rolled back
                    raise HistoryCompacted(
                        f"resource_version {resume_rv} is ahead of this "
                        f"server (at {self._rv}): recovered from older "
                        f"state; relist required")
                w.start_rv = resume_rv
                w._deliver_many([
                    WatchEvent(ev.type, ev.obj, rv=ev.rv)
                    for ev, _cost in self._history.get(kind, ())
                    if ev.rv > resume_rv])
                self._watches.setdefault(kind, []).append(w)
                with w._cond:
                    w._replay_pending = len(w._events)
                    w._live = True
                return w, []
            w.start_rv = self._visible_rv()
            objs = list(self._objects.get(kind, {}).values())
            if send_initial:
                w._deliver_many([
                    WatchEvent(EventType.ADDED, obj,
                               rv=obj.metadata.resource_version)
                    for obj in objs])
            self._watches.setdefault(kind, []).append(w)
            with w._cond:
                w._replay_pending = len(w._events)
                w._live = True
            return w, [o.clone() for o in objs] if clone_snapshot else objs

    def _watch_cow(self, kind: str, snap: _ReadSnapshot, send_initial: bool,
                   clone_snapshot: bool) -> Tuple[Watch, List[Any]]:
        """A full-snapshot open off the read plane: the replay (shared per
        snapshot) and the returned snapshot come from the immutable view
        off the lock; only the registration takes it, and it starts over
        from the fresh view if a publish swapped the snapshot meanwhile
        (those events are not in this replay)."""
        w = Watch(self, kind, self._watch_queue_events)
        while True:
            events = snap.replay_events_for(kind) if send_initial else None
            with self._lock:
                if self._snap is not snap:
                    snap = self._snap
                    continue  # lost the race with a publish
                w.start_rv = snap.rv
                if events:
                    w._deliver_many(events)
                self._watches.setdefault(kind, []).append(w)
                with w._cond:
                    w._replay_pending = len(w._events)
                    w._live = True
            objs = snap.maps.get(kind, {}).values()
            if clone_snapshot:
                return w, [o.clone() for o in objs]
            return w, list(objs)

    def _remove_watch(self, kind: str, w: Watch) -> None:
        with self._lock:
            lst = self._watches.get(kind, [])
            if w in lst:
                lst.remove(w)
