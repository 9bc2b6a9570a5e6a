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

Left out, as no engine path needs them: the durable (WAL), replicated,
sharded and remote stores, watch resume from history (an in-process
watch never breaks), the copy-on-write read plane and the fault hooks.
Without resume the per-watcher queues are unbounded: a watcher is never
evicted, because nothing could reconnect it.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple


class EventType(enum.Enum):
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"


class Conflict(Exception):
    """Optimistic-concurrency failure: the caller's ``expected_rv``
    precondition did not match the stored object's resource_version."""


class StorageDegraded(Exception):
    """The store cannot persist mutations.  The in-memory store never
    raises it; the engine parks and retries on it, as it does against
    the JAX package's durable store."""


@dataclass
class WatchEvent:
    type: EventType
    obj: Any
    old_obj: Any = None
    #: the resource_version of the mutation that produced this event
    rv: int = 0


class Watch:
    """A subscription to one kind's event stream."""

    def __init__(self, store: "ObjectStore", kind: str):
        self._store = store
        self._kind = kind
        self._cond = threading.Condition()
        self._events: List[WatchEvent] = []
        self._stopped = False

    # called by the store while it holds its lock; only touches this
    # watch's own condition and queue, so it cannot block on user code
    def _deliver_many(self, events: List[WatchEvent]) -> None:
        if not events:
            return
        with self._cond:
            if self._stopped:
                return
            self._events.extend(events)
            self._cond.notify_all()

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
            return self._events.pop(0) if self._events else None

    def next_batch(self, timeout: Optional[float] = None) -> List[WatchEvent]:
        """Drain everything queued in one condvar hold (empty list on
        timeout or stop): a wave's thousands of bind events cost the
        informer one lock round-trip."""
        with self._cond:
            self._wait_locked(timeout)
            out, self._events = self._events, []
            return out

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._store._remove_watch(self._kind, self)

    @property
    def stopped(self) -> bool:
        return self._stopped


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


class ObjectStore:
    """Versioned multi-kind object store + watch hub."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._objects: Dict[str, Dict[str, Any]] = {}  # kind -> key -> obj
        self._watches: Dict[str, List[Watch]] = {}
        self._rv = 0
        #: the sequence behind generated uids (``<kind>-<n:08d>``, as the
        #: JAX store names them), per store
        self._uid_seq = 0
        # node name → [milli_cpu, memory bytes, pod count] summed over the
        # pods bound there, folded in by every Pod commit
        self._pod_node_agg: Dict[str, List[int]] = {}

    # -- helpers -----------------------------------------------------------
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

    def _fanout(self, kind: str, events: List[WatchEvent]) -> None:
        # events carry the STORED objects: the store never mutates an
        # object after it lands, so observers can never see one change
        for w in list(self._watches.get(kind, ())):
            w._deliver_many(events)

    # -- CRUD --------------------------------------------------------------
    def create(self, kind: str, obj: Any) -> Any:
        with self._lock:
            objs = self._objects.setdefault(kind, {})
            key = obj.metadata.key
            if key in objs:
                raise KeyError(f"{kind} {key!r} already exists")
            stored = self._stamp_new(kind, obj)
            objs[key] = stored
            self._node_agg_track(kind, None, stored)
            self._fanout(kind, [WatchEvent(
                EventType.ADDED, stored, rv=stored.metadata.resource_version)])
            return stored.clone()

    def create_many(self, kind: str, objs: List[Any],
                    return_objects: bool = True) -> List[Any]:
        """Batch create under ONE lock hold and one fanout.  Returns a list
        aligned with ``objs``: the stored clone (None with
        ``return_objects=False``), or the exception for that entry
        (KeyError on conflict) — one failed item never aborts the rest."""
        out: List[Any] = []
        events: List[WatchEvent] = []
        with self._lock:
            objs_map = self._objects.setdefault(kind, {})
            for obj in objs:
                key = obj.metadata.key
                if key in objs_map:
                    out.append(KeyError(f"{kind} {key!r} already exists"))
                    continue
                stored = self._stamp_new(kind, obj)
                objs_map[key] = stored
                self._node_agg_track(kind, None, stored)
                out.append(stored.clone() if return_objects else None)
                events.append(WatchEvent(
                    EventType.ADDED, stored,
                    rv=stored.metadata.resource_version))
            self._fanout(kind, events)
        return out

    def get(self, kind: str, namespace: str, name: str) -> Any:
        with self._lock:
            obj = self._objects.get(kind, {}).get(f"{namespace}/{name}")
            if obj is None:
                raise KeyError(f"{kind} {namespace}/{name} not found")
            return obj.clone()

    def list(self, kind: str) -> List[Any]:
        with self._lock:
            return [o.clone() for o in self._objects.get(kind, {}).values()]

    def list_with_rv(self, kind: str) -> Tuple[List[Any], int]:
        """(snapshot, the resource_version it reflects), under one lock
        hold."""
        with self._lock:
            return self.list(kind), self._rv

    def update(self, kind: str, obj: Any,
               expected_rv: Optional[int] = None) -> Any:
        """``expected_rv``: the write commits only if the stored object
        still carries that version — otherwise Conflict."""
        with self._lock:
            objs = self._objects.setdefault(kind, {})
            key = obj.metadata.key
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
            objs[key] = stored
            self._node_agg_track(kind, old, stored)
            self._fanout(kind, [WatchEvent(
                EventType.MODIFIED, stored, old,
                rv=stored.metadata.resource_version)])
            return stored.clone()

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._lock:
            objs = self._objects.get(kind, {})
            key = f"{namespace}/{name}"
            old = objs.pop(key, None)
            if old is None:
                raise KeyError(f"{kind} {key!r} not found")
            rv = self._bump()
            self._node_agg_track(kind, old, None)
            self._fanout(kind, [WatchEvent(EventType.DELETED, old, rv=rv)])

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
                    objs[key] = work
                    self._node_agg_track(kind, old, work)
                    out.append(work.clone() if return_objects else None)
                    events.append(WatchEvent(
                        EventType.MODIFIED, work, old,
                        rv=work.metadata.resource_version))
                except Exception as err:  # returned per item, not lost
                    out.append(err)
            self._fanout(kind, events)
        return out

    @property
    def resource_version(self) -> int:
        with self._lock:
            return self._rv

    # -- watch -------------------------------------------------------------
    def watch(self, kind: str,
              send_initial: bool = True) -> Tuple[Watch, List[Any]]:
        """Open a watch; returns (watch, current snapshot).
        ``send_initial`` replays the snapshot as ADDED events into the
        watch (list+watch), atomically with the registration."""
        with self._lock:
            w = Watch(self, kind)
            objs = list(self._objects.get(kind, {}).values())
            if send_initial:
                w._deliver_many([
                    WatchEvent(EventType.ADDED, obj,
                               rv=obj.metadata.resource_version)
                    for obj in objs])
            self._watches.setdefault(kind, []).append(w)
            return w, [o.clone() for o in objs]

    def _remove_watch(self, kind: str, w: Watch) -> None:
        with self._lock:
            lst = self._watches.get(kind, [])
            if w in lst:
                lst.remove(w)
