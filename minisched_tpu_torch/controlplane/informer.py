"""Informer machinery: cached watches with event-handler fanout.

A copy of the in-process part of ``minisched_tpu/controlplane/informer.py``
(``:39-636``): the client-go ``SharedInformerFactory`` surface — handler
registration with filtering and a batch fast path, ``start``,
``wait_for_cache_sync``, cache reads (``lister``, ``get``, ``get_many``)
and the dispatch gate the wave engine closes around a bind.

Each informer runs ONE dispatch thread that drains its store watch and
invokes the registered handlers in order; late-registration cache
replays run on that thread too, so handlers are never called
concurrently and always observe events in cache order.  Handlers run on
these threads: they must never touch a CUDA tensor (only the engine
thread evaluates on the card).

Left out: the reconnect path (resume, relist and its jitter).  An
in-process watch never breaks, so ``on_reconnect`` callbacks are kept for
the engine to register but never fire.
"""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from minisched_tpu_torch.controlplane.store import (
    EventType,
    ObjectStore,
    Watch,
    WatchEvent,
)

Handler = Callable[[Any], None]
UpdateHandler = Callable[[Any, Any], None]


@dataclass
class ResourceEventHandlers:
    """AddFunc/UpdateFunc/DeleteFunc bundle (cache.ResourceEventHandlerFuncs)."""

    on_add: Optional[Handler] = None
    on_update: Optional[UpdateHandler] = None
    on_delete: Optional[Handler] = None
    #: FilteringResourceEventHandler: events whose object fails it skip
    #: the per-event handlers
    filter: Optional[Callable[[Any], bool]] = None
    #: batch fast path: when set, the dispatch thread hands the handler
    #: the whole list of normalized WatchEvents in one call, and
    #: on_add/on_update/on_delete are ignored.  The batch handler sees
    #: the same events in the same order, applies ``filter`` itself, and
    #: must contain errors per event (a raise loses the rest of its batch).
    on_batch: Optional[Callable[[List[WatchEvent]], None]] = None


class Informer:
    def __init__(self, store: ObjectStore, kind: str):
        self._store = store
        self._kind = kind
        self._handlers: List[ResourceEventHandlers] = []
        self._lock = threading.Lock()
        self._cache: Dict[str, Any] = {}
        # late-registration replays, delivered by the dispatch thread
        self._pending_replays: List[
            Tuple[ResourceEventHandlers, List[WatchEvent]]] = []
        self._thread: Optional[threading.Thread] = None
        self._watch: Optional[Watch] = None
        self._initial = 0
        self._synced = threading.Event()
        self._stop = threading.Event()
        # dispatch gate (set = running).  The wave engine closes it for
        # the host stretch after a bind (snapshot, table build) so the
        # handler work for that bind's thousands of events lands in the
        # next device call instead of contending with the engine's own
        # Python.  Soft: the timed wait bounds a forgotten gate.
        self._gate = threading.Event()
        self._gate.set()
        #: callbacks to run after a watch reconnect (never, in process)
        self.on_reconnect: List[Callable[[], None]] = []

    def add_event_handlers(self, handlers: ResourceEventHandlers) -> None:
        with self._lock:
            self._handlers.append(handlers)
            # client-go replays the cache as adds to late registrants; the
            # dispatch thread delivers them (see _drain_replays)
            replay = [WatchEvent(EventType.ADDED, obj)
                      for obj in self._cache.values()]
            if replay:
                self._pending_replays.append((handlers, replay))

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._synced.clear()
        # registered atomically with the snapshot replay it queues
        self._watch, snapshot = self._store.watch(self._kind,
                                                  send_initial=True)
        self._initial = len(snapshot)
        if not self._initial:
            self._synced.set()
        self._thread = threading.Thread(
            target=self._run, name=f"informer-{self._kind}", daemon=True)
        self._thread.start()

    def _drain_replays(self) -> None:
        while True:
            with self._lock:
                if not self._pending_replays:
                    return
                handlers, events = self._pending_replays.pop(0)
            self._invoke(handlers, events)

    def _run(self) -> None:
        seen = 0
        while not self._stop.is_set():
            self._drain_replays()
            batch = self._watch.next_batch(timeout=0.1)
            if not batch:
                if self._watch.stopped:
                    return
                continue
            if not self._gate.is_set():
                # a gated batch is HELD, not dropped: the engine opens the
                # gate entering its next device call
                self._gate.wait(timeout=2.0)
            # normalize the whole batch under ONE cache-lock hold (DELETED
            # resolves to the cached object, MODIFIED picks up old_obj)
            normalized: List[WatchEvent] = []
            with self._lock:
                for ev in batch:
                    key = ev.obj.metadata.key
                    if ev.type == EventType.DELETED:
                        old = self._cache.pop(key, None)
                        if old is not None:
                            ev = WatchEvent(EventType.DELETED, old, rv=ev.rv)
                    elif ev.type == EventType.MODIFIED:
                        ev = WatchEvent(EventType.MODIFIED, ev.obj,
                                        self._cache.get(key), rv=ev.rv)
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

    def _invoke(self, h: ResourceEventHandlers,
                events: List[WatchEvent]) -> None:
        """One handler over a batch: ``on_batch`` takes the whole list;
        otherwise events dispatch one at a time.  A handler's error is
        printed and never kills the stream."""
        if h.on_batch is not None:
            try:
                h.on_batch(events)
            except Exception:
                traceback.print_exc()
            return
        for ev in events:
            try:
                if h.filter is not None and not h.filter(ev.obj):
                    continue
                if ev.type == EventType.ADDED and h.on_add:
                    h.on_add(ev.obj)
                elif ev.type == EventType.MODIFIED and h.on_update:
                    h.on_update(ev.old_obj, ev.obj)
                elif ev.type == EventType.DELETED and h.on_delete:
                    h.on_delete(ev.obj)
            except Exception:
                traceback.print_exc()

    def wait_for_cache_sync(self, timeout: float = 5.0) -> bool:
        return self._synced.wait(timeout)

    def lister(self) -> List[Any]:
        with self._lock:
            return list(self._cache.values())

    def get(self, key: str) -> Optional[Any]:
        """Cache lookup by ``namespace/name`` key (None if absent)."""
        with self._lock:
            return self._cache.get(key)

    def get_many(self, keys: List[str]) -> List[Optional[Any]]:
        """Bulk ``get`` under ONE lock hold."""
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
    """Factory + lifecycle for per-kind informers."""

    def __init__(self, store: ObjectStore):
        self._store = store
        self._informers: Dict[str, Informer] = {}
        self._started = False

    def informer_for(self, kind: str) -> Informer:
        if kind not in self._informers:
            self._informers[kind] = Informer(self._store, kind)
            if self._started:
                # factory already running: the late informer joins live
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
