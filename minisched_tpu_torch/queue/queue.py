"""The scheduling queue: active / backoff / unschedulable.

A copy of ``minisched_tpu/queue/queue.py`` (``:65-900``): the three-queue
design of kube-scheduler (activeQ FIFO, backoff heap, unschedulableQ map
keyed name_namespace) with event-driven requeue gated on whether the
event can help the pod's failed plugins, and per-pod exponential backoff
(initial 1 s, max 10 s, doubling per attempt).

``pop_batch`` drains a whole wave for the device evaluator, holding the
wave boundary while a requeue burst is still arriving (backoff expiries
due within ``gather_backoff_s``, and same-GVK event storms), and it keeps
every gang's members adjacent and whole within one wave.

Left out: the per-namespace admission quota (``namespace_quota``, off by
default in the JAX queue) and the trace spans.  The arrival-to-bind
histogram (``sched.time_to_bind_s``) is kept: it is the time from
pending to bind that users of a scheduler pay for.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Set

from minisched_tpu_torch.api.objects import gang_key
from minisched_tpu_torch.framework.events import (
    GVK,
    ClusterEvent,
    ClusterEventMap,
    event_helps_pod,
)
from minisched_tpu_torch.framework.types import PodInfo, QueuedPodInfo
from minisched_tpu_torch.observability import hist

DEFAULT_INITIAL_BACKOFF_S = 1.0
DEFAULT_MAX_BACKOFF_S = 10.0
DEFAULT_UNSCHEDULABLE_TIMEOUT_S = 60.0  # upstream unschedulableQTimeInterval


class SchedulingQueue:
    def __init__(
        self,
        event_map: Optional[ClusterEventMap] = None,
        initial_backoff_s: float = DEFAULT_INITIAL_BACKOFF_S,
        max_backoff_s: float = DEFAULT_MAX_BACKOFF_S,
        unschedulable_timeout_s: float = DEFAULT_UNSCHEDULABLE_TIMEOUT_S,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._cond = threading.Condition()
        self._active: Deque[QueuedPodInfo] = deque()
        # heap of (ready_time, seq, QueuedPodInfo)
        self._backoff: List[tuple] = []
        self._unschedulable: Dict[str, QueuedPodInfo] = {}
        # event-interest index over the unschedulableQ: key → the GVKs
        # whose events could help the pod, and the reverse map an incoming
        # event consults (a full scan per event would be O(events × parked))
        self._unsched_gvks: Dict[str, Set[GVK]] = {}
        self._unsched_by_gvk: Dict[GVK, Set[str]] = {}
        self._event_map: ClusterEventMap = event_map or {}
        self._initial_backoff_s = initial_backoff_s
        self._max_backoff_s = max_backoff_s
        self._unschedulable_timeout_s = unschedulable_timeout_s
        self._clock = clock
        self._seq = 0
        self._closed = False
        # identity keys currently tracked, to drop duplicate adds
        self._queued_uids: Set[str] = set()
        # upstream's schedulingCycle / moveRequestCycle pair, per event:
        # a pod whose attempt overlapped a move request that could help
        # it re-queues through backoff instead of parking (the
        # event-to-park race)
        self._scheduling_cycle = 0
        self._move_request_cycle = -1
        self._move_events: Dict[Optional[ClusterEvent], int] = {}
        # event-storm tracking for pop_batch's debounce (wall clock: it
        # interacts with real condition waits, not the backoff clock)
        self._storm_gvk: Optional[GVK] = None
        self._last_move_walltime = 0.0
        self._storm_open_walltime = 0.0
        # uid → first admission time, for the time-to-bind histogram;
        # queue-owned so a requeue never resets a pod's clock
        self._arrival_ts: Dict[str, float] = {}

    @staticmethod
    def _uid(pod) -> str:
        # objects created outside the store may have no uid yet; fall back
        # to namespace/name identity so distinct pods never collapse
        return pod.metadata.uid or pod.metadata.key

    @staticmethod
    def _key(pod) -> str:
        return f"{pod.metadata.name}_{pod.metadata.namespace}"

    def _backoff_duration(self, qpi: QueuedPodInfo) -> float:
        duration = self._initial_backoff_s
        for _ in range(max(qpi.attempts - 1, 0)):
            duration *= 2
            if duration >= self._max_backoff_s:
                return self._max_backoff_s
        return duration

    def _backoff_ready_time(self, qpi: QueuedPodInfo) -> float:
        return qpi.timestamp + self._backoff_duration(qpi)

    def _is_backing_off(self, qpi: QueuedPodInfo) -> bool:
        return self._backoff_ready_time(qpi) > self._clock()

    def _push_active(self, qpi: QueuedPodInfo) -> None:
        self._active.append(qpi)
        self._cond.notify_all()

    def _push_backoff(self, qpi: QueuedPodInfo) -> None:
        self._seq += 1
        heapq.heappush(self._backoff,
                       (self._backoff_ready_time(qpi), self._seq, qpi))
        # wake blocked consumers: their wait deadline may have moved up
        self._cond.notify_all()

    def _push_active_or_backoff(self, qpi: QueuedPodInfo) -> None:
        if self._is_backing_off(qpi):
            self._push_backoff(qpi)
        else:
            self._push_active(qpi)

    def _track_locked(self, pod) -> None:
        uid = self._uid(pod)
        self._queued_uids.add(uid)
        self._arrival_ts.setdefault(uid, self._clock())

    # -- producer side -----------------------------------------------------
    def _add_locked(self, pod) -> None:
        if self._uid(pod) in self._queued_uids:
            return
        self._track_locked(pod)
        self._active.append(QueuedPodInfo(PodInfo(pod)))

    def add(self, pod, requeue: bool = False) -> None:
        """New pending pod → activeQ.  ``requeue`` marks an engine retry
        (it matters only to the JAX queue's admission quota)."""
        with self._cond:
            self._add_locked(pod)
            self._cond.notify_all()

    def add_batch(self, pods) -> None:
        """Batch add under ONE lock hold + one notify."""
        with self._cond:
            for pod in pods:
                self._add_locked(pod)
            self._cond.notify_all()

    def _interest_gvks(self, failed_plugins: Set[str]) -> Set[GVK]:
        """Which GVKs' events could help a pod that failed on these
        plugins.  A pod with no recorded failures retries on ANY event."""
        if not failed_plugins:
            return {GVK.WILDCARD}
        out: Set[GVK] = set()
        for registered, plugin_names in self._event_map.items():
            if plugin_names & failed_plugins:
                out.add(registered.resource)
        return out

    def _index_unschedulable(self, key: str, qpi: QueuedPodInfo) -> None:
        gvks = self._interest_gvks(qpi.unschedulable_plugins)
        self._unsched_gvks[key] = gvks
        for gvk in gvks:
            self._unsched_by_gvk.setdefault(gvk, set()).add(key)

    def _unindex_unschedulable(self, key: str) -> None:
        for gvk in self._unsched_gvks.pop(key, ()):
            bucket = self._unsched_by_gvk.get(gvk)
            if bucket is not None:
                bucket.discard(key)

    def add_unschedulable(self, qpi: QueuedPodInfo) -> None:
        """Failed pod → unschedulableQ, stamped now — unless a move request
        that could HELP this pod fired during its attempt, in which case
        it goes through backoff."""
        with self._cond:
            if self._uid(qpi.pod) in self._queued_uids:
                # already in some queue segment: never a duplicate entry
                return
            qpi.timestamp = self._clock()
            self._track_locked(qpi.pod)
            helped = any(
                cycle >= qpi.scheduling_cycle
                and (ev is None or event_helps_pod(
                    ev, qpi.unschedulable_plugins, self._event_map))
                for ev, cycle in self._move_events.items()
            )
            if helped:
                self._push_active_or_backoff(qpi)
                return
            key = self._key(qpi.pod)
            self._unindex_unschedulable(key)  # re-park refreshes interest
            self._unschedulable[key] = qpi
            self._index_unschedulable(key, qpi)

    def update(self, old_pod, new_pod) -> None:
        """Pod object changed while queued: refresh the stored pod; an
        unschedulable pod whose spec or labels changed moves on."""
        with self._cond:
            uid = self._uid(new_pod)
            for qpi in self._active:
                if self._uid(qpi.pod) == uid:
                    qpi.pod_info.pod = new_pod
                    return
            for _, _, qpi in self._backoff:
                if self._uid(qpi.pod) == uid:
                    qpi.pod_info.pod = new_pod
                    return
            key = self._key(new_pod)
            qpi = self._unschedulable.get(key)
            if qpi is not None:
                qpi.pod_info.pod = new_pod
                if _spec_changed(old_pod, new_pod):
                    del self._unschedulable[key]
                    self._unindex_unschedulable(key)
                    self._push_active_or_backoff(qpi)

    def delete(self, pod) -> None:
        self.delete_many([pod])

    def _observe_ttb(self, pod, t0: float) -> None:
        hist.observe("sched.time_to_bind_s", max(self._clock() - t0, 0.0),
                     exemplar=pod.metadata.key,
                     priority=str(getattr(pod.spec, "priority", 0) or 0))

    def observe_bind(self, pod, node_name: Optional[str] = None) -> None:
        """Bind ack: consume the arrival stamp into the time-to-bind
        histogram (per priority class).  A missing stamp (the bind event
        already consumed it through delete_many) is skipped."""
        with self._cond:
            t0 = self._arrival_ts.pop(self._uid(pod), None)
        if t0 is not None:
            self._observe_ttb(pod, t0)

    def delete_many(self, pods) -> None:
        """Batch delete under ONE lock hold.  The engine's event handlers
        route every bind MODIFIED through here, so a departing pod that is
        BOUND is also a bind ack: whichever of this and ``observe_bind``
        pops its arrival stamp records the sample."""
        with self._cond:
            all_uids = {self._uid(p) for p in pods}
            for p in pods:
                t0 = self._arrival_ts.pop(self._uid(p), None)
                if t0 is not None and getattr(p.spec, "node_name", None):
                    self._observe_ttb(p, t0)
            uids = all_uids & self._queued_uids
            if not uids:
                return
            self._active = deque(
                q for q in self._active if self._uid(q.pod) not in uids)
            self._backoff = [
                e for e in self._backoff if self._uid(e[2].pod) not in uids]
            heapq.heapify(self._backoff)
            for pod in pods:
                if self._uid(pod) in uids:
                    key = self._key(pod)
                    if self._unschedulable.pop(key, None) is not None:
                        self._unindex_unschedulable(key)
                    self._queued_uids.discard(self._uid(pod))

    # -- event-driven requeue ---------------------------------------------
    def note_move_request(self, event: Optional[ClusterEvent] = None) -> None:
        """Record a cluster state change as a move request WITHOUT a scan:
        pods mid-attempt whose failures ``event`` could help re-queue
        through backoff on failure.  ``None`` is the wildcard."""
        with self._cond:
            self._move_request_cycle = self._scheduling_cycle
            self._move_events[event] = self._scheduling_cycle

    def move_all_to_active_or_backoff(self, event: ClusterEvent) -> None:
        """On a cluster event, re-activate every unschedulable pod the
        event might help."""
        with self._cond:
            self._move_request_cycle = self._scheduling_cycle
            self._move_events[event] = self._scheduling_cycle
            candidates = self._unsched_by_gvk.get(event.resource, set()) | (
                self._unsched_by_gvk.get(GVK.WILDCARD, set()))
            moved: List[str] = []
            for key in candidates:
                qpi = self._unschedulable.get(key)
                if qpi is not None and event_helps_pod(
                        event, qpi.unschedulable_plugins, self._event_map):
                    moved.append(key)
            for key in moved:
                qpi = self._unschedulable.pop(key)
                self._unindex_unschedulable(key)
                self._push_active_or_backoff(qpi)
            # storm tracking: a move that re-activated pods opens a storm
            # for this GVK; further same-GVK events extend it
            now_w = time.monotonic()
            if moved:
                if (self._storm_gvk != event.resource
                        or now_w - self._last_move_walltime
                        >= self.STORM_DEBOUNCE_S):
                    self._storm_open_walltime = now_w  # fresh storm
                self._storm_gvk = event.resource
                self._last_move_walltime = now_w
            elif (self._storm_gvk == event.resource
                  and now_w - self._last_move_walltime
                  < self.STORM_MAX_GATHER_S):
                self._last_move_walltime = now_w

    # -- periodic flushes --------------------------------------------------
    def flush_backoff_completed(self) -> None:
        with self._cond:
            self.flush_backoff_completed_locked()

    def flush_unschedulable_leftover(self) -> None:
        with self._cond:
            now = self._clock()
            stale = [key for key, qpi in self._unschedulable.items()
                     if now - qpi.timestamp > self._unschedulable_timeout_s]
            for key in stale:
                qpi = self._unschedulable.pop(key)
                self._unindex_unschedulable(key)
                self._push_active_or_backoff(qpi)

    # -- consumer side -----------------------------------------------------
    def _pop_locked(self) -> QueuedPodInfo:
        """Take the activeQ head for an attempt (caller holds the lock and
        checked it is not empty)."""
        qpi = self._active.popleft()
        qpi.attempts += 1
        self._scheduling_cycle += 1
        qpi.scheduling_cycle = self._scheduling_cycle
        self._queued_uids.discard(self._uid(qpi.pod))
        return qpi

    def pop(self, timeout: Optional[float] = None) -> Optional[QueuedPodInfo]:
        """Blocking NextPod: waits on a condition variable (adds, earlier
        backoff expiries and close notify it).  Increments ``attempts`` on
        the way out."""
        # the wait deadline is wall clock even under a fake backoff clock
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._active and not self._closed:
                self.flush_backoff_completed_locked()
                if self._active:
                    break
                wait = None
                if self._backoff:
                    wait = max(self._backoff[0][0] - self._clock(), 0.0)
                    if self._clock is not time.monotonic:
                        # fake clocks advance out-of-band; stay responsive
                        wait = min(wait, 0.05)
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None else min(wait, remaining)
                self._cond.wait(wait)
            if not self._active:
                return None
            return self._pop_locked()

    #: pop_batch holds the wave boundary while an event storm that just
    #: re-activated parked pods is still arriving (no same-GVK event for
    #: this long = settled), bounded by the max gather
    STORM_DEBOUNCE_S = 0.2
    STORM_MAX_GATHER_S = 1.0

    def pop_batch(self, max_pods: int, timeout: Optional[float] = None,
                  gather_backoff_s: float = 0.35) -> List[QueuedPodInfo]:
        """Drain up to ``max_pods`` in FIFO order — one wave.

        Two bounded waits keep a requeue burst on ONE wave: pods whose
        backoff expires within ``gather_backoff_s`` are waited for, and
        while same-GVK events that re-activated parked pods are still
        arriving the boundary holds until ``STORM_DEBOUNCE_S`` passes
        without one (at most ``STORM_MAX_GATHER_S``).  Every still-queued
        member of a gang in the batch joins it, even past ``max_pods``,
        and gang members end adjacent."""
        first = self.pop(timeout)
        if first is None:
            return []
        batch = [first]
        t_start = time.monotonic()
        with self._cond:
            while True:
                while self._active and len(batch) < max_pods:
                    batch.append(self._pop_locked())
                if len(batch) >= max_pods:
                    break
                now_w = time.monotonic()
                storm_wait = None
                if self._storm_gvk is not None:
                    since = now_w - self._last_move_walltime
                    opened = max(self._storm_open_walltime, t_start)
                    if (since < self.STORM_DEBOUNCE_S
                            and now_w - opened < self.STORM_MAX_GATHER_S):
                        storm_wait = self.STORM_DEBOUNCE_S - since
                    else:
                        self._storm_gvk = None  # settled (or cap hit)
                backoff_wait = None
                if self._backoff:
                    w = self._backoff[0][0] - self._clock()
                    if w <= gather_backoff_s:
                        backoff_wait = max(w, 0.0)
                if storm_wait is None and backoff_wait is None:
                    break
                wait = min(w for w in (storm_wait, backoff_wait)
                           if w is not None)
                self._cond.wait(wait + 0.001)
                self.flush_backoff_completed_locked()
            self._complete_gangs_locked(batch)
        _sort_gangs_adjacent(batch)
        return batch

    def _complete_gangs_locked(self, batch: List[QueuedPodInfo]) -> None:
        """Pull every still-queued member of a gang already in ``batch``
        out of the activeQ and into the batch, even past the wave size:
        one wave must see the WHOLE gang, or its tail waits a wave behind
        its head with the gang TTL burning."""
        keys = {gang_key(q.pod) for q in batch}
        keys.discard(None)
        if not keys or not self._active:
            return
        kept: Deque[QueuedPodInfo] = deque()
        taken: List[QueuedPodInfo] = []
        for qpi in self._active:
            (taken if gang_key(qpi.pod) in keys else kept).append(qpi)
        self._active = kept
        for qpi in taken:
            qpi.attempts += 1
            self._scheduling_cycle += 1
            qpi.scheduling_cycle = self._scheduling_cycle
            self._queued_uids.discard(self._uid(qpi.pod))
            batch.append(qpi)

    def flush_backoff_completed_locked(self) -> None:
        # caller holds self._cond
        now = self._clock()
        while self._backoff and self._backoff[0][0] <= now:
            _, _, qpi = heapq.heappop(self._backoff)
            self._push_active(qpi)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._cond:
            return {
                "active": len(self._active),
                "backoff": len(self._backoff),
                "unschedulable": len(self._unschedulable),
            }


def _sort_gangs_adjacent(batch: List[QueuedPodInfo]) -> None:
    """Stable in-place reorder: members of one gang become adjacent at the
    gang's FIRST occurrence; singletons and distinct gangs keep their
    relative pop order."""
    first: Dict[str, int] = {}
    keyed = []
    for i, qpi in enumerate(batch):
        k = gang_key(qpi.pod)
        slot = i if k is None else first.setdefault(k, i)
        keyed.append((slot, i, qpi))
    keyed.sort(key=lambda e: (e[0], e[1]))
    batch[:] = [qpi for _, _, qpi in keyed]


def _spec_changed(old_pod, new_pod) -> bool:
    if old_pod is None:
        return True
    return (old_pod.spec != new_pod.spec
            or old_pod.metadata.labels != new_pod.metadata.labels)
