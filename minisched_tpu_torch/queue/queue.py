"""The scheduling queue: active / backoff / unschedulable.

A copy of ``minisched_tpu/queue/queue.py``: the three-queue design of
kube-scheduler (activeQ FIFO, backoff heap, unschedulableQ map keyed
name_namespace) with event-driven requeue gated on whether the event can
help the pod's failed plugins, and per-pod exponential backoff (initial
1 s, max 10 s, doubling per attempt).

``pop_batch`` drains a whole wave for the device evaluator, holding the
wave boundary while a requeue burst is still arriving (backoff expiries
due within ``gather_backoff_s``, and same-GVK event storms), and it keeps
every gang's members adjacent and whole within one wave.

``namespace_quota`` is the multi-tenant admission gate: per-namespace
caps on how many pods may be TRACKED by the queue at once (active +
backoff + unschedulable — i.e. pending admission to a wave).  Over-cap
adds park in a per-namespace FIFO and admit as tenants' earlier pods
leave tracking (popped for a wave, or deleted) — bounding any one
tenant's share of every wave without touching pop order for admitted
pods.  Two deliberate carve-outs: REQUEUES (a popped pod failing back
through add_unschedulable, or an engine retry via ``add(requeue=True)``)
always re-admit — holding them would strand an in-flight attempt behind
its own tenant's newer arrivals; and GANG members always admit
(``queue.quota_gang_bypass``) — holding part of a gang would park the
rest at Permit burning the gang TTL.  Opt-in: the default (None) changes
no behavior at all.

The arrival-to-bind histogram (``sched.time_to_bind_s``) and the trace
spans (enqueue, pop, bind_ack) are recorded here.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Set

from minisched_tpu_torch.api.objects import gang_key
from minisched_tpu_torch.observability import counters, hist, trace
from minisched_tpu_torch.framework.events import (
    GVK,
    ClusterEvent,
    ClusterEventMap,
    event_helps_pod,
)
from minisched_tpu_torch.framework.types import PodInfo, QueuedPodInfo

DEFAULT_INITIAL_BACKOFF_S = 1.0  # queue.go:219
DEFAULT_MAX_BACKOFF_S = 10.0  # queue.go:220
DEFAULT_UNSCHEDULABLE_TIMEOUT_S = 60.0  # upstream unschedulableQTimeInterval


class SchedulingQueue:
    def __init__(
        self,
        event_map: Optional[ClusterEventMap] = None,
        initial_backoff_s: float = DEFAULT_INITIAL_BACKOFF_S,
        max_backoff_s: float = DEFAULT_MAX_BACKOFF_S,
        unschedulable_timeout_s: float = DEFAULT_UNSCHEDULABLE_TIMEOUT_S,
        clock: Callable[[], float] = time.monotonic,
        namespace_quota: Optional[Dict[str, int]] = None,
    ):
        self._cond = threading.Condition()
        # per-namespace admission quota (see module docstring).  The map
        # is namespace → cap; "*" is the default cap for namespaces not
        # named.  None (default) disables the gate entirely.
        self._quota_limits: Optional[Dict[str, int]] = (
            dict(namespace_quota) if namespace_quota else None
        )
        self._ns_admitted: Dict[str, int] = {}
        self._quota_held: Dict[str, Deque] = {}  # ns → FIFO of held pods
        self._held_uids: Set[str] = set()
        # while a pop_batch gather is open, EVERY promotion defers here
        # (not just the batch's own pops): a delete_many landing in the
        # gather's cond-wait window would otherwise promote straight
        # into the activeQ the drain loop is consuming — held pods in
        # the very wave whose cap they were held for.  None = no gather
        # open, promotions run inline.  Single-consumer queues make this
        # safe: only pop_batch opens/seals it.
        self._deferred_promos: Optional[List[str]] = None
        self._active: Deque[QueuedPodInfo] = deque()
        # heap of (ready_time, seq, QueuedPodInfo)
        self._backoff: List[tuple] = []
        self._unschedulable: Dict[str, QueuedPodInfo] = {}
        # event-interest index over the unschedulableQ: key → the GVKs whose
        # events could help the pod (from its failed plugins' registered
        # events), and the reverse map an incoming event consults.  Without
        # it every cluster event — including each of the 100k binds a full-
        # scale run produces — scans the whole unschedulableQ
        # (move_all_to_active_or_backoff would be O(events × parked)).
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
        # upstream's schedulingCycle / moveRequestCycle pair: pops stamp
        # the pod with the current cycle; cluster move requests record the
        # cycle they fired in.  A pod whose attempt OVERLAPPED a move
        # request (move >= its stamp) failed against state the event may
        # have changed — it re-queues through backoff instead of parking,
        # closing the event-to-park race that otherwise strands it until
        # the 60s leftover flush (queue.go's unimplemented analog; upstream
        # PriorityQueue.AddUnschedulableIfNotPresent).
        self._scheduling_cycle = 0
        self._move_request_cycle = -1
        # per-event move-request cycles: WHICH event fired at which cycle,
        # so the event-to-park race check can stay event-GATED.  Upstream's
        # single moveRequestCycle routes every concurrently-failing pod
        # through backoff on ANY move request; at wave scale every wave's
        # own binds are a move request, so genuinely-unschedulable pods
        # never park — they replay through backoff for the whole run,
        # doubling their backoff each lap (a 2k-pod replay wave per lap,
        # and seconds of leftover backoff when the helping event finally
        # arrives).  The None key is the conservative wildcard (a move
        # request with no event attached helps everyone).
        self._move_events: Dict[Optional[ClusterEvent], int] = {}
        # event-storm tracking for pop_batch's debounce: the GVK whose
        # event last re-activated parked pods, the wall-clock time of the
        # most recent same-GVK event while the storm lasts, and when the
        # storm OPENED — the gather cap counts from there, not from
        # pop_batch entry (an engine idling in pop() for up to its poll
        # timeout before the storm begins must not have the cap already
        # spent).  (Wall clock on purpose: the debounce interacts with
        # real condition waits, not the injectable backoff clock.)
        self._storm_gvk: Optional[GVK] = None
        self._last_move_walltime = 0.0
        self._storm_open_walltime = 0.0
        # arrival stamps for the live time-to-bind histogram: uid → first
        # admission time.  QUEUE-owned, not QueuedPodInfo-owned, because
        # engine requeues (re-arbitration rejects, expired assume leases,
        # gang-TTL releases) build FRESH QueuedPodInfos — a per-QPI stamp
        # would reset the clock on every retry and flatter the tail.
        # Consumed at bind ack (observe_bind), purged on delete_many
        # (bound-by-peer / removed pods must not pin entries forever).
        self._arrival_ts: Dict[str, float] = {}

    @staticmethod
    def _uid(pod) -> str:
        # objects created outside the store may have no uid yet; fall back
        # to namespace/name identity so distinct pods never collapse
        return pod.metadata.uid or pod.metadata.key

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _key(pod) -> str:
        # keyed name_namespace, queue.go:152-154
        return f"{pod.metadata.name}_{pod.metadata.namespace}"

    def _backoff_duration(self, qpi: QueuedPodInfo) -> float:
        """Exponential per-attempt backoff (queue.go:225-235)."""
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
        heapq.heappush(self._backoff, (self._backoff_ready_time(qpi), self._seq, qpi))
        # wake blocked consumers: their wait deadline is computed from the
        # earliest backoff expiry, which this push may have just moved up
        self._cond.notify_all()

    # -- namespace quota admission (see module docstring) ------------------
    def _quota_limit(self, ns: str) -> Optional[int]:
        if self._quota_limits is None:
            return None
        return self._quota_limits.get(ns, self._quota_limits.get("*"))

    def _track_locked(self, pod) -> None:
        """uid enters queue tracking: count it against its namespace."""
        self._queued_uids.add(self._uid(pod))
        self._stamp_arrival_locked(pod)
        if self._quota_limits is not None:
            ns = pod.metadata.namespace
            self._ns_admitted[ns] = self._ns_admitted.get(ns, 0) + 1

    def _stamp_arrival_locked(self, pod, held: bool = False) -> None:
        """First admission (quota-held arrivals included — their wait in
        the hold FIFO IS part of time-to-bind): stamp the arrival clock
        and record the enqueue trace span.  Idempotent per uid, so
        requeues and promotions never reset the clock."""
        uid = self._uid(pod)
        if uid in self._arrival_ts:
            return
        self._arrival_ts[uid] = self._clock()
        trace.span_pod("enqueue", pod, held=held or None)

    def _untrack_locked(self, pod, promote: bool = True) -> Optional[str]:
        """uid leaves tracking (popped for a wave, or deleted): release
        its namespace's quota slot and promote held arrivals into it.
        ``promote=False`` defers the promotion (callers iterating the
        activeQ must not have it appended to under them) and returns the
        released namespace for a later _promote_held_locked."""
        uid = self._uid(pod)
        if uid not in self._queued_uids:
            return None
        self._queued_uids.discard(uid)
        if self._quota_limits is None:
            return None
        ns = pod.metadata.namespace
        n = self._ns_admitted.get(ns, 0) - 1
        if n > 0:
            self._ns_admitted[ns] = n
        else:
            self._ns_admitted.pop(ns, None)
        if promote:
            self._promote_held_locked(ns)
            return None
        return ns

    def _promote_held_locked(self, ns: str) -> None:
        """FIFO-admit held pods of ``ns`` into freed quota slots."""
        if self._deferred_promos is not None:
            # a pop_batch gather is open: promote at its seal (see
            # _deferred_promos) so no held pod rides the current wave
            self._deferred_promos.append(ns)
            return
        held = self._quota_held.get(ns)
        if not held:
            return
        limit = self._quota_limit(ns)
        promoted = False
        while held and (
            limit is None or self._ns_admitted.get(ns, 0) < limit
        ):
            pod = held.popleft()
            self._held_uids.discard(self._uid(pod))
            self._track_locked(pod)
            if (
                limit is not None
                and self._ns_admitted.get(ns, 0) > limit
            ):
                # can't happen by construction (the loop guard admits
                # strictly under the cap) — a nonzero count here is a
                # quota-accounting BUG, and the churn bench gates on it
                counters.inc("queue.quota_violation")
            self._active.append(QueuedPodInfo(PodInfo(pod)))
            counters.inc("queue.quota_admitted")
            promoted = True
        if not held:
            self._quota_held.pop(ns, None)
        if promoted:
            self._cond.notify_all()

    # -- producer side -----------------------------------------------------
    def _add_locked(self, pod, requeue: bool = False) -> None:
        """Caller holds self._cond and notifies afterwards.  ``requeue``
        marks a pod an ENGINE is putting back (re-arbitration reject,
        expired assume lease, gang-TTL release): it re-admits past any
        quota cap — the hold gates NEW arrivals only (module docstring);
        holding an in-flight retry behind its own tenant's newer
        arrivals could defer it indefinitely while admitted pods pin
        the cap."""
        uid = self._uid(pod)
        if uid in self._queued_uids or uid in self._held_uids:
            return
        if self._quota_limits is not None and not requeue:
            ns = pod.metadata.namespace
            limit = self._quota_limit(ns)
            if limit is not None and self._ns_admitted.get(ns, 0) >= limit:
                if gang_key(pod) is not None:
                    # all-or-nothing gangs never split across the quota
                    # boundary: holding part of one parks the rest at
                    # Permit burning the gang TTL (module docstring)
                    counters.inc("queue.quota_gang_bypass")
                else:
                    self._quota_held.setdefault(ns, deque()).append(pod)
                    self._held_uids.add(uid)
                    self._stamp_arrival_locked(pod, held=True)
                    counters.inc("queue.quota_held")
                    return
            self._track_locked(pod)
            if (
                limit is not None
                and self._ns_admitted.get(ns, 0) > limit
                and gang_key(pod) is None
            ):
                # tripwire, not a code path: a non-gang NEW arrival must
                # never land past the cap (the hold above gates >= limit;
                # only requeues and gang bypass may exceed).  The churn
                # bench gates on this staying zero.
                counters.inc("queue.quota_violation")
            self._active.append(QueuedPodInfo(PodInfo(pod)))
            return
        self._track_locked(pod)
        self._active.append(QueuedPodInfo(PodInfo(pod)))

    def add(self, pod, requeue: bool = False) -> None:
        """New pending pod → activeQ (queue.go:35-43).  ``requeue=True``
        bypasses quota holds (see _add_locked) — engine retry paths pass
        it; informer arrival paths never do."""
        with self._cond:
            self._add_locked(pod, requeue=requeue)
            self._cond.notify_all()

    def add_batch(self, pods) -> None:
        """Batch add under ONE lock hold + one notify — the informer's
        batch dispatch feeds a 100k-pod creation flood through here."""
        with self._cond:
            for pod in pods:
                self._add_locked(pod)
            self._cond.notify_all()

    def _interest_gvks(self, failed_plugins: Set[str]) -> Set[GVK]:
        """Which GVKs' events could help a pod that failed on these plugins
        — the index key mirroring ``event_helps_pod``'s outer loop.  A pod
        with no recorded failures retries on ANY event (upstream), as does
        one whose plugins registered the wildcard resource."""
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
        """Failed pod → unschedulableQ, stamped now (queue.go:95-107) —
        unless a move request that could HELP this pod fired during its
        attempt, in which case it goes through backoff (upstream
        AddUnschedulableIfNotPresent, with the event-gating refinement:
        upstream's single moveRequestCycle would re-queue it on any
        overlapping event, helping or not — see _move_events)."""
        with self._cond:
            uid = self._uid(qpi.pod)
            if uid in self._queued_uids or uid in self._held_uids:
                # upstream's IfNotPresent: the pod is already in some
                # queue segment — a second routing (e.g. a failed scan
                # lane re-parking a chunk loser it already error_func'd)
                # must not insert a duplicate entry that would be popped
                # and scheduled twice.  The held FIFO counts as presence
                # too: tracking a second copy while one sits held would
                # double-count the namespace at promotion and let the
                # pod schedule twice.
                return
            qpi.timestamp = self._clock()
            # requeues re-admit unconditionally (quota counts them; the
            # hold only ever gates NEW arrivals — module docstring)
            self._track_locked(qpi.pod)
            helped = any(
                cycle >= qpi.scheduling_cycle
                and (
                    ev is None
                    or event_helps_pod(
                        ev, qpi.unschedulable_plugins, self._event_map
                    )
                )
                for ev, cycle in self._move_events.items()
            )
            if helped:
                if self._is_backing_off(qpi):
                    self._push_backoff(qpi)
                else:
                    self._push_active(qpi)
                return
            key = self._key(qpi.pod)
            self._unindex_unschedulable(key)  # re-park refreshes interest
            self._unschedulable[key] = qpi
            self._index_unschedulable(key, qpi)

    def update(self, old_pod, new_pod) -> None:
        """Pod object changed while queued — refresh stored pod; if it was
        unschedulable, an update may make it schedulable (upstream moves it
        through backoff gating).  Implements queue.go:109-112's panic."""
        with self._cond:
            uid = self._uid(new_pod)
            if uid in self._held_uids:
                # quota-held arrivals track object refreshes too (they
                # re-enter the active queue with whatever spec is current)
                held = self._quota_held.get(new_pod.metadata.namespace)
                if held is not None:
                    for i, p in enumerate(held):
                        if self._uid(p) == uid:
                            held[i] = new_pod
                            return
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
                    if self._is_backing_off(qpi):
                        self._push_backoff(qpi)
                    else:
                        self._push_active(qpi)

    def delete(self, pod) -> None:
        """Pod removed from the cluster — drop it everywhere
        (queue.go:113-116's panic).  One implementation: delete_many."""
        self.delete_many([pod])

    def observe_bind(self, pod, node_name: Optional[str] = None) -> None:
        """Bind ack: consume the arrival stamp into the live
        ``sched.time_to_bind_s`` histogram (per priority-class label)
        and close the pod's trace chain.  Called by BOTH bind paths —
        the device engine's batch binder and the scalar/Wait-permit
        binding cycle.  A missing stamp (the informer's bind event
        already routed the pod through delete_many, or the pod bound
        before this queue existed) is silently skipped — the histogram
        records latencies, not population."""
        uid = self._uid(pod)
        with self._cond:
            t0 = self._arrival_ts.pop(uid, None)
        if t0 is None:
            return
        dt = max(self._clock() - t0, 0.0)
        prio = getattr(pod.spec, "priority", 0) or 0
        # exemplar: the p99 bucket on /metrics names the slow pod
        hist.observe(
            "sched.time_to_bind_s", dt,
            exemplar=pod.metadata.key, priority=str(prio),
        )
        trace.span_pod("bind_ack", pod, node=node_name, ttb_s=dt)

    def delete_many(self, pods) -> None:
        """Batch delete under ONE lock hold, with a set-intersection fast
        path for pods not queued at all.  The HA event handlers route
        every bound-elsewhere / shard-moved-away MODIFIED through here —
        in a single-engine plane that is EVERY bind event (a wave's
        thousands), and per-event delete() would rescan the queue each
        time to remove nothing."""
        with self._cond:
            all_uids = {self._uid(p) for p in pods}
            # arrival stamps die with the pod — but a departing pod that
            # is BOUND is a bind ack arriving via the EVENT path: the HA
            # handlers route every bind MODIFIED through here, and on
            # the dispatch thread it can beat the binding thread's own
            # observe_bind (the stamp pop is atomic, so exactly one of
            # the two paths records the sample).  Unbound departures
            # (true deletes, bound-elsewhere races that lost the
            # node_name) still just drop — latencies, not population.
            for p in pods:
                t0 = self._arrival_ts.pop(self._uid(p), None)
                if t0 is not None and getattr(p.spec, "node_name", None):
                    dt = max(self._clock() - t0, 0.0)
                    prio = getattr(p.spec, "priority", 0) or 0
                    hist.observe(
                        "sched.time_to_bind_s", dt,
                        exemplar=p.metadata.key, priority=str(prio),
                    )
                    trace.span_pod(
                        "bind_ack", p, node=p.spec.node_name, ttb_s=dt
                    )
            held_hits = all_uids & self._held_uids
            if held_hits:
                # deleted while quota-held: drop from the hold FIFO too
                for ns in {
                    p.metadata.namespace
                    for p in pods
                    if self._uid(p) in held_hits
                }:
                    held = self._quota_held.get(ns)
                    if held is not None:
                        kept = deque(
                            p for p in held if self._uid(p) not in held_hits
                        )
                        if kept:
                            self._quota_held[ns] = kept
                        else:
                            self._quota_held.pop(ns, None)
                self._held_uids -= held_hits
            uids = all_uids & self._queued_uids
            if not uids:
                return
            self._active = deque(
                q for q in self._active if self._uid(q.pod) not in uids
            )
            self._backoff = [
                e for e in self._backoff if self._uid(e[2].pod) not in uids
            ]
            heapq.heapify(self._backoff)
            for pod in pods:
                if self._uid(pod) in uids:
                    key = self._key(pod)
                    if self._unschedulable.pop(key, None) is not None:
                        self._unindex_unschedulable(key)
                    self._untrack_locked(pod)

    # -- event-driven requeue ---------------------------------------------
    def note_move_request(self, event: Optional[ClusterEvent] = None) -> None:
        """Record a cluster state change as a move request WITHOUT a scan:
        pods currently mid-attempt whose failures ``event`` could help will
        re-queue through backoff on failure.  The wave engine calls this
        synchronously after a batch bind (event = Pod/UPDATE, mirroring
        what the dispatch thread will fire when the bind events land) —
        those events arrive later, after the wave's losers may already
        have parked.  ``event=None`` is the conservative wildcard."""
        with self._cond:
            self._move_request_cycle = self._scheduling_cycle
            self._move_events[event] = self._scheduling_cycle

    def move_all_to_active_or_backoff(self, event: ClusterEvent) -> None:
        """queue.go:54-82: on a cluster event, re-activate every
        unschedulable pod the event might help."""
        with self._cond:
            self._move_request_cycle = self._scheduling_cycle
            self._move_events[event] = self._scheduling_cycle
            # the interest index narrows the scan to pods whose failed
            # plugins registered for this event's resource (or wildcard);
            # event_helps_pod then applies the precise action-type match
            candidates = self._unsched_by_gvk.get(event.resource, set()) | (
                self._unsched_by_gvk.get(GVK.WILDCARD, set())
            )
            moved: List[str] = []
            for key in candidates:
                qpi = self._unschedulable.get(key)
                if qpi is not None and event_helps_pod(
                    event, qpi.unschedulable_plugins, self._event_map
                ):
                    moved.append(key)
            for key in moved:
                qpi = self._unschedulable.pop(key)
                self._unindex_unschedulable(key)
                if self._is_backing_off(qpi):
                    self._push_backoff(qpi)
                else:
                    self._push_active(qpi)
            # storm tracking: a move that re-activated pods opens a storm
            # for this GVK; further same-GVK events extend it while it
            # lasts (a burst of node-label updates re-activates everything
            # on the FIRST event — the follow-on events must still hold
            # the wave boundary or it evaluates against half-updated
            # state, fails half the burst, and pays a doubled backoff)
            now_w = time.monotonic()
            if moved:
                if (
                    self._storm_gvk != event.resource
                    or now_w - self._last_move_walltime
                    >= self.STORM_DEBOUNCE_S
                ):
                    self._storm_open_walltime = now_w  # fresh storm
                self._storm_gvk = event.resource
                self._last_move_walltime = now_w
            elif (
                self._storm_gvk == event.resource
                and now_w - self._last_move_walltime < self.STORM_MAX_GATHER_S
            ):
                self._last_move_walltime = now_w

    def assigned_pod_added(self, pod) -> None:
        """A pod got bound somewhere — may unblock pods with (anti)affinity
        on it (queue.go:117-120's panic; upstream moves on AssignedPodAdd)."""
        from minisched_tpu_torch.framework.events import ActionType, GVK

        self.move_all_to_active_or_backoff(ClusterEvent(GVK.POD, ActionType.ADD))

    def assigned_pod_updated(self, pod) -> None:
        from minisched_tpu_torch.framework.events import ActionType, GVK

        self.move_all_to_active_or_backoff(
            ClusterEvent(GVK.POD, ActionType.UPDATE)
        )

    # -- periodic flushes (queue.go:121-146's panics) ----------------------
    def flush_backoff_completed(self) -> None:
        with self._cond:
            now = self._clock()
            while self._backoff and self._backoff[0][0] <= now:
                _, _, qpi = heapq.heappop(self._backoff)
                self._push_active(qpi)

    def flush_unschedulable_leftover(self) -> None:
        with self._cond:
            now = self._clock()
            stale = [
                key
                for key, qpi in self._unschedulable.items()
                if now - qpi.timestamp > self._unschedulable_timeout_s
            ]
            for key in stale:
                qpi = self._unschedulable.pop(key)
                self._unindex_unschedulable(key)
                if self._is_backing_off(qpi):
                    self._push_backoff(qpi)
                else:
                    self._push_active(qpi)

    # -- consumer side -----------------------------------------------------
    def pop(
        self,
        timeout: Optional[float] = None,
        _released: Optional[List[str]] = None,
    ) -> Optional[QueuedPodInfo]:
        """Blocking NextPod (replaces the busy-spin at queue.go:86-91).

        Increments ``attempts`` on the way out, as upstream does when a pod
        leaves the queue for a scheduling attempt.

        ``_released`` (internal, pop_batch): collect the freed quota
        namespace instead of promoting held pods inline — a promotion
        here would land at the activeQ tail and be drained into the SAME
        wave, defeating the per-wave tenant share the quota promises.
        """
        # NOTE: the wait deadline is wall-clock (condition waits are real
        # time) even when a fake clock drives backoff math in tests.
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._active and not self._closed:
                self.flush_backoff_completed_locked()
                if self._active:
                    break  # the flush's own notify predates our wait
                # sleep until the next backoff expiry (event-driven: adds
                # and earlier backoff pushes notify) — no fixed-rate poll
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
            qpi = self._active.popleft()
            qpi.attempts += 1
            self._scheduling_cycle += 1
            qpi.scheduling_cycle = self._scheduling_cycle
            ns = self._untrack_locked(qpi.pod, promote=_released is None)
            if ns is not None and _released is not None:
                _released.append(ns)
            trace.span_pod(
                "pop", qpi.pod,
                attempts=qpi.attempts, cycle=qpi.scheduling_cycle,
            )
            return qpi

    #: pop_batch holds the wave boundary while an event storm that just
    #: re-activated parked pods is still arriving (no same-GVK event for
    #: this long = settled), bounded by the max gather
    STORM_DEBOUNCE_S = 0.2
    STORM_MAX_GATHER_S = 1.0

    def pop_batch(
        self,
        max_pods: int,
        timeout: Optional[float] = None,
        gather_backoff_s: float = 0.35,
    ) -> List[QueuedPodInfo]:
        """Drain up to ``max_pods`` in FIFO order — the wave the TPU batch
        evaluator schedules in one fused kernel call.

        Two bounded waits keep a requeue burst on ONE wave instead of
        trickling through several (each its own full evaluation):

        ``gather_backoff_s``: after draining the activeQ, if the batch has
        room and more pods' backoff expires within this window, wait for
        them and take them too.  Backoff expiry times are unchanged (pods
        never leave early); only the wave boundary waits for them.

        Storm debounce: when a cluster-event burst (say 2k node-label
        updates) re-activates parked pods, the FIRST event moves them all
        — a wave starting right then evaluates against the half-updated
        cluster, fails half the burst, and pays a doubled per-pod backoff
        (queue.go:218-235 semantics) before a second wave.  While same-GVK
        events are still arriving (see move_all_to_active_or_backoff), the
        wave boundary holds until STORM_DEBOUNCE_S passes without one,
        capped at STORM_MAX_GATHER_S.

        Quota promotions are DEFERRED to the end of the batch: every pop
        here frees a quota slot, and an inline promotion would append the
        held pod to the activeQ this very loop is draining — the whole
        hold FIFO would cascade into one wave.  Collecting the freed
        namespaces and promoting once the batch is sealed keeps a
        tenant's share of any single wave at its cap (gang bypass
        aside); the promoted pods lead the NEXT wave."""
        released: List[str] = []
        with self._cond:
            # open the gather: promotions from ANY thread (a delete_many
            # on the dispatch thread included) defer to the seal below —
            # a promotion landing mid-gather would ride this very wave
            self._deferred_promos = []
        try:
            batch = self._pop_batch_gather(
                max_pods, timeout, gather_backoff_s, released
            )
        finally:
            with self._cond:
                pending = self._deferred_promos or []
                self._deferred_promos = None
                for ns in dict.fromkeys(pending + released):
                    self._promote_held_locked(ns)
        if batch:
            _sort_gangs_adjacent(batch)
        return batch

    def _pop_batch_gather(
        self,
        max_pods: int,
        timeout: Optional[float],
        gather_backoff_s: float,
        released: List[str],
    ) -> List[QueuedPodInfo]:
        first = self.pop(timeout, _released=released)
        if first is None:
            return []
        batch = [first]
        t_start = time.monotonic()
        with self._cond:
            while True:
                while self._active and len(batch) < max_pods:
                    qpi = self._active.popleft()
                    qpi.attempts += 1
                    self._scheduling_cycle += 1
                    qpi.scheduling_cycle = self._scheduling_cycle
                    ns = self._untrack_locked(qpi.pod, promote=False)
                    if ns is not None:
                        released.append(ns)
                    trace.span_pod(
                        "pop", qpi.pod,
                        attempts=qpi.attempts, cycle=qpi.scheduling_cycle,
                    )
                    batch.append(qpi)
                if len(batch) >= max_pods:
                    break
                now_w = time.monotonic()
                storm_wait = None
                if self._storm_gvk is not None:
                    since = now_w - self._last_move_walltime
                    opened = max(self._storm_open_walltime, t_start)
                    if (
                        since < self.STORM_DEBOUNCE_S
                        and now_w - opened < self.STORM_MAX_GATHER_S
                    ):
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
                wait = min(
                    w for w in (storm_wait, backoff_wait) if w is not None
                )
                # releases the lock; producers/events can land meanwhile
                self._cond.wait(wait + 0.001)
                self.flush_backoff_completed_locked()
            self._complete_gangs_locked(batch, released)
        # promotions happen at the caller's seal (pop_batch's finally):
        # the admitted pods then lead the NEXT wave
        return batch

    def _complete_gangs_locked(
        self, batch: List[QueuedPodInfo], released: List[str]
    ) -> None:
        """Pull every still-queued member of a gang already in ``batch``
        out of the activeQ and into the batch — even past ``max_pods``:
        one wave must see the WHOLE gang, or its tail waits a full wave
        behind its head with the gang TTL burning (and two interleaved
        gangs would hold partial capacity against each other).  Bounded
        by gang sizes, which are slice-host counts, not wave counts."""
        keys = {gang_key(q.pod) for q in batch}
        keys.discard(None)
        if not keys or not self._active:
            return
        kept: Deque[QueuedPodInfo] = deque()
        for qpi in self._active:
            if gang_key(qpi.pod) in keys:
                qpi.attempts += 1
                self._scheduling_cycle += 1
                qpi.scheduling_cycle = self._scheduling_cycle
                # promotion deferred to pop_batch's seal (and because it
                # would append to the activeQ this loop is iterating)
                ns = self._untrack_locked(qpi.pod, promote=False)
                if ns is not None:
                    released.append(ns)
                batch.append(qpi)
            else:
                kept.append(qpi)
        self._active = kept

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

    # -- introspection (tests / observability) -----------------------------
    def stats(self) -> Dict[str, int]:
        with self._cond:
            out = {
                "active": len(self._active),
                "backoff": len(self._backoff),
                "unschedulable": len(self._unschedulable),
            }
            if self._quota_limits is not None:
                out["quota_held"] = sum(
                    len(d) for d in self._quota_held.values()
                )
            return out

    def quota_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-namespace {admitted, held, limit} under one lock hold —
        the churn bench samples this to audit that no tenant ever
        exceeds its cap (gang bypass aside, which has its own counter)."""
        with self._cond:
            if self._quota_limits is None:
                return {}
            spaces = (
                set(self._ns_admitted)
                | set(self._quota_held)
                | {k for k in self._quota_limits if k != "*"}
            )
            return {
                ns: {
                    "admitted": self._ns_admitted.get(ns, 0),
                    "held": len(self._quota_held.get(ns, ())),
                    "limit": self._quota_limit(ns),
                }
                for ns in spaces
            }

    def pending_unschedulable(self) -> List[QueuedPodInfo]:
        with self._cond:
            return list(self._unschedulable.values())


def _sort_gangs_adjacent(batch: List[QueuedPodInfo]) -> None:
    """Stable in-place reorder: members of one gang become adjacent at
    the gang's FIRST occurrence; singletons and distinct gangs keep
    their relative pop order.  The wave engine then evaluates a gang as
    one contiguous run — its members arbitrate capacity together and
    reach Permit in the same commit pass."""
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
    return old_pod.spec != new_pod.spec or old_pod.metadata.labels != new_pod.metadata.labels
