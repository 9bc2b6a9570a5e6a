"""Coscheduling — all-or-nothing gang admission at Permit.

A copy of ``minisched_tpu/plugins/coscheduling.py``.  Each gang member
that wins a placement already holds an assume lease (the device engine
assumes capacity at placement, before commit) and parks at Permit; the
gang is admitted — every waiting member Allowed, binds commit — only when
ALL ``size`` members hold assumes.  A gang TTL, armed at the FIRST
member's arrival, bounds how long a partial gang may sit on its capacity:
at expiry every waiting member is Rejected with the ``GANG_TTL_REASON``
marker, the engine releases each member's assume and requeues the members
through the ACTIVE queue (``engine/scheduler.py`` ``_binding_cycle``
recognizes the marker) — no stranded partial gangs, and two gangs
deadlocked over overlapping capacity both release within one TTL and
retry (the queue's gang-adjacent pop order then serializes them).

Members already BOUND count toward admission (``gang_lister``, injected
by the engine from its ``GangIndex``): a straggler whose peers landed in
an earlier attempt completes the gang alone instead of waiting for
``size`` fresh arrivals that will never come.

The timers run on their own threads and touch no tensor: admission is
host bookkeeping only.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

from minisched_tpu_torch.api.objects import gang_key
from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import Plugin
from minisched_tpu_torch.framework.types import CycleState, Status
from minisched_tpu_torch.observability import counters

NAME = "Coscheduling"
#: marker carried in the rejection reason — the engine routes these
#: requeues through the activeQ (retry promptly; no cluster event is
#: coming to wake a TTL-released member from the unschedulableQ)
GANG_TTL_REASON = "gang admission TTL expired"


def is_gang_ttl_status(status: Status) -> bool:
    """Did this permit failure come from a gang-TTL release?"""
    return status.plugin == NAME and any(
        GANG_TTL_REASON in r for r in status.reasons
    )


class _GangState:
    __slots__ = ("size", "deadline", "timer", "waiting")

    def __init__(self, size: int, deadline: float):
        self.size = size
        self.deadline = deadline
        self.timer: Optional[threading.Timer] = None
        #: uid → pod, members currently parked at Permit
        self.waiting: Dict[str, Any] = {}


class Coscheduling(Plugin):
    """Permit-only plugin (host-side control flow — nothing to
    vectorize; the device half is the GangTopology scorer)."""

    def __init__(self, time_scale: float = 1.0):
        #: waitingpod Handle — injected by the registry (needs_handle)
        self.h: Any = None
        #: fn(gang_key, exclude_uids) → already-bound member count —
        #: injected by the engine (GangIndex-backed); None counts 0
        self.gang_lister: Any = None
        self.time_scale = time_scale
        self._mu = threading.Lock()
        self._gangs: Dict[str, _GangState] = {}

    def name(self) -> str:
        return NAME

    # -- permit ------------------------------------------------------------
    def permit(
        self, state: CycleState, pod: Any, node_name: str
    ) -> Tuple[Status, float]:
        key = gang_key(pod)
        if key is None:
            return Status.success(), 0.0
        gang = pod.spec.gang
        uid = pod.metadata.uid
        now = time.monotonic()
        with self._mu:
            st = self._gangs.get(key)
            if st is None:
                ttl = max(gang.ttl_s * self.time_scale, 0.01)
                st = self._gangs[key] = _GangState(gang.size, now + ttl)
                t = threading.Timer(ttl, self._expire, args=(key, st))
                t.daemon = True
                st.timer = t
                t.start()
            self._prune_locked(st, keep=uid)
            st.waiting[uid] = pod
            placed = 0
            if self.gang_lister is not None:
                placed = self.gang_lister(key, st.waiting.keys())
            if len(st.waiting) + placed >= st.size:
                # gang complete: admit atomically — cancel the TTL, drop
                # the ledger entry, Allow every parked member.  The
                # current pod's own Allow is buffered by the WaitingPod
                # (_pre_allowed) if its pending entry isn't armed yet;
                # returning Success here resolves it directly instead.
                if st.timer is not None:
                    st.timer.cancel()
                waiting = [u for u in st.waiting if u != uid]
                del self._gangs[key]
                counters.inc("gang.admitted")
                handle = self.h
                for u in waiting:
                    wp = handle.get_waiting_pod(u) if handle else None
                    if wp is not None:
                        wp.allow(NAME)
                return Status.success(), 0.0
            remaining = max(st.deadline - now, 0.01)
        # the member's own WaitingPod timer is a backstop only — the
        # gang timer must always fire first, or a single member's
        # timeout would strand its peers' accounting in the ledger
        return Status.wait(), remaining * 2 + 1.0

    def _prune_locked(self, st: _GangState, keep: str) -> None:
        """Drop waiting uids whose WaitingPod already resolved (rejected
        by another plugin, engine restart) — a stale uid would admit a
        gang whose member can no longer bind."""
        handle = self.h
        if handle is None:
            return
        stale = [
            u
            for u in st.waiting
            if u != keep and handle.get_waiting_pod(u) is None
        ]
        for u in stale:
            del st.waiting[u]

    def _expire(self, key: str, st: _GangState) -> None:
        """Gang TTL fired: release the whole partial gang.  Each Reject
        resolves that member's WaitingPod; the engine's binding cycle
        then unreserves, forgets the assume lease (capacity released)
        and requeues the member via the activeQ (the GANG_TTL_REASON
        marker)."""
        with self._mu:
            if self._gangs.get(key) is not st:
                return  # admitted (or superseded) while the timer fired
            del self._gangs[key]
            waiting = list(st.waiting)
        counters.inc("gang.ttl_expired")
        handle = self.h
        for uid in waiting:
            wp = handle.get_waiting_pod(uid) if handle else None
            if wp is not None:
                wp.reject(
                    NAME,
                    f"{GANG_TTL_REASON} for gang {key} "
                    f"({len(waiting)}/{st.size} members assumed)",
                )

    # -- introspection (tests / bench audits) ------------------------------
    def pending_gangs(self) -> Dict[str, int]:
        """gang key → members currently parked at Permit.  Empty at
        quiesce = zero stranded partial gangs."""
        with self._mu:
            return {k: len(st.waiting) for k, st in self._gangs.items()}

    def events_to_register(self):
        # a TTL-released member failed on its PEERS, not the cluster:
        # the activeQ requeue path retries it without an event, but a
        # member parked by a genuine mid-gang failure wakes on peer binds
        return [ClusterEvent(GVK.POD, ActionType.UPDATE)]
