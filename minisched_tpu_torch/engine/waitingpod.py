"""Permit "Wait" machinery: pods parked until allowed, rejected, or timed out.

A copy of ``minisched_tpu/engine/waitingpod.py``.

Re-creates ``minisched/waitingpod/waitingpod.go``: a waiting pod holds one
pending entry per permit plugin that returned Wait, each with its own
timeout timer (waitingpod.go:42-49); ``Allow`` by the *last* pending plugin
releases the pod (waitingpod.go:80-99), any ``Reject`` or timer fire fails
it (waitingpod.go:102-115).  The Go buffered-channel signal becomes a
set-once status guarded by a condition variable — same semantics
(late Allow/Reject after resolution is a no-op, matching the non-blocking
channel send at waitingpod.go:93-98,109-114).

Design fix over the reference: the reference's permit plugin can fire
``Allow`` *before* the scheduler registers the WaitingPod (nodenumber.go:112
arms its timer inside ``Permit``, registration happens after it returns,
minisched.go:228-233) — a zero-delay allow is silently lost and the pod
times out.  Here the engine registers the WaitingPod *before* invoking
permit plugins, pending entries are added as each plugin returns Wait, and
an ``allow``/``reject`` arriving before its ``add_pending`` is buffered
(``_pre_allowed``) so nothing is lost.  ``seal()`` marks the end of the
permit phase; resolution to Success requires the pod to be sealed with no
pending plugins.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Protocol, Set

from minisched_tpu_torch.framework.types import Status


class Handle(Protocol):
    """Plugin-facing accessor (waitingpod.go:14-17), implemented by the
    engine's get_waiting_pod (minisched/minisched.go:300-302)."""

    def get_waiting_pod(self, uid: str) -> Optional["WaitingPod"]: ...


class WaitingPod:
    def __init__(self, pod: Any, plugin_timeouts: Optional[Dict[str, float]] = None):
        self.pod = pod
        self._cond = threading.Condition()
        self._pending: Dict[str, threading.Timer] = {}
        self._pre_allowed: Set[str] = set()
        self._sealed = False
        self._result: Optional[Status] = None
        for name, timeout_s in (plugin_timeouts or {}).items():
            self.add_pending(name, timeout_s)
        if plugin_timeouts is not None:
            self.seal()

    def add_pending(self, plugin_name: str, timeout_s: float) -> None:
        """Arm a pending entry + timeout timer for one permit plugin
        (waitingpod.go:42-49)."""
        with self._cond:
            if self._result is not None:
                return
            if plugin_name in self._pre_allowed:
                self._pre_allowed.discard(plugin_name)
                self._maybe_resolve_locked()
                return
            t = threading.Timer(
                timeout_s,
                self.reject,
                args=(plugin_name, f"timed out waiting on permit plugin {plugin_name}"),
            )
            t.daemon = True
            self._pending[plugin_name] = t
            t.start()

    def seal(self) -> None:
        """All permit plugins have been consulted; Success becomes possible."""
        with self._cond:
            self._sealed = True
            self._maybe_resolve_locked()

    def pending_plugins(self) -> list:
        with self._cond:
            return list(self._pending)

    def get_signal(self, timeout: Optional[float] = None) -> Status:
        """Block until resolution (waitingpod.go:61-63)."""
        with self._cond:
            if self._result is None:
                self._cond.wait(timeout)
            if self._result is None:
                return Status.error("waiting pod signal wait timed out")
            return self._result

    def allow(self, plugin_name: str) -> None:
        """waitingpod.go:80-99: drop the plugin's pending entry; when the
        last one clears (and the permit phase is sealed), resolve Success.
        An allow arriving before the entry exists is buffered."""
        with self._cond:
            if self._result is not None:
                return
            timer = self._pending.pop(plugin_name, None)
            if timer is not None:
                timer.cancel()
            else:
                self._pre_allowed.add(plugin_name)
            self._maybe_resolve_locked()

    def reject(self, plugin_name: str, msg: str) -> None:
        """waitingpod.go:102-115: any reject resolves Unschedulable."""
        with self._cond:
            for t in self._pending.values():
                t.cancel()
            self._pending.clear()
            if self._result is not None:
                return
            self._result = Status.unschedulable(
                f"pod {self.pod.metadata.name} rejected while waiting on permit: {msg}"
            ).with_plugin(plugin_name)
            self._cond.notify_all()

    def _maybe_resolve_locked(self) -> None:
        if self._sealed and not self._pending and self._result is None:
            self._result = Status.success()
            self._cond.notify_all()
