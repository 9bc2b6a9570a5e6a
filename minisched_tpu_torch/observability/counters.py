"""Process-wide event counters.

A copy of ``minisched_tpu/observability/counters.py``: named integer
counters bumped on rare control paths (assume-lease expiry, gang
admission and TTL release, bind-batch failures), read by tests and bench
audits, and last-write-wins gauges (``set_gauge``), which the Prometheus
exposition (``hist.render_prometheus``) types as ``gauge``.

The remote control plane's names are JAX's (``counters.py:86-114``):

    wire.streams_adopted, wire.streams_active (gauge)
        watch streams handed to the selector stream loop, and those it
        owns now
    wire.evicted_outbuf, wire.partial_writes, wire.keepalives
        streams evicted past the loop's out-buffer bound, sends the
        kernel truncated, idle keepalive chunks
    wire.pool_open, wire.pool_reuse, wire.pool_stale_retry
        keep-alive connections opened, checked out warm, and requests
        replayed once on a fresh connection after a stale reused one
    wire.relist_requests, wire.relist_bytes_shared
        LIST verbs served, and the bytes answered from the read plane's
        list cache
    store.list_cache.encodes, store.list_cache.hits
        list bodies encoded once per snapshot, and the reuses
    watch.fanout.encoded, watch.fanout.shared, watch.fanout.evicted_slow,
    watch.disconnects
        an event's wire bytes encoded once and shared by every stream;
        watchers evicted past the store's queue bound; clients that hung
        up mid-stream
    informer.reconnect, informer.resume, informer.relist_on_410,
    informer.relist_jitter_s, informer.open_retry,
    informer.resume_not_yet_observed
        the informers' reconnect path: reopened watches, of them resumed
        ones, 410s that forced a relist, jitter sleeps taken, failed opens
        retried
    remote.retry, remote.conflict_retry, remote.bind_retry_dedup,
    remote.bind_ack_replayed, remote.not_yet_observed,
    storage.remote_degraded_retry
        the remote store's retries, its mutate re-applies, retried binds
        that had landed, entries answered from the ack registry
    assume.revalidate_on_reconnect
        assumptions whose lease a watch reconnect made due at once
"""

from __future__ import annotations

import threading
from typing import Dict, Set


class Counters:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._gauge_names: Set[str] = set()

    def inc(self, name: str, n: int = 1) -> None:
        with self._mu:
            self._counts[name] = self._counts.get(name, 0) + n

    def set_gauge(self, name: str, n: int) -> None:
        """Last-write-wins value for a state-shaped entry; the name is
        remembered as gauge-typed for the exposition's ``# TYPE``."""
        with self._mu:
            self._counts[name] = n
            self._gauge_names.add(name)

    def gauge_names(self) -> Set[str]:
        with self._mu:
            return set(self._gauge_names)

    def get(self, name: str) -> int:
        with self._mu:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._mu:
            return dict(self._counts)

    def reset(self) -> None:
        with self._mu:
            self._counts.clear()
            self._gauge_names.clear()


GLOBAL = Counters()


def inc(name: str, n: int = 1) -> None:
    GLOBAL.inc(name, n)


def set_gauge(name: str, n: int) -> None:
    GLOBAL.set_gauge(name, n)


def get(name: str) -> int:
    return GLOBAL.get(name)


def snapshot() -> Dict[str, int]:
    return GLOBAL.snapshot()


def reset() -> None:
    GLOBAL.reset()
