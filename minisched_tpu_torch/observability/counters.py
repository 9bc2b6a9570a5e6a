"""Process-wide event counters.

A copy of ``minisched_tpu/observability/counters.py``: named integer
counters bumped on rare control paths (assume-lease expiry, gang
admission and TTL release, bind-batch failures), read by tests and bench
audits, and last-write-wins gauges (``set_gauge``), which the Prometheus
exposition (``hist.render_prometheus``) types as ``gauge``.

The mesh engine's names are JAX's (``counters.py:135-149``): the
device engine over a ``parallel.sharding.Mesh`` records under
``wave_mesh.``:

    wave_mesh.pod_shards, wave_mesh.node_shards (gauges)
        the factoring the engine took at construction (2 × 4 on eight
        devices)
    wave_mesh.waves
        waves evaluated over the mesh (a mesh engine whose count stays 0
        runs degraded)
    wave_mesh.fallbacks
        waves evaluated again on one device after the sharded evaluation
        raised (the per-wave ladder; later waves retry the mesh)
    wave_mesh.pad_pod_rows, wave_mesh.pad_node_rows
        table rows shipped beyond the live wave and roster (the capacity
        a mesh axis rounds up to)

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
        assumptions whose lease a watch reconnect (or a lost HA member)
        made due at once
    assume.lease_renewed_unreachable, assume.lease_probe_deferred
        leases re-armed unprobed because the store did not answer a
        probe, and expired leases left for the next round past the
        round's probe budget
    engine.bind_batch_failed
        whole bind transactions that failed (an injected ``engine.bind``
        among them); every pod of the batch requeued
    engine.pods_bound
        the port's: pods the device engine's wave binds committed (an HA
        engine child's share of the binds)

The HA plane's (``ha/``; JAX ``counters.py:14-26``), surfaced in the
``ha`` role's record and phase 34's line:

    ha.lease_acquire, ha.lease_takeover, ha.lease_renew
        member (and coordination) leases won, expired ones taken over,
        heartbeats
    ha.lease_lost, ha.lease_expired, ha.lease_release, ha.lease_gc
        renewals that found the lease gone, members lost by TTL expiry,
        graceful releases, long-dead leases collected
    ha.member_join, ha.member_lost, ha.epoch_bump
        joins, members dropped from a view, and view changes
    ha.shard_adopt, ha.shard_adopt_pods
        resyncs after a lost member, and the pending pods they queued
    ha.expiry_unconfirmed
        the port's: members whose lease read expired in the Lease
        informer's cache and live in the store, so kept in the view
    ha.renew_gap_max_ms
        the port's gauge: the widest gap (ms) between the starts of two
        successive renewals of this member's lease
    ha.shard_adopt_unix_ms
        the port's gauge: the wall clock (ms) at which the last resync
        after a lost member had queued its pods

The sharded write plane's (``controlplane/shards.py``; JAX
``counters.py:408-500``): the router's under ``shard.``, the façade's
and store's under ``storage.shard.``:

    shard.topology_refreshes, shard.wrong_shard_chased
        router re-fetches of ``/shards/status`` (each adopts the highest
        epoch seen), and writes re-dispatched after a 421 WrongShard
    shard.cross_bind_batches, shard.cross_bind_entries
        bind batches that spanned more than one leader group (the
        two-shard commit), and the bindings in them
    shard.watch_reopen, shard.events_suppressed
        merged-watch component streams reopened at their own cursor, and
        live events dropped because their group does not own their
        namespace (the cursor still advances)
    shard.watch.held, shard.watch.moves, shard.watch.aborts
        the port's: merged-watch groups held from a split's first seed
        event, and the holds released on the topology flip or dropped
        with the seed's copies when the split aborted
    shard.splits, shard.endpoint_discoveries
        splits completed (freeze, handoff, seed, renewal, flip, thaw,
        purge), and follower urls the router learned from /repl/status
    storage.shard.wrong_shard_refused, storage.shard.frozen_refused
        the façade's refusals: 421 for a namespace another group owns,
        503 for one inside a split's freeze
    storage.shard.topology_updates, storage.shard.freezes,
    storage.shard.freeze_expired
        topology epochs adopted over /shards/control, freezes imposed
        there, and freeze leases auto-thawed at their TTL
    storage.shard.handoff_ships, storage.shard.handoff_objects,
    storage.shard.seed_objects, storage.shard.purged_objects,
    storage.shard.purge_skipped
        handoff documents served and their objects, objects seeded on
        the target, deleted from the source after the flip, and left
        there because the handoff manifest did not name them
    remote.shard_frozen_retry, remote.shard_frozen_timeout
        remote requests that waited out a 503 shard frozen, and waits
        that outlived ``frozen_deadline_s`` (ShardFrozenTimeout)
    shard.budget.mirror_syncs, shard.budget.reports
        budget documents a non-home group's mirror adopted, and usage
        reports the home group's board folded in (rv-monotonic each)
    shard.budget.mirror_checks, shard.budget.unknown_node,
    shard.budget.refused, sched.bind_mirror_refusals
        bind budgets answered from the mirror, those it could not answer
        (no check), binds refused on its verdict (the OutOfCapacity names
        ``budget-mirror rv=``), and the engine's binds so refused
    shard.autosplit.samples, shard.autosplit.hot,
    shard.autosplit.triggered, shard.autosplit.skipped,
    shard.autosplit.errors
        the load watcher's ticks, hot ticks, splits it started, hot
        ticks it let pass (cooldown, fenced, no candidate) and failed
        splits
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
