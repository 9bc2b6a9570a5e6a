"""Lease acquisition and renewal as 409-arbitrated compare-and-swap.

A copy of ``minisched_tpu/ha/lease.py``.  The Lease kind
(``api.objects.Lease``) is just an object; what makes it a LOCK is the
protocol here: every write goes through the store's ``expected_rv``
precondition, so two contenders racing for the same lease resolve exactly
one winner — the loser's PUT lands a Conflict (the apiserver's 409) and
it backs off.  Works identically over the in-process ``ObjectStore`` and
the REST-backed ``RemoteStore``: both raise ``store.Conflict`` on a stale
``expected_rv`` and ``KeyError`` on a create of an existing name, which
is the whole surface this module needs.

Expiry is reader-evaluated wall clock (``renew_time + ttl_s < now``) —
the store never reaps leases, matching the apiserver.  A takeover of an
expired lease is the same CAS: read the stale object, rewrite the holder,
PUT with the read's resource_version; if another survivor got there
first, Conflict.  The replicated plane's store-leader election
(``controlplane/repl.PlaneCoordinator``) rides it on every replica's
arbiter store.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

from minisched_tpu_torch.api.objects import Lease, LeaseSpec, ObjectMeta
from minisched_tpu_torch.controlplane.store import Conflict
from minisched_tpu_torch.observability import counters

KIND_LEASE = "Lease"

#: the namespace HA coordination objects live in (kube parks coordination
#: leases in kube-system; ours get their own so scenario namespaces never
#: collide with the control plane's bookkeeping)
HA_NAMESPACE = "minisched-ha"


class LeaseLost(Exception):
    """A renewal found the lease held by someone else (our TTL ran out
    and a peer took over, or the object vanished).  The holder must stop
    trusting its membership and re-acquire."""


class LeaseManager:
    """Acquire/renew/release TTL'd leases against one store facade."""

    def __init__(
        self,
        client: Any,
        namespace: str = HA_NAMESPACE,
        clock=time.time,
    ):
        self._store = client.store
        self._ns = namespace
        self._clock = clock

    # -- reads --------------------------------------------------------------
    def get(self, name: str) -> Optional[Lease]:
        try:
            return self._store.get(KIND_LEASE, self._ns, name)
        except KeyError:
            return None

    def list(self) -> Tuple[List[Lease], int]:
        """All leases in the coordination namespace + the store rv the
        snapshot reflects (epoch-consistent — see store.list_with_rv)."""
        lw = getattr(self._store, "list_with_rv", None)
        if lw is not None:
            leases, rv = lw(KIND_LEASE)
        else:
            leases, rv = self._store.list(KIND_LEASE), 0
        return [l for l in leases if l.metadata.namespace == self._ns], rv

    # -- CAS writes ---------------------------------------------------------
    def acquire(self, name: str, holder: str, ttl_s: float) -> Optional[Lease]:
        """One acquisition attempt: create the lease, or take over an
        expired (or already-ours) one via ``expected_rv`` CAS.  Returns
        the stored Lease on success, None when a LIVE peer holds it or a
        racing contender won the CAS — the caller retries on its own
        cadence; this method never sleeps."""
        now = self._clock()
        fresh = Lease(
            metadata=ObjectMeta(name=name, namespace=self._ns),
            spec=LeaseSpec(
                holder=holder, ttl_s=float(ttl_s),
                acquire_time=now, renew_time=now,
            ),
        )
        try:
            out = self._store.create(KIND_LEASE, fresh)
            counters.inc("ha.lease_acquire")
            return out
        except KeyError:
            pass  # exists: maybe expired, maybe ours from a past life
        cur = self.get(name)
        if cur is None:
            return None  # deleted between create and get: retry later
        takeover = cur.spec.holder != holder
        if takeover and not cur.expired(now):
            return None  # live peer: no steal
        rv = cur.metadata.resource_version
        cur.spec.holder = holder
        cur.spec.ttl_s = float(ttl_s)
        cur.spec.acquire_time = now
        cur.spec.renew_time = now
        if takeover:
            cur.spec.transitions += 1
        try:
            out = self._store.update(KIND_LEASE, cur, expected_rv=rv)
        except (Conflict, KeyError):
            return None  # 409-arbitrated: another contender won (or gone)
        counters.inc("ha.lease_acquire")
        if takeover:
            counters.inc("ha.lease_takeover")
        return out

    def renew(self, lease: Lease, epoch: Optional[int] = None) -> Lease:
        """Heartbeat: bump ``renew_time`` (and the published epoch) via
        CAS on the lease we last wrote.  A Conflict means someone else
        wrote the object since — almost always a takeover after our TTL
        lapsed; re-read to distinguish:

        * holder is still us (our own earlier PUT whose response was
          lost — the remote client replays transport failures blindly):
          adopt the re-read object and retry the renewal once;
        * holder is a peer (or the lease vanished): raise LeaseLost.
        """
        holder = lease.spec.holder
        for attempt in range(2):
            now = self._clock()
            work = lease.clone()
            work.spec.renew_time = now
            if epoch is not None:
                work.spec.epoch = int(epoch)
            try:
                out = self._store.update(
                    KIND_LEASE, work,
                    expected_rv=lease.metadata.resource_version,
                )
                counters.inc("ha.lease_renew")
                return out
            except (Conflict, KeyError):
                cur = self.get(lease.metadata.name)
                if cur is None or cur.spec.holder != holder:
                    counters.inc("ha.lease_lost")
                    raise LeaseLost(
                        f"lease {lease.metadata.name!r} now held by "
                        f"{cur.spec.holder!r}" if cur is not None
                        else f"lease {lease.metadata.name!r} deleted"
                    )
                lease = cur  # our write, newer rv: retry the CAS once
        counters.inc("ha.lease_lost")
        raise LeaseLost(
            f"lease {lease.metadata.name!r}: renewal kept conflicting"
        )

    def release(self, name: str, holder: str) -> bool:
        """Graceful departure: delete the lease IF we still hold it (a
        racing takeover keeps its steal).  Peers see the DELETED event and
        rebalance immediately instead of waiting out the TTL."""
        cur = self.get(name)
        if cur is None or cur.spec.holder != holder:
            return False
        try:
            self._store.delete(KIND_LEASE, self._ns, name)
        except KeyError:
            return False
        counters.inc("ha.lease_release")
        return True

    def gc_expired(self, grace_factor: float = 10.0) -> int:
        """Delete leases dead for ``grace_factor × ttl`` — long-gone
        members' leases otherwise accrete forever.  Racing survivors both
        trying the delete is fine (the loser's KeyError is ignored); a
        comeback member just re-creates.  Returns how many were reaped."""
        leases, _rv = self.list()
        now = self._clock()
        reaped = 0
        for l in leases:
            if l.spec.renew_time + grace_factor * l.spec.ttl_s < now:
                try:
                    self._store.delete(
                        KIND_LEASE, self._ns, l.metadata.name
                    )
                    reaped += 1
                    counters.inc("ha.lease_gc")
                except KeyError:
                    pass
        return reaped
