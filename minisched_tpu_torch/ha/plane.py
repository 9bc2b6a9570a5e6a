"""Wire one scheduler engine into the HA plane.

A copy of ``minisched_tpu/ha/plane.py``.  ``start_ha_engine`` composes
the pieces: join the membership (lease CAS), start a
``SchedulerService`` whose engine carries the membership's shard filter
(threaded through the event handlers' queue admission), attach the
membership to the factory's Lease informer, and register the **resync**
callback that runs on every epoch bump:

* adopt: every pending pod the new shard map gives us is queued from the
  informer cache (``queue.add(requeue=True)`` dedupes, so a pod already
  queued costs a set lookup, and an adopted pod is not held behind its
  tenant's quota a second time);
* shed: pending pods the map took away leave our queue
  (``queue.delete_many``; the new owner admits them from its own cache);
* re-arbitrate: on a lost member, the device engine's assume ledger is
  made due at once (``_revalidate_assume_ledger``), because the
  rebalance window is when two engines can race a bind and the loser
  must release its assumed capacity promptly, not at the lease TTL.

Unlike JAX's, whose engines default to the scalar loop, the port's
``start_ha_engine`` runs the device engine (``device_mode=True``) on
``device`` (None: the card, as ``start_scheduler``; the tests pass
``"cpu"``), and ``device_mesh`` (JAX ``:71-97``) shards each wave of
that engine over its mesh: the membership splits the pods between
engines, a mesh splits one engine's wave across its devices.  The port's
membership also
heartbeats from the moment it joins, where JAX's starts once the engine
runs: an engine's start (informer sync, a CUDA context) can outlast the
TTL, and its lease would lapse before its first renewal.  A resync after
a lost member stamps the gauge ``ha.shard_adopt_unix_ms`` once the
orphaned pods are queued, the adoption a kill's observer reads.

Several HA engines run against one control plane in process (N
``start_ha_engine`` calls over clients sharing a store: the ``ha`` bench
role) or over the wire (each engine a ``RemoteClient`` of the REST
façade; ``ha/proc.py`` runs them as killable child processes).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Set, Tuple

from minisched_tpu_torch.ha.membership import DEFAULT_TTL_S, Membership
from minisched_tpu_torch.observability import counters
from minisched_tpu_torch.service.service import SchedulerService


class HAEngine:
    """One engine and its membership, joined to the plane."""

    def __init__(self, service: SchedulerService, scheduler: Any,
                 membership: Membership):
        self.service = service
        self.scheduler = scheduler
        self.membership = membership

    def stop(self) -> None:
        """Graceful departure: stop scheduling, then release the lease so
        peers adopt our shard at once instead of waiting out the TTL."""
        self.membership.stop(release=True)
        self.service.close()

    def kill(self) -> None:
        """In-process crash: the engine stops but the lease is abandoned;
        peers must detect the death by TTL expiry, as with a SIGKILLed
        process (which ``ha/proc.py`` provides for real)."""
        self.membership.stop(release=False)
        self.service.close()


def start_ha_engine(client: Any, engine_id: str, cfg: Any = None,
                    ttl_s: float = DEFAULT_TTL_S, device_mode: bool = True,
                    max_wave: int = 1024, device: Any = None,
                    device_mesh: Any = None,
                    **start_kwargs: Any) -> HAEngine:
    """Join the plane and start one sharded engine over ``client``.

    Order matters: the lease is acquired before the engine starts (so the
    first shard map includes us: an engine scheduling before it joined
    would admit everything), and the shard filter is installed before the
    informers start (so the first snapshot replay is already filtered).
    ``start_kwargs`` go to ``SchedulerService.start_scheduler``."""
    membership = Membership(client, engine_id, ttl_s=ttl_s)
    membership.join()
    membership.start()  # the port's: renew while the engine starts
    service = SchedulerService(client)
    try:
        sched = service.start_scheduler(
            cfg, device_mode=device_mode, max_wave=max_wave, device=device,
            shard_filter=membership.owns_pod, device_mesh=device_mesh,
            **start_kwargs)
    except BaseException:
        membership.stop(release=True)
        raise
    membership.attach(service.informer_factory)

    pod_informer = service.informer_factory.informer_for("Pod")
    resync_mu = threading.Lock()

    def resync(epoch: int, members: Tuple[str, ...], joined: Set[str],
               lost: Set[str]) -> None:
        """Apply a new shard map to the queue (on the membership's view
        thread, or here at the start; one at a time, each with the view
        current when it runs; host objects only)."""
        with resync_mu:
            _resync(lost)

    def _resync(lost: Set[str]) -> None:
        adopted = 0
        shed = []
        for pod in pod_informer.lister():
            if pod.spec.node_name:
                continue  # bound: no one's schedulable work
            if membership.owns_pod(pod):
                sched.queue.add(pod, requeue=True)
                adopted += 1
            else:
                shed.append(pod)
        if shed:
            sched.queue.delete_many(shed)
        if lost:
            counters.inc("ha.shard_adopt")
            counters.inc("ha.shard_adopt_pods", adopted)
            counters.set_gauge("ha.shard_adopt_unix_ms",
                               int(time.time() * 1000))
            # a lost member may have died with binds in flight: re-check
            # every assumption against the store now
            revalidate = getattr(sched, "_revalidate_assume_ledger", None)
            if revalidate is not None:
                try:
                    revalidate()
                except Exception:
                    traceback.print_exc()

    membership.on_change.append(resync)
    # the engine may have started mid-churn (peers joining while our
    # informers synced): apply the current map once, unconditionally
    resync(membership.epoch, membership.members(), set(), set())
    return HAEngine(service, sched, membership)
