"""HA scheduling plane: lease-based membership and sharded active-active
engines.

A copy of ``minisched_tpu/ha/__init__.py``.  N engines register TTL'd
member **Leases** (``api.objects.Lease``, renewed through
``expected_rv`` CAS, so acquisition and takeover are 409-arbitrated); a
**Membership** derives a deterministic shard map (the rendezvous hash of
pod uid over the live member set, versioned by a membership epoch); and
a shard filter threads through the engine's event handlers, so each
engine admits only its shard's pods.  When a member's lease expires,
survivors observe it through the watch path, bump their epochs and
adopt the orphaned shard; a bind raced in the rebalance window is
arbitrated by the bind subresource's unset-node_name guard and
per-entry ``expected_rv``, so no pod is ever bound twice.

    lease.py       CAS acquire / renew / release over any store façade
    membership.py  member registry, heartbeat, epochs, rendezvous map
    plane.py       one engine and its membership as an HA participant
    proc.py        an engine as a killable child process

The replicated plane's arbiter election (``controlplane/repl``) and the
sharded write plane (``controlplane/shards``) ride ``lease.py`` and
``shard_owner`` too.  ``HAEngine``, ``start_ha_engine`` and
``EngineSupervisor`` are exported as in JAX (``:25-35``) but imported on
first use: ``plane.py`` brings in the engine and torch, which the store
replicas' processes, importing ``lease.py``, never need.
"""

from minisched_tpu_torch.ha.lease import HA_NAMESPACE, LeaseLost, LeaseManager
from minisched_tpu_torch.ha.membership import Membership, shard_owner

__all__ = ["HA_NAMESPACE", "LeaseLost", "LeaseManager", "Membership",
           "shard_owner", "HAEngine", "start_ha_engine", "EngineSupervisor"]


def __getattr__(name: str):
    if name in ("HAEngine", "start_ha_engine"):
        from minisched_tpu_torch.ha import plane

        return getattr(plane, name)
    if name == "EngineSupervisor":
        from minisched_tpu_torch.ha.proc import EngineSupervisor

        return EngineSupervisor
    raise AttributeError(name)
