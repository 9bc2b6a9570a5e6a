"""HA coordination: TTL'd leases as 409-arbitrated CAS.

A part of ``minisched_tpu/ha/`` (``__init__.py``, ``lease.py`` and
``membership.shard_owner``): the ``LeaseManager`` protocol the replicated
plane's arbiter election rides (``controlplane/repl.PlaneCoordinator``),
its ``LeaseLost`` error, the ``HA_NAMESPACE`` coordination leases live
in, and the rendezvous owner the sharded write plane
(``controlplane/shards.py``) places namespaces with, exported here as in
JAX (``:25``).

Left out, for ROADMAP item 8: the rest of ``membership.py`` (the member
registry, heartbeat and epochs), ``plane.py`` (an engine wired into
membership, the sharded active-active engines) and ``proc.py`` (an
engine as a killable child).
"""

from minisched_tpu_torch.ha.lease import HA_NAMESPACE, LeaseLost, LeaseManager
from minisched_tpu_torch.ha.membership import shard_owner

__all__ = ["HA_NAMESPACE", "LeaseLost", "LeaseManager", "shard_owner"]
