"""HA coordination: TTL'd leases as 409-arbitrated CAS.

A part of ``minisched_tpu/ha/`` (``__init__.py``, ``lease.py``): the
``LeaseManager`` protocol the replicated plane's arbiter election rides
(``controlplane/repl.PlaneCoordinator``), its ``LeaseLost`` error and the
``HA_NAMESPACE`` coordination leases live in.

Left out, for ROADMAP item 8: ``membership.py`` (the member registry,
heartbeat, epochs and the rendezvous shard map ``shard_owner`` that item
7b's sharding needs), ``plane.py`` (an engine wired into membership, the
sharded active-active engines) and ``proc.py`` (an engine as a killable
child).
"""

from minisched_tpu_torch.ha.lease import HA_NAMESPACE, LeaseLost, LeaseManager

__all__ = ["HA_NAMESPACE", "LeaseLost", "LeaseManager"]
