"""tpu-minisched's device half in PyTorch, with hand-written Hopper kernels.

The JAX package ``minisched_tpu`` is the reference; this package mirrors
its module names (``models/tables.py``, ``ops/fused.py``, ``ops/state.py``,
``plugins/*``) so each function has an obvious counterpart.  It imports
``torch`` and ``numpy`` only, never ``jax`` and nothing of
``minisched_tpu``: what it needs from the host side is copied here.

Routing is decided by the tensor's device, never by a global flag: a
CUDA tensor goes to the hand-written kernel (``ops/kernels.py``,
``csrc/*.cu``) or the call raises; a CPU tensor takes the kernel's plain
PyTorch twin.  Entry points take ``device=None``, which means the card.

The port runs as a process (``python -m minisched_tpu_torch``,
``__main__.py``: the REST façade, the PV controller and the live engine,
``/metrics``, over the in-memory store or the durable WAL store of
``controlplane/durable.py``) or as a library
(``service.service.SchedulerService``, with ``record_results`` for the
simulator's per-plugin annotations); the gRPC servicer and the trace
ring serve beside it.  ``SchedulerService(RemoteClient(base))``
(``controlplane/remote.py``) runs the whole scheduling path against a
REST façade over the wire, riding through the façade's restart; with
``RemoteClient(leader, endpoints=[...])`` it rides a SIGKILL of the
leader of a replicated plane (``controlplane/repl.py``: quorum WAL
shipping, arbiter-lease failover; ``controlplane/replproc.py``: three
replica children), with ``ha/lease.py`` and ``faults/`` (the fabric and
the network-fault layer) under it; with ``ShardedClient(seeds)``
(``controlplane/shards.py``) over the leader groups of a sharded write
plane, through a live split of a tenant.  ``ha/`` runs active-active
engines (``ha.plane.start_ha_engine``: a lease-backed ``Membership``
whose rendezvous map is each engine's queue admission;
``ha.proc.EngineSupervisor``: an engine as a killable child process,
on the card by default), and ``faults/`` injects failures at named
points (store, watch, WAL, disk, façade, engine, replication, network)
and kills the control plane (``faults.proc.ServerSupervisor``).
``parallel/sharding.py`` evaluates waves and exact scans over a device
mesh (``MINISCHED_MESH``, ``MINISCHED_MESH_POD_SHARDS``,
``MINISCHED_MESH_DEVICES``, or ``make_mesh(devices=...)``), and
``utils/compilecache.py`` says where the kernels are built
(``MINISCHED_CACHE``, ``MINISCHED_CACHE_DIR``).  What the JAX package
does on one host, the port does; ``parallel/distributed.py`` spans a
mesh across processes for the one-shot steps, as JAX's puts hosts on the
pod axis (the live engine stays one process, as JAX's; distinct cards,
ROADMAP.md §1, are still to come).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> "torch.device":
    """The device an entry point runs on: ``None`` means the card.

    Raises ``RuntimeError`` when no card is present and the caller did not
    ask for the CPU explicitly — an entry point never carries on quietly
    on the host.  (``torch`` is imported here, not with the package: the
    control plane's processes, the store replicas among them, are host
    code and start without it.)"""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch twins on the host"
            )
        return torch.device("cuda")
    return torch.device(device)
