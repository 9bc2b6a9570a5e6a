"""Plugin registry: config → the plugin chains of every extension point.

Counterpart of ``minisched_tpu/plugins/registry.py:164-194``: one factory
per plugin name, one instance per name even when a plugin serves several
extension points, chains in the config's order.  The device engine
evaluates the filter, pre-score and score chains through their batch
halves and the scalar engine through their scalar halves, so a plugin in
those chains must have both; either engine runs the host-side points
(post-filter, reserve, permit).  Instances with an ``h`` attribute
(NodeNumber, Coscheduling, DefaultPreemption) are listed in
``needs_handle``: the engine injects itself there as their handle.  Those
with a ``store_client`` attribute (the volume filters, which read PVs and
PVCs) are listed in ``needs_client``: the engine's builder injects the
client.  An unknown name raises ``KeyError``; nothing is dropped
silently.

``register`` adds a factory under a new name: the simulator layer
(``plugins/simulator.py``) registers a ``<name>ForSimulator`` wrapper for
every built-in.  A wrapper (it keeps its plugin in ``_inner``) passes the
batch checks when the plugin it wraps does.  ``canonical_filter_reasons``
gives each filter's rejection message for the wave-path record.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

from minisched_tpu_torch.framework.plugin import (
    BatchEvaluable,
    implements_filter,
    implements_permit,
    implements_post_filter,
    implements_pre_score,
    implements_reserve,
    implements_score,
)
from minisched_tpu_torch.plugins.coscheduling import Coscheduling
from minisched_tpu_torch.plugins.defaultpreemption import (
    DEFAULT_MIN_CANDIDATE_NODES_ABSOLUTE,
    DEFAULT_MIN_CANDIDATE_NODES_PERCENTAGE,
    DefaultPreemption,
)
from minisched_tpu_torch.plugins.gangtopology import GangTopology
from minisched_tpu_torch.plugins.imagelocality import ImageLocality
from minisched_tpu_torch.plugins.interpodaffinity import (
    REASON_AFFINITY,
    InterPodAffinity,
)
from minisched_tpu_torch.plugins.nodeaffinity import NodeAffinity
from minisched_tpu_torch.plugins.nodename import NodeName
from minisched_tpu_torch.plugins.nodenumber import NodeNumber
from minisched_tpu_torch.plugins.nodeports import NodePorts
from minisched_tpu_torch.plugins.noderesources import (
    NodeResourcesBalancedAllocation,
    NodeResourcesFit,
    NodeResourcesLeastAllocated,
)
from minisched_tpu_torch.plugins.nodeunschedulable import (
    REASON as REASON_UNSCHED,
)
from minisched_tpu_torch.plugins.nodeunschedulable import NodeUnschedulable
from minisched_tpu_torch.plugins.podtopologyspread import (
    REASON_SKEW,
    PodTopologySpread,
)
from minisched_tpu_torch.plugins.tainttoleration import TaintToleration
from minisched_tpu_torch.plugins.volumebinding import (
    REASON_NO_PV,
    NodeVolumeLimits,
    VolumeBinding,
)
from minisched_tpu_torch.plugins.volumelimits import (
    REASON_LIMIT,
    AzureDiskLimits,
    EBSLimits,
    GCEPDLimits,
)
from minisched_tpu_torch.plugins.volumerestrictions import (
    REASON_CONFLICT,
    VolumeRestrictions,
)
from minisched_tpu_torch.plugins.volumezone import REASON_ZONE, VolumeZone
from minisched_tpu_torch.service.config import SchedulerConfig

# factory signature: (args: dict, time_scale: float) -> plugin instance
Factory = Callable[[Dict[str, Any], float], Any]

_REGISTRY: Dict[str, Factory] = {
    "NodeUnschedulable": lambda args, ts: NodeUnschedulable(),
    "NodeNumber": lambda args, ts: NodeNumber(time_scale=ts),
    "NodeName": lambda args, ts: NodeName(),
    "TaintToleration": lambda args, ts: TaintToleration(),
    "NodeAffinity": lambda args, ts: NodeAffinity(),
    "NodePorts": lambda args, ts: NodePorts(),
    "NodeResourcesFit": lambda args, ts: NodeResourcesFit(
        scoring_strategy=args.get("scoring_strategy", "LeastAllocated")),
    "NodeResourcesLeastAllocated":
        lambda args, ts: NodeResourcesLeastAllocated(),
    "NodeResourcesBalancedAllocation":
        lambda args, ts: NodeResourcesBalancedAllocation(),
    "ImageLocality": lambda args, ts: ImageLocality(),
    "InterPodAffinity": lambda args, ts: InterPodAffinity(),
    "PodTopologySpread": lambda args, ts: PodTopologySpread(),
    "VolumeBinding": lambda args, ts: VolumeBinding(),
    "VolumeRestrictions": lambda args, ts: VolumeRestrictions(),
    "VolumeZone": lambda args, ts: VolumeZone(),
    "NodeVolumeLimits": lambda args, ts: NodeVolumeLimits(
        max_volumes=args.get("max_volumes")),
    "EBSLimits": lambda args, ts: EBSLimits(
        max_volumes=args.get("max_volumes")),
    "GCEPDLimits": lambda args, ts: GCEPDLimits(
        max_volumes=args.get("max_volumes")),
    "AzureDiskLimits": lambda args, ts: AzureDiskLimits(
        max_volumes=args.get("max_volumes")),
    "GangTopology": lambda args, ts: GangTopology(),
    "Coscheduling": lambda args, ts: Coscheduling(time_scale=ts),
    "DefaultPreemption": lambda args, ts: DefaultPreemption(
        min_candidate_nodes_percentage=args.get(
            "min_candidate_nodes_percentage",
            DEFAULT_MIN_CANDIDATE_NODES_PERCENTAGE),
        min_candidate_nodes_absolute=args.get(
            "min_candidate_nodes_absolute",
            DEFAULT_MIN_CANDIDATE_NODES_ABSOLUTE)),
}

#: the batch method a plugin must define to serve a device point (every
#: plugin may batch-pre-score: the protocol's default returns no aux)
_REQUIRED = {"filter": "batch_filter", "score": "batch_score"}
#: the capability probes of every point, as the JAX registry's (the
#: scalar halves of the device points, the host points)
_CHECKS = {
    "filter": implements_filter,
    "pre_score": implements_pre_score,
    "score": implements_score,
    "post_filter": implements_post_filter,
    "reserve": implements_reserve,
    "permit": implements_permit,
}


@dataclass
class PluginChains:
    filter: List[Any] = field(default_factory=list)
    post_filter: List[Any] = field(default_factory=list)
    pre_score: List[Any] = field(default_factory=list)
    score: List[Any] = field(default_factory=list)
    reserve: List[Any] = field(default_factory=list)
    permit: List[Any] = field(default_factory=list)
    #: instances that take the engine as their handle (``h``)
    needs_handle: List[Any] = field(default_factory=list)
    #: instances that read the PV/PVC store through ``store_client``
    needs_client: List[Any] = field(default_factory=list)


def inject(plugin: Any, attr: str, value: Any) -> None:
    """Set an injected dependency (``h``, ``store_client``) on the plugin
    itself: a simulator wrapper reads attributes through to the plugin it
    wraps, but a plain setattr would land on the wrapper."""
    setattr(getattr(plugin, "_inner", plugin), attr, value)


def register(name: str, factory: Factory) -> None:
    _REGISTRY[name] = factory


def registered_names() -> List[str]:
    return sorted(_REGISTRY)


def build_plugins(cfg: SchedulerConfig) -> PluginChains:
    chains = PluginChains()
    instances: Dict[str, Any] = {}
    for point, plugin_set in cfg.extension_points().items():
        for entry in plugin_set.enabled:
            if entry.name not in _REGISTRY:
                raise KeyError(
                    f"unknown plugin {entry.name!r}; registered: "
                    f"{registered_names()}"
                )
            if entry.name not in instances:
                instances[entry.name] = _REGISTRY[entry.name](
                    cfg.plugin_args.get(entry.name, {}), cfg.time_scale)
            inst = instances[entry.name]
            method = _REQUIRED.get(point)
            inner = getattr(inst, "_inner", inst)  # a simulator wrapper's
            implemented = _CHECKS[point](inst) and (
                not method or getattr(type(inner), method, None)
                is not getattr(BatchEvaluable, method))
            if not implemented:
                raise TypeError(
                    f"plugin {entry.name!r} does not implement {point}")
            getattr(chains, point).append(inst)
    chains.needs_handle = [p for p in instances.values() if hasattr(p, "h")]
    chains.needs_client = [p for p in instances.values()
                           if hasattr(p, "store_client")]
    return chains


def canonical_filter_reasons() -> Dict[str, str]:
    """Plugin name → the canonical rejection message its scalar filter
    emits: the ``reasons`` of ``Store.record_batch_result``, so wave-path
    annotations carry the strings scalar cycles do (JAX
    ``registry.py:197``).  The plugins' own REASON constants where one
    exists; a summary string where the scalar message is per case
    (resources, ports)."""
    return {
        "NodeUnschedulable": REASON_UNSCHED,
        "NodeName": "node(s) didn't match the requested node name",
        "TaintToleration": "node(s) had taints that the pod didn't tolerate",
        "NodeAffinity": "node(s) didn't match Pod's node affinity/selector",
        "NodePorts":
            "node(s) didn't have free ports for the requested pod ports",
        "NodeResourcesFit": "node(s) didn't have enough resources",
        "VolumeRestrictions": REASON_CONFLICT,
        "EBSLimits": REASON_LIMIT,
        "GCEPDLimits": REASON_LIMIT,
        "NodeVolumeLimits": REASON_LIMIT,
        "AzureDiskLimits": REASON_LIMIT,
        "VolumeBinding": REASON_NO_PV,
        "VolumeZone": REASON_ZONE,
        "PodTopologySpread": REASON_SKEW,
        "InterPodAffinity": REASON_AFFINITY,
        "NodeNumber": "node(s) rejected by nodenumber",
    }
