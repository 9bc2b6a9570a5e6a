"""Plugin registry: config → the batch plugin chains of the device half.

Counterpart of ``minisched_tpu/plugins/registry.py:164-194``: one factory
per plugin name, one instance per name even when a plugin serves several
extension points, chains in the config's order.  The port builds the
chains the device evaluates (filter, pre-score, score).  The host-side
extension points (post-filter, reserve, permit) run in the scheduling
engine, which the port does not have yet: their plugin names are returned
in ``PluginChains.host_side``, not built.  An unknown name raises
``KeyError``; nothing is dropped silently.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.plugins.gangtopology import GangTopology
from minisched_tpu_torch.plugins.imagelocality import ImageLocality
from minisched_tpu_torch.plugins.interpodaffinity import InterPodAffinity
from minisched_tpu_torch.plugins.nodeaffinity import NodeAffinity
from minisched_tpu_torch.plugins.nodename import NodeName
from minisched_tpu_torch.plugins.nodenumber import NodeNumber
from minisched_tpu_torch.plugins.nodeports import NodePorts
from minisched_tpu_torch.plugins.noderesources import (
    NodeResourcesBalancedAllocation,
    NodeResourcesFit,
    NodeResourcesLeastAllocated,
)
from minisched_tpu_torch.plugins.nodeunschedulable import NodeUnschedulable
from minisched_tpu_torch.plugins.podtopologyspread import PodTopologySpread
from minisched_tpu_torch.plugins.tainttoleration import TaintToleration
from minisched_tpu_torch.plugins.volumebinding import NodeVolumeLimits, VolumeBinding
from minisched_tpu_torch.plugins.volumelimits import (
    AzureDiskLimits,
    EBSLimits,
    GCEPDLimits,
)
from minisched_tpu_torch.plugins.volumerestrictions import VolumeRestrictions
from minisched_tpu_torch.plugins.volumezone import VolumeZone
from minisched_tpu_torch.service.config import SchedulerConfig

# factory signature: (args: dict) -> plugin instance
Factory = Callable[[Dict[str, Any]], Any]

_REGISTRY: Dict[str, Factory] = {
    "NodeUnschedulable": lambda args: NodeUnschedulable(),
    "NodeNumber": lambda args: NodeNumber(),
    "NodeName": lambda args: NodeName(),
    "TaintToleration": lambda args: TaintToleration(),
    "NodeAffinity": lambda args: NodeAffinity(),
    "NodePorts": lambda args: NodePorts(),
    "NodeResourcesFit": lambda args: NodeResourcesFit(
        scoring_strategy=args.get("scoring_strategy", "LeastAllocated")),
    "NodeResourcesLeastAllocated": lambda args: NodeResourcesLeastAllocated(),
    "NodeResourcesBalancedAllocation":
        lambda args: NodeResourcesBalancedAllocation(),
    "ImageLocality": lambda args: ImageLocality(),
    "InterPodAffinity": lambda args: InterPodAffinity(),
    "PodTopologySpread": lambda args: PodTopologySpread(),
    "VolumeBinding": lambda args: VolumeBinding(),
    "VolumeRestrictions": lambda args: VolumeRestrictions(),
    "VolumeZone": lambda args: VolumeZone(),
    "NodeVolumeLimits": lambda args: NodeVolumeLimits(
        max_volumes=args.get("max_volumes")),
    "EBSLimits": lambda args: EBSLimits(max_volumes=args.get("max_volumes")),
    "GCEPDLimits": lambda args: GCEPDLimits(
        max_volumes=args.get("max_volumes")),
    "AzureDiskLimits": lambda args: AzureDiskLimits(
        max_volumes=args.get("max_volumes")),
    "GangTopology": lambda args: GangTopology(),
}

#: extension points the device evaluates; the others run in the engine
DEVICE_POINTS = ("filter", "pre_score", "score")
#: the batch method a plugin must define to serve a device point (every
#: plugin may pre-score: the protocol's default returns no aux)
_REQUIRED = {"filter": "batch_filter", "score": "batch_score"}


@dataclass
class PluginChains:
    filter: List[Any] = field(default_factory=list)
    pre_score: List[Any] = field(default_factory=list)
    score: List[Any] = field(default_factory=list)
    #: names enabled at the host-side points (post_filter, reserve,
    #: permit), which the engine runs: not built here
    host_side: Dict[str, List[str]] = field(default_factory=dict)


def registered_names() -> List[str]:
    return sorted(_REGISTRY)


def build_plugins(cfg: SchedulerConfig) -> PluginChains:
    chains = PluginChains()
    instances: Dict[str, Any] = {}
    for point, plugin_set in cfg.extension_points().items():
        if point not in DEVICE_POINTS:
            if plugin_set.enabled:
                chains.host_side[point] = [e.name for e in plugin_set.enabled]
            continue
        for entry in plugin_set.enabled:
            if entry.name not in _REGISTRY:
                raise KeyError(
                    f"unknown plugin {entry.name!r}; registered: "
                    f"{registered_names()}"
                )
            if entry.name not in instances:
                instances[entry.name] = _REGISTRY[entry.name](
                    cfg.plugin_args.get(entry.name, {}))
            inst = instances[entry.name]
            method = _REQUIRED.get(point)
            if method and getattr(type(inst), method) is getattr(BatchEvaluable, method):
                raise TypeError(
                    f"plugin {entry.name!r} does not implement {point}")
            getattr(chains, point).append(inst)
    return chains
