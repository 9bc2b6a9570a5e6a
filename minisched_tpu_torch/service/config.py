"""Configuration: the process's environment and the scheduler's plugins.

A copy of ``minisched_tpu/service/config.py``, in two tiers as the
reference has them:

* ``ProcessConfig``: the required environment variables
  (``config/config.go:22-75``: PORT and FRONTEND_URL, each required or
  ``EmptyEnvError``), and the optional external store URL
  (``MINISCHED_TPU_STORE_URL``) in place of the etcd URL;
* ``SchedulerConfig``: the KubeSchedulerConfiguration analog with
  enable/disable lists (``"*"`` wildcard), per-plugin weights and args,
  the two rosters the JAX package ships and its merge of a user's
  customization over a default, and the device-mesh pin of the wave
  engine (``mesh_devices``, ``mesh_pod_shards``).

``node_local_roster_config`` is the full default roster without the
plugins that read the wave's constraint tables (volumes, topology spread,
inter-pod affinity); ``gang_roster_config`` is the full roster with the
gang subsystem.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class EmptyEnvError(Exception):
    """config/config.go:12's ErrEmptyEnv."""


@dataclass
class ProcessConfig:
    port: int
    frontend_url: str
    external_store_url: str = ""

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None) -> "ProcessConfig":
        env = env if env is not None else dict(os.environ)

        def require(key: str) -> str:
            v = env.get(key, "")
            if not v:
                raise EmptyEnvError(
                    f"env variable {key} is required but empty")
            return v

        return ProcessConfig(
            port=int(require("PORT")),
            frontend_url=require("FRONTEND_URL"),
            external_store_url=env.get("MINISCHED_TPU_STORE_URL", ""),
        )


@dataclass
class PluginEnabled:
    name: str
    weight: int = 1


@dataclass
class PluginSet:
    enabled: List[PluginEnabled] = field(default_factory=list)
    disabled: List[str] = field(default_factory=list)  # names or ["*"]


@dataclass
class SchedulerConfig:
    filter: PluginSet = field(default_factory=PluginSet)
    post_filter: PluginSet = field(default_factory=PluginSet)
    pre_score: PluginSet = field(default_factory=PluginSet)
    score: PluginSet = field(default_factory=PluginSet)
    reserve: PluginSet = field(default_factory=PluginSet)
    permit: PluginSet = field(default_factory=PluginSet)
    plugin_args: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    queue_opts: Dict[str, Any] = field(default_factory=dict)
    time_scale: float = 1.0
    #: device-mesh pin for the wave engine (JAX ``:80-86``): 0 devices
    #: defers to the startup policy (``MINISCHED_MESH``, auto on more than
    #: one card: ``parallel/sharding.resolve_mesh``); a nonzero count (and
    #: an optional pod-axis factoring) builds exactly that mesh over the
    #: visible cards.  The scalar engine ignores it.
    mesh_devices: int = 0
    mesh_pod_shards: Optional[int] = None

    def clone(self) -> "SchedulerConfig":
        return copy.deepcopy(self)

    def score_weights(self) -> Dict[str, int]:
        return {e.name: e.weight for e in self.score.enabled}

    def extension_points(self) -> Dict[str, PluginSet]:
        return {
            "filter": self.filter,
            "post_filter": self.post_filter,
            "pre_score": self.pre_score,
            "score": self.score,
            "reserve": self.reserve,
            "permit": self.permit,
        }


def default_scheduler_config(time_scale: float = 1.0) -> SchedulerConfig:
    """The minisched default wiring: filter [NodeUnschedulable];
    pre-score/score/permit [NodeNumber]."""
    return SchedulerConfig(
        filter=PluginSet(enabled=[PluginEnabled("NodeUnschedulable")]),
        pre_score=PluginSet(enabled=[PluginEnabled("NodeNumber")]),
        score=PluginSet(enabled=[PluginEnabled("NodeNumber", weight=1)]),
        permit=PluginSet(enabled=[PluginEnabled("NodeNumber")]),
        time_scale=time_scale,
    )


def default_full_roster_config(time_scale: float = 1.0) -> SchedulerConfig:
    """The upstream default plugin roster: 15 filters and 7 scorers in the
    reference's order and weights (NodeResourcesFit scores through its
    LeastAllocated strategy)."""
    return SchedulerConfig(
        filter=PluginSet(
            enabled=[
                PluginEnabled("NodeUnschedulable"),
                PluginEnabled("NodeName"),
                PluginEnabled("TaintToleration"),
                PluginEnabled("NodeAffinity"),
                PluginEnabled("NodePorts"),
                PluginEnabled("NodeResourcesFit"),
                PluginEnabled("VolumeRestrictions"),
                PluginEnabled("EBSLimits"),
                PluginEnabled("GCEPDLimits"),
                PluginEnabled("NodeVolumeLimits"),
                PluginEnabled("AzureDiskLimits"),
                PluginEnabled("VolumeBinding"),
                PluginEnabled("VolumeZone"),
                PluginEnabled("PodTopologySpread"),
                PluginEnabled("InterPodAffinity"),
            ]
        ),
        post_filter=PluginSet(enabled=[PluginEnabled("DefaultPreemption")]),
        pre_score=PluginSet(
            enabled=[
                PluginEnabled("ImageLocality"),
                PluginEnabled("InterPodAffinity"),
                PluginEnabled("PodTopologySpread"),
            ]
        ),
        score=PluginSet(
            enabled=[
                PluginEnabled("NodeResourcesBalancedAllocation", weight=1),
                PluginEnabled("ImageLocality", weight=1),
                PluginEnabled("InterPodAffinity", weight=1),
                PluginEnabled("NodeResourcesFit", weight=1),
                PluginEnabled("NodeAffinity", weight=1),
                PluginEnabled("PodTopologySpread", weight=2),
                PluginEnabled("TaintToleration", weight=1),
            ]
        ),
        time_scale=time_scale,
    )


def gang_roster_config(time_scale: float = 1.0) -> SchedulerConfig:
    """The full default roster plus the gang subsystem: GangTopology at
    pre-score and score (slice and torus locality toward a gang's placed
    members) and Coscheduling at Permit (all-or-nothing admission).  With
    no gang present it places exactly as the full roster (GangTopology
    scores 0 everywhere).

    Permit is a host-side point that only the live engine
    (``engine/device_scheduler.py``) runs: there Coscheduling admits a
    gang all or nothing.  The one-shot wave and scan drivers place gang
    members one by one, so a gang can end partly placed."""
    cfg = default_full_roster_config(time_scale=time_scale)
    cfg.pre_score.enabled.append(PluginEnabled("GangTopology"))
    cfg.score.enabled.append(PluginEnabled("GangTopology", weight=1))
    cfg.permit = PluginSet(enabled=[PluginEnabled("Coscheduling")])
    return cfg


#: plugins of the full roster that read the wave's constraint tables
CONSTRAINT_FILTERS = (
    "VolumeRestrictions", "EBSLimits", "GCEPDLimits", "NodeVolumeLimits",
    "AzureDiskLimits", "VolumeBinding", "VolumeZone", "PodTopologySpread",
    "InterPodAffinity",
)
CONSTRAINT_SCORERS = ("InterPodAffinity", "PodTopologySpread")


def node_local_roster_config(time_scale: float = 1.0) -> SchedulerConfig:
    """The full default roster minus every plugin that reads constraint
    tables, merged as a user's customization would be: filters
    NodeUnschedulable, NodeName, TaintToleration, NodeAffinity, NodePorts,
    NodeResourcesFit; pre-score ImageLocality; scorers BalancedAllocation,
    ImageLocality, NodeResourcesFit, NodeAffinity, TaintToleration at the
    roster's weights.  On pods without volumes, pod (anti-)affinity or
    spread constraints it places exactly as the full roster does."""
    return apply_plugin_customization(
        default_full_roster_config(time_scale),
        SchedulerConfig(
            filter=PluginSet(disabled=list(CONSTRAINT_FILTERS)),
            pre_score=PluginSet(disabled=list(CONSTRAINT_SCORERS)),
            score=PluginSet(disabled=list(CONSTRAINT_SCORERS)),
        ),
    )


def apply_plugin_customization(
    default: SchedulerConfig, custom: SchedulerConfig
) -> SchedulerConfig:
    """Merge a user's plugin enable/disable lists over the default config:
    ``disabled`` takes exact names or the ``"*"`` wildcard (drop every
    default); enabled entries are appended in order after the surviving
    defaults; the user's plugin args win."""
    out = default.clone()
    for point, merged in out.extension_points().items():
        user: PluginSet = getattr(custom, point)
        disabled = set(user.disabled)
        if "*" in disabled:
            merged.enabled = []
        else:
            merged.enabled = [e for e in merged.enabled if e.name not in disabled]
        existing = {e.name for e in merged.enabled}
        for e in user.enabled:
            if e.name not in existing:
                merged.enabled.append(copy.deepcopy(e))
    for name, args in custom.plugin_args.items():
        out.plugin_args[name] = copy.deepcopy(args)
    out.queue_opts.update(custom.queue_opts)
    if custom.time_scale != 1.0:
        out.time_scale = custom.time_scale
    return out
