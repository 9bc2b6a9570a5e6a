"""Cluster events: what happened in the cluster, and which pods it may help.

A copy of ``minisched_tpu/framework/events.py``.

Re-creates framework.ClusterEvent / GVK / ActionType and the wildcard
matching semantics the reference's queue relies on
(minisched/queue/queue.go:167-202, minisched/eventhandler.go:37-58,
minisched/initialize.go:140-179).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Iterable, List, Set


class ActionType(enum.IntFlag):
    """Bit-flag action types (framework.ActionType)."""

    ADD = 1 << 0
    DELETE = 1 << 1
    UPDATE_NODE_ALLOCATABLE = 1 << 2
    UPDATE_NODE_LABEL = 1 << 3
    UPDATE_NODE_TAINT = 1 << 4
    UPDATE_NODE_CONDITION = 1 << 5
    UPDATE = (
        UPDATE_NODE_ALLOCATABLE
        | UPDATE_NODE_LABEL
        | UPDATE_NODE_TAINT
        | UPDATE_NODE_CONDITION
    )
    ALL = ADD | DELETE | UPDATE


class GVK(str, enum.Enum):
    """Group-version-kind names used for event registration (framework.GVK)."""

    POD = "Pod"
    NODE = "Node"
    PERSISTENT_VOLUME = "PersistentVolume"
    PERSISTENT_VOLUME_CLAIM = "PersistentVolumeClaim"
    STORAGE_CLASS = "storage.k8s.io/StorageClass"
    CSI_NODE = "storage.k8s.io/CSINode"
    SERVICE = "Service"
    WILDCARD = "*"


@dataclass(frozen=True)
class ClusterEvent:
    """An event a plugin can subscribe to (framework.ClusterEvent).

    ``is_wildcard`` mirrors upstream: Resource "*" with ActionType All
    matches everything (semantics used at minisched/queue/queue.go:171-176).
    """

    resource: GVK
    action_type: ActionType
    label: str = ""

    def is_wildcard(self) -> bool:
        return self.resource == GVK.WILDCARD and self.action_type == ActionType.ALL

    def match(self, incoming: "ClusterEvent") -> bool:
        """Does this *registered* event cover the *incoming* event?

        Mirrors queue.go:181-190 (resource equality-or-wildcard AND
        action-type bit intersection, queue.go:192-202).
        """
        if self.is_wildcard():
            return True
        if self.resource != incoming.resource and self.resource != GVK.WILDCARD:
            return False
        return bool(self.action_type & incoming.action_type)


# ClusterEventMap: registered event -> set of plugin names that care.
ClusterEventMap = Dict[ClusterEvent, Set[str]]


def merge_event_registrations(
    registrations: Iterable[tuple[str, List[ClusterEvent]]],
    event_map: ClusterEventMap,
) -> None:
    """Fold each plugin's EventsToRegister into the shared map.

    Equivalent of minisched/initialize.go:159-167 — with the reference's
    known bug fixed: events are registered under the *emitting plugin's own
    name* (the reference registers nodenumber's events under
    nodeunschedulable's name, initialize.go:154; SURVEY.md §7 "do not copy").
    """
    for plugin_name, events in registrations:
        for ev in events:
            event_map.setdefault(ev, set()).add(plugin_name)


def unioned_gvks(event_map: ClusterEventMap) -> Dict[GVK, ActionType]:
    """Union action types per GVK (minisched/initialize.go:169-179); used to
    decide which informer handlers to wire (eventhandler.go:37-58)."""
    out: Dict[GVK, ActionType] = {}
    for ev in event_map:
        out[ev.resource] = out.get(ev.resource, ActionType(0)) | ev.action_type
    return out


def event_helps_pod(
    incoming: ClusterEvent,
    failed_plugins: Set[str],
    event_map: ClusterEventMap,
) -> bool:
    """Can ``incoming`` possibly make a previously-unschedulable pod
    schedulable?  (podMatchesEvent, minisched/queue/queue.go:167-190.)

    True iff some registered event matching ``incoming`` belongs to at least
    one plugin that rejected the pod.  A pod with *no* recorded failed
    plugins is conservatively retried on any event (upstream behavior).
    """
    if not failed_plugins:
        return True
    for registered, plugin_names in event_map.items():
        if registered.match(incoming) and (plugin_names & failed_plugins):
            return True
    return False
