"""Informer → queue event wiring.

A copy of ``minisched_tpu/engine/eventhandlers.py`` (``:22-155``).

Re-creates ``minisched/eventhandler.go:14-77``: unassigned pods feed the
active queue; node (and other GVK) events trigger event-gated requeue of
unschedulable pods.  Where the reference leaves most GVK handlers commented
out (eventhandler.go:66-73) and pod update/delete unimplemented, this wires
the full set the upstream scheduler uses for the kinds our control plane
serves (Pod, Node, PV, PVC).
"""

from __future__ import annotations

from typing import Any, Dict

from minisched_tpu_torch.controlplane.informer import (
    ResourceEventHandlers,
    SharedInformerFactory,
)
from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK


def assigned(pod: Any) -> bool:
    """eventhandler.go:80-82."""
    return bool(pod.spec.node_name)


def node_update_action_type(old: Any, new: Any) -> ActionType:
    """Diff old/new node into the specific UPDATE_NODE_* flags (upstream
    computes these so event gating stays precise)."""
    action = ActionType(0)
    if old is None:
        return ActionType.UPDATE
    if old.status.allocatable != new.status.allocatable:
        action |= ActionType.UPDATE_NODE_ALLOCATABLE
    if old.metadata.labels != new.metadata.labels:
        action |= ActionType.UPDATE_NODE_LABEL
    if old.spec.taints != new.spec.taints or old.spec.unschedulable != new.spec.unschedulable:
        # spec.unschedulable is surfaced as a taint upstream
        action |= ActionType.UPDATE_NODE_TAINT
    return action or ActionType.UPDATE


def add_all_event_handlers(
    sched: Any,
    informer_factory: SharedInformerFactory,
    gvk_actions: Dict[GVK, ActionType],
) -> None:
    """eventhandler.go:14-77, driven by the unioned GVK→ActionType map from
    plugin registrations (initialize.go:169-179)."""
    # --- pods: the scheduling workload itself (always wired) -----------
    from minisched_tpu_torch.controlplane.store import EventType

    pod_informer = informer_factory.informer_for("Pod")

    def unassigned_batch(events):
        """Pending pods feed the queue — gated on the engine's shard
        filter (``sched.admits``: always-true single-engine, the HA
        membership's rendezvous map otherwise).  ADD floods (cluster
        creation replays every pending pod) take the one-lock batch path;
        a MODIFIED that leaves the engine's schedulable population —
        bound (possibly by a PEER engine in an HA plane) or re-sharded
        away — is dropped via the batched ``delete_many`` (one lock +
        set-intersect for the whole batch: in a single-engine plane every
        bind event of a wave lands here, and a per-event queue scan would
        be O(events × queue))."""
        adds = [
            ev.obj
            for ev in events
            if ev.type == EventType.ADDED
            and not assigned(ev.obj)
            and sched.admits(ev.obj)
        ]
        if adds:
            sched.queue.add_batch(adds)
        drops = []
        for ev in events:
            try:
                if ev.type == EventType.ADDED:
                    continue
                if ev.type == EventType.MODIFIED:
                    if assigned(ev.obj) or not sched.admits(ev.obj):
                        drops.append(ev.obj)
                    else:
                        sched.queue.update(ev.old_obj, ev.obj)
                elif not assigned(ev.obj):
                    sched.queue.delete(ev.obj)
            except Exception:  # one bad event must not drop the rest
                import traceback

                traceback.print_exc()
        if drops:
            try:
                sched.queue.delete_many(drops)
            except Exception:
                import traceback

                traceback.print_exc()

    pod_informer.add_event_handlers(
        ResourceEventHandlers(on_batch=unassigned_batch)
    )

    # assigned pods may unblock pods waiting on inter-pod constraints;
    # their DELETION frees capacity (it is how preemption victims make
    # room), so it replays pods whose failed plugins registered Pod/DELETE.
    # move_all_to_active_or_backoff is pod-independent — one call per
    # action type present covers the whole batch (a wave's 8k binds used
    # to cost 8k queue-lock round-trips finding the same empty candidates)
    def assigned_batch(events):
        types = {ev.type for ev in events if assigned(ev.obj)}
        if EventType.ADDED in types:
            sched.queue.move_all_to_active_or_backoff(
                ClusterEvent(GVK.POD, ActionType.ADD)
            )
        if EventType.MODIFIED in types:
            sched.queue.move_all_to_active_or_backoff(
                ClusterEvent(GVK.POD, ActionType.UPDATE)
            )
        if EventType.DELETED in types:
            sched.queue.move_all_to_active_or_backoff(
                ClusterEvent(GVK.POD, ActionType.DELETE)
            )

    pod_informer.add_event_handlers(
        ResourceEventHandlers(on_batch=assigned_batch)
    )

    # --- other GVKs, gated on what plugins registered -------------------
    def requeue(event: ClusterEvent):
        return lambda *_args: sched.queue.move_all_to_active_or_backoff(event)

    for gvk, actions in gvk_actions.items():
        if gvk in (GVK.POD, GVK.WILDCARD):
            continue
        kind = gvk.value.split("/")[-1]
        handlers = ResourceEventHandlers()
        if actions & ActionType.ADD:
            handlers.on_add = requeue(ClusterEvent(gvk, ActionType.ADD))
        if actions & ActionType.UPDATE:
            if gvk == GVK.NODE:

                def on_node_update(old: Any, new: Any, _gvk=gvk) -> None:
                    action = node_update_action_type(old, new)
                    sched.queue.move_all_to_active_or_backoff(
                        ClusterEvent(_gvk, action)
                    )

                handlers.on_update = on_node_update
            else:
                handlers.on_update = lambda old, new, _g=gvk: sched.queue.move_all_to_active_or_backoff(
                    ClusterEvent(_g, ActionType.UPDATE)
                )
        if actions & ActionType.DELETE:
            handlers.on_delete = requeue(ClusterEvent(gvk, ActionType.DELETE))
        informer_factory.informer_for(kind).add_event_handlers(handlers)
