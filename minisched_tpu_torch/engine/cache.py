"""Incremental scheduler cache: NodeInfos maintained by informer events.

A copy of ``minisched_tpu/engine/cache.py`` (``:27-309``) without the
incremental-build feed (the dirty node-set, the mutation epoch,
``snapshot_for_tables`` and ``capacity_view``), which belongs to the
cached node-table builder and the pipeline (ROADMAP item 10d): the port's
wave packs its node table from ``snapshot_with_assigned`` every wave.

The upstream scheduler keeps a ``cache.Cache`` of NodeInfos updated by
informer events so each cycle's snapshot is O(changes), not O(cluster);
the reference skips it and re-lists + re-wraps every node and pod per
cycle (minisched/minisched.go:40,126-127 — SURVEY.md §7's "#1 pattern not
to copy").  At wave-engine scale the difference is decisive: a 100k-pod
cluster costs ~1s per snapshot to rebuild, and the wave engine snapshots
every wave.

``SchedulerCache`` subscribes to Pod/Node events (registered FIRST on the
informers, so the cache is current before any requeue handler fires) and
maintains per-node aggregates through ``NodeInfo.add_pod/remove_pod``.
``snapshot()`` returns name-sorted CLONES — callers own them (the wave
engine folds assumed pods in; preemption evicts from them) and clone cost
is O(nodes), not O(pods).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from minisched_tpu_torch.framework.nodeinfo import NodeInfo


class SchedulerCache:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._nodes: Dict[str, NodeInfo] = {}
        self._pod_node: Dict[str, str] = {}  # pod uid → node name
        #: assigned pods whose node the cache hasn't seen yet (event-order
        #: tolerance: a pod bound to a node whose ADD arrives later)
        self._orphans: Dict[str, Any] = {}
        self._sorted: Optional[List[NodeInfo]] = None

    # -- node events -------------------------------------------------------
    def _create_node(self, node: Any) -> None:
        """Caller holds the lock.  Creates the NodeInfo and adopts any
        orphans bound to it — shared by add_node and the update-for-an-
        unknown-node path (a live MODIFIED can reach a late-registered
        handler before its cache replay drains)."""
        ni = NodeInfo(node)
        self._nodes[node.metadata.name] = ni
        self._sorted = None
        for uid, pod in list(self._orphans.items()):
            if pod.spec.node_name == node.metadata.name:
                del self._orphans[uid]
                ni.add_pod(pod)
                self._pod_node[uid] = node.metadata.name

    def add_node(self, node: Any) -> None:
        with self._mu:
            ni = self._nodes.get(node.metadata.name)
            if ni is None:
                self._create_node(node)
            else:
                ni.node = node

    def update_node(self, old: Any, new: Any) -> None:
        with self._mu:
            ni = self._nodes.get(new.metadata.name)
            if ni is not None:
                ni.node = new
            else:  # update for a node we never saw: treat as add
                self._create_node(new)

    def delete_node(self, node: Any) -> None:
        with self._mu:
            self._delete_node_locked(node)

    def _delete_node_locked(self, node: Any) -> None:
        ni = self._nodes.pop(node.metadata.name, None)
        self._sorted = None
        if ni is not None:
            # the pods are still bound in the cluster view and will
            # emit no further events — re-orphan them so a node
            # re-registration with the same name re-adopts their
            # accounting instead of starting from an empty NodeInfo
            for p in ni.pods:
                self._pod_node.pop(p.metadata.uid, None)
                self._orphans[p.metadata.uid] = p

    # -- pod events (assigned pods only — the informer filter gates) ------
    def add_pod(self, pod: Any) -> None:
        with self._mu:
            self._place(pod)

    def update_pod(self, old: Any, new: Any) -> None:
        with self._mu:
            self._update_pod_locked(new)

    def _update_pod_locked(self, new: Any) -> None:
        uid = new.metadata.uid
        prev = self._pod_node.get(uid)
        if prev == new.spec.node_name:
            # same node: refresh the stored object (requests can't
            # change post-bind in kube semantics, but keep exact)
            ni = self._nodes.get(prev)
            if ni is not None:
                ni.remove_pod(new)
                ni.add_pod(new)
            return
        self._remove(new)
        self._place(new)

    def delete_pod(self, pod: Any) -> None:
        with self._mu:
            self._remove(pod)

    def _place(self, pod: Any) -> None:
        uid = pod.metadata.uid
        if uid in self._pod_node or uid in self._orphans:
            return  # duplicate event
        ni = self._nodes.get(pod.spec.node_name)
        if ni is None:
            self._orphans[uid] = pod
            return
        ni.add_pod(pod)
        self._pod_node[uid] = pod.spec.node_name

    def _remove(self, pod: Any) -> None:
        uid = pod.metadata.uid
        self._orphans.pop(uid, None)
        name = self._pod_node.pop(uid, None)
        if name is not None:
            ni = self._nodes.get(name)
            if ni is not None:
                ni.remove_pod(pod)

    # -- reads -------------------------------------------------------------
    def snapshot(self) -> List[NodeInfo]:
        """Name-sorted clones of every NodeInfo — caller-owned."""
        return self.snapshot_with_assigned()[0]

    def snapshot_with_assigned(self):
        """(snapshot, assigned-pod uids) from ONE locked read — callers
        that prune an assume-cache against the snapshot need the two views
        to be of the same instant, or a bind landing between two reads is
        dropped from the assumptions without being counted in the
        snapshot."""
        with self._mu:
            if self._sorted is None:
                self._sorted = sorted(
                    self._nodes.values(), key=lambda ni: ni.name
                )
            return [ni.clone() for ni in self._sorted], set(self._pod_node)

    # -- batch ingestion (informer on_batch fast path) ---------------------
    def _pod_batch(self, events: List[Any]) -> None:
        """A whole informer batch under ONE lock hold — a wave's thousands
        of bind events each cost dict ops, not a lock round-trip.  Applies
        the assigned-pod filter itself (batch handlers see the raw batch);
        errors are contained PER EVENT (one malformed object must not
        drop the rest of the batch from this consumer while others apply
        it — the per-event dispatch path had that containment)."""
        from minisched_tpu_torch.controlplane.store import EventType

        with self._mu:
            for ev in events:
                try:
                    if not ev.obj.spec.node_name:
                        continue
                    if ev.type == EventType.DELETED:
                        self._remove(ev.obj)
                    elif ev.type == EventType.ADDED:
                        self._place(ev.obj)
                    else:
                        self._update_pod_locked(ev.obj)
                except Exception:
                    import traceback

                    traceback.print_exc()

    def _node_batch(self, events: List[Any]) -> None:
        from minisched_tpu_torch.controlplane.store import EventType

        with self._mu:
            for ev in events:
                try:
                    node = ev.obj
                    if ev.type == EventType.DELETED:
                        self._delete_node_locked(node)
                        continue
                    ni = self._nodes.get(node.metadata.name)
                    if ni is None:
                        self._create_node(node)
                    else:
                        ni.node = node
                except Exception:
                    import traceback

                    traceback.print_exc()

    def wire(self, informer_factory: Any) -> None:
        """Register the cache's handlers.  MUST run before the queue's
        handlers are registered so a requeued pod's next snapshot already
        reflects the event that woke it."""
        from minisched_tpu_torch.controlplane.informer import ResourceEventHandlers

        # batch handlers: the dispatch thread hands over whole event
        # batches; the pod path gates on assignment internally (pending
        # pods never reach the cache; a bind arrives as MODIFIED whose new
        # object is assigned, deletes of assigned pods pass)
        informer_factory.informer_for("Pod").add_event_handlers(
            ResourceEventHandlers(on_batch=self._pod_batch)
        )
        informer_factory.informer_for("Node").add_event_handlers(
            ResourceEventHandlers(on_batch=self._node_batch)
        )
