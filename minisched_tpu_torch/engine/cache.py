"""Incremental scheduler cache: NodeInfos maintained by informer events.

A copy of ``minisched_tpu/engine/cache.py`` (``:27-309``), with the feed
of the cached node-table builder (``models/tables.CachedNodeTableBuilder``)
and the pipeline: the dirty node-set, drained atomically with a snapshot
by ``snapshot_for_tables``; the mutation ``epoch``; and ``capacity_view``,
the pipelined wave's re-arbitration base.  One deliberate difference: a
Node update through the batch path bumps the epoch here as it does
through ``update_node`` (the JAX ``_node_batch`` does not, so an idle
wave there could reuse tables built before a node's labels changed).

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
from typing import Any, Dict, List, Optional, Set, Tuple

from minisched_tpu_torch.api.objects import MIB
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
        # names of nodes whose assigned-pod aggregates changed since the
        # last drain; None = everything (first drain, or node membership
        # changed and row indices shifted).  Drained only by
        # snapshot_for_tables (the wave path); plain snapshots leave it
        self._dirty: Optional[Set[str]] = None
        # bumped on every mutation that can change what a node-table build
        # produces; an equal epoch (with the same assume-delta) lets the
        # builder reuse its last tables.  Orphan staging does not bump.
        self._epoch = 0

    # -- node events -------------------------------------------------------
    def _create_node(self, node: Any) -> None:
        """Caller holds the lock.  Creates the NodeInfo and adopts any
        orphans bound to it — shared by add_node and the update-for-an-
        unknown-node path (a live MODIFIED can reach a late-registered
        handler before its cache replay drains)."""
        ni = NodeInfo(node)
        self._nodes[node.metadata.name] = ni
        self._sorted = None
        self._dirty = None  # membership changed: row indices shifted
        self._epoch += 1
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
                self._epoch += 1

    def update_node(self, old: Any, new: Any) -> None:
        with self._mu:
            ni = self._nodes.get(new.metadata.name)
            if ni is not None:
                ni.node = new
                self._epoch += 1
            else:  # update for a node we never saw: treat as add
                self._create_node(new)

    def delete_node(self, node: Any) -> None:
        with self._mu:
            self._delete_node_locked(node)

    def _delete_node_locked(self, node: Any) -> None:
        ni = self._nodes.pop(node.metadata.name, None)
        self._sorted = None
        self._dirty = None  # membership changed: row indices shifted
        self._epoch += 1
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
                self._mark_dirty(prev)
            return
        self._remove(new)
        self._place(new)

    def _mark_dirty(self, name: str) -> None:
        self._epoch += 1  # every caller just changed a node's aggregates
        if self._dirty is not None:
            self._dirty.add(name)

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
        self._mark_dirty(pod.spec.node_name)

    def _remove(self, pod: Any) -> None:
        uid = pod.metadata.uid
        self._orphans.pop(uid, None)
        name = self._pod_node.pop(uid, None)
        if name is not None:
            ni = self._nodes.get(name)
            if ni is not None:
                ni.remove_pod(pod)
                self._mark_dirty(name)

    # -- reads -------------------------------------------------------------
    def assigned_count(self) -> int:
        """How many pods the cache holds on a node."""
        with self._mu:
            return len(self._pod_node)

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

    def snapshot_for_tables(self):
        """(snapshot, assigned-pod uids, dirty node names, epoch) from ONE
        locked read: the wave table builder's entry point.  ``dirty`` is
        the set of nodes whose aggregates changed since the previous drain
        (None: rebuild everything); draining it with the snapshot is what
        keeps the builder's incremental aggregate base exact.  ``epoch``
        is the mutation counter at the snapshot: an equal epoch later
        means a byte-identical snapshot."""
        with self._mu:
            if self._sorted is None:
                self._sorted = sorted(
                    self._nodes.values(), key=lambda ni: ni.name
                )
            dirty = self._dirty
            self._dirty = set()
            return (
                [ni.clone() for ni in self._sorted],
                set(self._pod_node),
                dirty,
                self._epoch,
            )

    @property
    def epoch(self) -> int:
        """The mutation counter (see ``snapshot_for_tables``)."""
        with self._mu:
            return self._epoch

    def capacity_view(
        self, names: Any
    ) -> Tuple[Dict[str, List[int]], Dict[str, Set[str]]]:
        """({name: [free milli-CPU, free memory MiB, free ephemeral MiB,
        free pod slots]}, {name: uids of the pods the cache counts there})
        for the given nodes, from the live NodeInfos under one lock hold:
        the pipelined wave's re-arbitration base.  The uid sets let the
        caller fold its assume cache without subtracting a pod whose bind
        event already landed.  MiB-floored as the table builders."""
        free: Dict[str, List[int]] = {}
        counted: Dict[str, Set[str]] = {}
        with self._mu:
            for name in names:
                ni = self._nodes.get(name)
                if ni is None:
                    continue
                alloc = ni.node.status.allocatable
                free[name] = [
                    alloc.milli_cpu - ni.requested.milli_cpu,
                    alloc.memory // MIB - ni.req_mem_mib,
                    alloc.ephemeral_storage // MIB - ni.req_eph_mib,
                    alloc.pods - len(ni.pods),
                ]
                counted[name] = {p.metadata.uid for p in ni.pods}
        return free, counted

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
                        self._epoch += 1
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
