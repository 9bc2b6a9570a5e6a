"""Where a gang's members already landed: the placed-member view.

Counterpart of the host half of ``minisched_tpu/engine/gang.py``.  The
``GangTopology`` scorer (``plugins/gangtopology.py``) pulls each gang
member toward its placed peers: the same slice first, then torus
proximity to their centroid.  It reads that from five pod-table columns
(``gang_slice``, ``gang_sx``, ``gang_sy``, ``gang_sz``, ``gang_n``), which
the table encoder fills from a gang view: gang key → aggregate.

Aggregate format (the tuple every consumer passes around)::

    (majority_slice_hash, sum_x, sum_y, sum_z, n)

Integer sums, never a centroid float: the scorer divides on the device
with the floor the scalar rule uses.

``node_topo``, ``node_dims``, ``aggregate_coords`` and
``gang_view_from_infos`` are the JAX module's, duck-typed over objects
with ``.node`` and ``.pods``.  ``GangIndex`` (JAX ``:100-215``) is the live
engine's: informer-wired, it keeps each gang's BOUND members and every
node's topology, gives Coscheduling its ``placed_count`` and each wave
its ``view_for`` (with the engine's assumed members folded on top).
``PlacedGangs`` is what a one-shot wave or scan driver keeps instead: the
topology tuples of each gang's placed members, the assigned ones and
every one committed since.  Either way a batch's view costs O(members of
the batch's gangs).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from minisched_tpu_torch.api.objects import gang_key
from minisched_tpu_torch.models.tables import with_gang_view
from minisched_tpu_torch.utils.hashing import fnv1a32

#: node topology tuple: (slice_hash, torus_x, torus_y, torus_z)
Topo = Tuple[int, int, int, int]
#: gang aggregate tuple: (majority_slice_hash, sx, sy, sz, n)
GangAgg = Tuple[int, int, int, int, int]

_NO_TOPO: Topo = (0, 0, 0, 0)


def node_topo(node: Any) -> Topo:
    """A node's topology tuple, with the node table's zeroing rule
    (sliceless nodes contribute zero coordinates)."""
    spec = node.spec
    if not spec.slice_id:
        return _NO_TOPO
    return (fnv1a32(spec.slice_id), spec.torus_x, spec.torus_y, spec.torus_z)


def node_dims(node: Any) -> Tuple[int, int, int]:
    """The node's slice torus dimensions (ring size per axis), zero for a
    sliceless node; 0 on an axis means the distance does not wrap."""
    spec = node.spec
    if not spec.slice_id:
        return (0, 0, 0)
    return (spec.slice_dx, spec.slice_dy, spec.slice_dz)


def aggregate_coords(coords: Iterable[Topo]) -> Optional[GangAgg]:
    """Fold placed-member topology tuples into the gang aggregate (None
    for no members).  The majority slice is the highest count, ties to the
    smallest hash."""
    counts: Dict[int, int] = {}
    sx = sy = sz = n = 0
    for sh, x, y, z in coords:
        n += 1
        sx += x
        sy += y
        sz += z
        if sh:
            counts[sh] = counts.get(sh, 0) + 1
    if n == 0:
        return None
    slice_hash = 0
    if counts:
        best = max(counts.values())
        slice_hash = min(k for k, v in counts.items() if v == best)
    return (slice_hash, sx, sy, sz, n)


def gang_view_from_infos(node_infos: Iterable[Any],
                         keys: Optional[set] = None) -> Dict[str, GangAgg]:
    """The placed-gang view of a snapshot: objects with ``.node`` and
    ``.pods`` (the pods placed on that node).  ``keys`` restricts it to the
    gangs of interest; None aggregates every gang found."""
    coords: Dict[str, List[Topo]] = {}
    for ni in node_infos:
        topo = node_topo(ni.node)
        for pod in ni.pods:
            key = gang_key(pod)
            if key is None or (keys is not None and key not in keys):
                continue
            coords.setdefault(key, []).append(topo)
    return {k: aggregate_coords(v) for k, v in coords.items()}


def gang_keys(pods: Iterable[Any]) -> set:
    """The gang keys among ``pods``."""
    keys = {gang_key(p) for p in pods}
    keys.discard(None)
    return keys


class PlacedGangs:
    """The placed members of every gang, for one run of a wave or scan
    driver: those of ``assigned`` (pods with ``spec.node_name`` set) and
    every member committed since.  ``nodes`` are in node-table row order;
    a member on a node outside them counts with zero coordinates, as
    ``GangIndex.view_for`` counts a member on an unknown node.

    A driver asks for one batch's view after another (``view``, or
    ``rewrite`` for a pod table built before the view was known);
    ``views`` keeps each view given out and ``view_s`` the host time in
    views, rewrites and commits."""

    def __init__(self, nodes: Sequence[Any], assigned: Iterable[Any] = ()):
        self.views: List[Dict[str, GangAgg]] = []
        self.view_s = 0.0
        self._topo = [node_topo(n) for n in nodes]
        row = {n.metadata.name: i for i, n in enumerate(nodes)}
        self._members: Dict[str, List[Topo]] = {}
        for pod in assigned:
            key = gang_key(pod)
            if key is not None:
                i = row.get(pod.spec.node_name)
                self._members.setdefault(key, []).append(
                    _NO_TOPO if i is None else self._topo[i])

    @classmethod
    def for_pods(cls, pods: Sequence[Any], nodes: Sequence[Any],
                 assigned: Iterable[Any] = ()) -> Optional["PlacedGangs"]:
        """The tracker of a run over ``pods``, or None when no pod of it
        belongs to a gang (their gang columns then stay zero)."""
        if not any(gang_key(p) is not None for p in pods):
            return None
        return cls(nodes, assigned)

    def commit(self, pods: Sequence[Any], rows: Sequence[int]) -> None:
        """The pods of ``pods`` placed on node row ``rows`` (row >= 0)."""
        t0 = time.monotonic()
        for pod, r in zip(pods, rows):
            if r >= 0:
                key = gang_key(pod)
                if key is not None:
                    self._members.setdefault(key, []).append(self._topo[r])
        self.view_s += time.monotonic() - t0

    def view(self, pods: Sequence[Any]) -> Dict[str, GangAgg]:
        """The view of the gangs of the batch ``pods``."""
        t0 = time.monotonic()
        view = self._view(pods)
        self.view_s += time.monotonic() - t0
        return view

    def rewrite(self, pod_table: Any, pods: Sequence[Any]) -> Any:
        """``pod_table`` (built for ``pods``) with the gang columns of
        their view."""
        t0 = time.monotonic()
        table = with_gang_view(pod_table, pods, self._view(pods))
        self.view_s += time.monotonic() - t0
        return table

    def _view(self, pods: Sequence[Any]) -> Dict[str, GangAgg]:
        view = self.view_for(gang_keys(pods))
        self.views.append(view)
        return view

    def view_for(self, keys: Iterable[str]) -> Dict[str, GangAgg]:
        """Aggregates of the gangs ``keys`` that have placed members."""
        out: Dict[str, GangAgg] = {}
        for key in keys:
            coords = self._members.get(key)
            if coords:
                out[key] = aggregate_coords(coords)
        return out


class GangIndex:
    """Incremental placed-gang-member index, informer-wired like the
    ConstraintIndex: Pod events maintain gang membership (bound members
    only), Node events the topology map.  All reads and writes under one
    lock; the handlers run on informer threads and touch no tensor."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        #: gang key → member uid → node name (BOUND members only)
        self._members: Dict[str, Dict[str, str]] = {}
        self._pod_gang: Dict[str, str] = {}  # uid → gang key
        self._node_topo: Dict[str, Topo] = {}

    def wire(self, informer_factory: Any) -> None:
        from minisched_tpu_torch.controlplane.informer import (
            ResourceEventHandlers,
        )

        informer_factory.informer_for("Pod").add_event_handlers(
            ResourceEventHandlers(on_batch=self._pod_batch))
        informer_factory.informer_for("Node").add_event_handlers(
            ResourceEventHandlers(
                on_add=self._node_changed,
                on_update=lambda old, new: self._node_changed(new),
                on_delete=self._node_gone,
            ))

    # -- event handlers ----------------------------------------------------
    def _pod_batch(self, events: List[Any]) -> None:
        from minisched_tpu_torch.controlplane.store import EventType

        with self._mu:
            for ev in events:
                pod = ev.obj
                key = gang_key(pod)
                if key is None:
                    continue
                uid = pod.metadata.uid
                self._drop_locked(uid)  # gone, unbound, or moved
                if ev.type != EventType.DELETED and pod.spec.node_name:
                    self._members.setdefault(key, {})[uid] = (
                        pod.spec.node_name)
                    self._pod_gang[uid] = key

    def _drop_locked(self, uid: str) -> None:
        key = self._pod_gang.pop(uid, None)
        if key is not None:
            bucket = self._members.get(key)
            if bucket is not None:
                bucket.pop(uid, None)
                if not bucket:
                    del self._members[key]

    def _node_changed(self, node: Any) -> None:
        with self._mu:
            self._node_topo[node.metadata.name] = node_topo(node)

    def _node_gone(self, node: Any) -> None:
        with self._mu:
            self._node_topo.pop(node.metadata.name, None)

    # -- reads -------------------------------------------------------------
    def placed_count(self, key: str, exclude: Iterable[str] = ()) -> int:
        """How many members of ``key`` are bound (uid-distinct), minus any
        in ``exclude`` — Coscheduling counts them toward admission."""
        ex = set(exclude)
        with self._mu:
            bucket = self._members.get(key)
            if not bucket:
                return 0
            return sum(1 for uid in bucket if uid not in ex)

    def view_for(self, keys: Iterable[str],
                 extra_members: Iterable[Tuple[str, str, str]] = ()
                 ) -> Dict[str, GangAgg]:
        """Aggregates for the given gang keys.  ``extra_members`` are
        (gang key, uid, node name) triples folded on top — the engine's
        assume cache (placed, bind not yet seen); uids already in the
        index are skipped (no double count)."""
        want = set(keys)
        coords: Dict[str, List[Topo]] = {}
        with self._mu:
            for key in want:
                bucket = self._members.get(key)
                if bucket:
                    coords[key] = [self._node_topo.get(node, _NO_TOPO)
                                   for node in bucket.values()]
            for key, uid, node in extra_members:
                if key not in want:
                    continue
                bucket = self._members.get(key)
                if bucket is not None and uid in bucket:
                    continue
                coords.setdefault(key, []).append(
                    self._node_topo.get(node, _NO_TOPO))
        return {k: agg for k, v in coords.items()
                if (agg := aggregate_coords(v)) is not None}
