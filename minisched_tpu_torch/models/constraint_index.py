"""Incremental assigned-pod aggregates for the cross-pod constraint planes.

A copy of ``minisched_tpu/models/constraint_index.py``.  Without an
index, ``build_constraint_tables`` derives every assigned-pod plane (combo
``here``/``global``/domain sums, the reverse anti-affinity terms, the
symmetric preferred weights, the volume mount and family state) by
walking every assigned pod, once per wave or scan chunk.
``ConstraintIndex`` keeps the same aggregates as pods come and go, in
O(changes), and ``build_constraint_tables(..., index=...)`` assembles the
dense planes from it in O(nonzero + planes).

A one-shot driver feeds the index through its direct methods
(``add_pod``, ``update_pod``, ``delete_pod``, ``update_node``,
``claim_changed``, ``volume_changed``), with node, PVC and PV lookups
given to the constructor.  The live engine calls ``wire`` instead, which
registers the index on the informers (the batch pod handler and the node,
PVC and PV handlers) and points the lookups at the informer caches.

One difference: the JAX index keys pods by ``metadata.uid``.  The port's
objects default ``uid`` to ``""`` (names are the identity), so this index
keys a pod by its uid when set and by ``namespace/name`` otherwise
(``pod_key``); pods keyed as in JAX would collapse into one record.

Self-healing derivations keep label churn right without rescans:

* combo domain sums are derived at assemble time from the ``here`` counts
  plus the current node labels;
* reverse anti-affinity and preferred-term owner domains are re-resolved
  when the owner node's labels change (``update_node``);
* a claim binding or a PV change re-resolves the volume records of the
  pods that mount it (``claim_changed``, ``volume_changed``).

Registry ids are index-private; ``build_constraint_tables`` keeps its
wave-local combo ids and queries by structural key.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from minisched_tpu_torch.models.constraints import (
    _matches,
    _selector_sig,
    _term_namespaces,
    pod_key,
    rev_pref_terms_of,
)
from minisched_tpu_torch.plugins.volumelimits import volume_family

#: combo key: (namespaces, selector signature, topology key)
ComboKey = Tuple[Tuple[str, ...], Tuple, str]
#: reverse anti-affinity term key: combo key + the owner's topo value
ExKey = Tuple[Tuple[str, ...], Tuple, str, str]
#: volume counting key: ("pv", volume_name) | ("pvc", claim_key) |
#: ("miss", pod key, slot)
VolKey = Tuple

Lookup = Callable[[str], Any]


class _SigMeta:
    __slots__ = ("namespace", "labels")

    def __init__(self, namespace: str, labels: Dict[str, str]):
        self.namespace = namespace
        self.labels = labels


class _SigRep:
    """Stands in for every pod sharing a (namespace, labels) signature in
    selector matching, which reads only those: holding a real pod here
    would keep it alive past its removal."""

    __slots__ = ("metadata",)

    def __init__(self, namespace: str, labels: Dict[str, str]):
        self.metadata = _SigMeta(namespace, labels)


class _PodRecord:
    """What one assigned pod with pod (anti-)affinity or mounts
    contributed beyond its node and signature: enough to subtract it again
    without re-matching (labels may have changed since).  A pod without
    either has no record (``ConstraintIndex._node_of`` and ``_sig_by_key``
    hold what it adds): most pods are such, and an object less a pod keeps
    the collector's work down at 100,000 pods."""

    __slots__ = ("ex_keys", "vols", "claims", "has_anti", "rev")

    def __init__(self) -> None:
        self.ex_keys: Sequence[ExKey] = ()
        #: (VolKey, family, rw) per mount, one per spec.volumes slot
        self.vols: Sequence[Tuple[VolKey, int, bool]] = ()
        #: referenced claim keys (for PVC/PV re-resolution)
        self.claims: Sequence[str] = ()
        #: the pod carries node-label-sensitive terms (required
        #: anti-affinity owner domains, symmetric preferred contributions)
        self.has_anti = False
        #: symmetric preferred contributions: (ComboKey, owner topo value,
        #: signed weight) per scoring term of this assigned pod
        self.rev: Sequence[Tuple[ComboKey, str, int]] = ()


class ConstraintIndex:
    """The assigned-pod aggregates.  ``node_get``, ``pvc_get`` and
    ``pv_get`` look up a Node by name, a claim by ``namespace/name`` and
    a PersistentVolume by name (None when absent); without them nodes
    carry no labels and every claim is missing."""

    def __init__(self, node_get: Optional[Lookup] = None,
                 pvc_get: Optional[Lookup] = None,
                 pv_get: Optional[Lookup] = None) -> None:
        # reentrant: a caller may hold it across a whole table assembly
        # (``lock``) while the read methods take it again
        self._mu = threading.RLock()
        self._node_get = node_get
        self._pvc_lister = pvc_get
        self._pv_lister = pv_get
        # persistent combo registry: key → id; per id the match group and
        # the per-node assigned-match counts
        self._combo_ids: Dict[ComboKey, int] = {}
        self._combo_sel: List[Tuple[Tuple[str, ...], Any]] = []
        self._combo_here: List[Dict[str, int]] = []
        # distinct (namespaces, selector-sig) match groups shared across
        # topology keys: group key → combo ids in the group
        self._group_ids: Dict[Tuple, List[int]] = {}
        # label-signature tables, refcounted, ids recycled (populations
        # with a unique label per pod would otherwise grow them forever)
        self._sig_ids: Dict[Tuple, int] = {}  # (ns, labels items) → sig id
        self._sig_rep: List[Optional[Any]] = []  # sig id → _SigRep | None
        self._sig_combos: List[List[int]] = []  # sig id → matching combos
        self._sig_nodes: List[Dict[str, int]] = []  # sig id → node → count
        self._sig_count: List[int] = []  # sig id → live records
        self._sig_key: List[Optional[Tuple]] = []  # sig id → _sig_ids key
        self._sig_free: List[int] = []  # recycled sig ids
        # reverse anti-affinity: key → per-owner-node count
        self._ex_terms: Dict[ExKey, Dict[str, int]] = {}
        self._ex_sel: Dict[ExKey, Any] = {}
        # symmetric preferred scoring: combo key → owner topo value →
        # Σ signed weight of assigned pods' terms owning that domain
        self._rev_pref: Dict[ComboKey, Dict[str, int]] = {}
        self._rev_sel: Dict[ComboKey, Any] = {}
        # volume state: node → VolKey → [mounts, rw_mounts, family]
        self._node_vols: Dict[str, Dict[VolKey, List[int]]] = {}
        # claim key → keys of assigned pods mounting it
        self._claim_pods: Dict[str, Set[str]] = {}
        # bound volume name → claim keys referencing it (PV events)
        self._vol_claims: Dict[str, Set[str]] = {}
        #: pod key → pod object, for the pods a node or claim change
        #: re-resolves (those with label-sensitive terms or mounts)
        self._pods: Dict[str, Any] = {}
        #: every held pod: its node and its label-signature id (combo
        #: membership lives at the signature level, so matching runs
        #: against signatures, not pods)
        self._node_of: Dict[str, str] = {}
        self._sig_by_key: Dict[str, int] = {}
        #: the held pods with affinity terms or mounts
        self._records: Dict[str, _PodRecord] = {}
        # node → keys of pods with node-label-sensitive terms on it
        self._node_anti: Dict[str, Set[str]] = {}

    # -- wiring ------------------------------------------------------------
    def wire(self, informer_factory: Any) -> None:
        """Register the handlers.  MUST run BEFORE the NodeInfo cache's
        (``engine/cache.py``): the engine prunes its assume cache against
        the NodeInfo cache, so an index behind it could drop a
        just-confirmed bind from one wave's planes.  An index ahead is
        harmless (the assumed fold checks index membership first)."""
        from minisched_tpu_torch.controlplane.informer import (
            ResourceEventHandlers,
        )

        pvc_inf = informer_factory.informer_for("PersistentVolumeClaim")
        pv_inf = informer_factory.informer_for("PersistentVolume")
        node_inf = informer_factory.informer_for("Node")
        # informer cache keys are "namespace/name"; cluster-scoped kinds
        # (Node, PV) key as "/<name>"
        self._pvc_lister = pvc_inf.get
        self._pv_lister = lambda name: pv_inf.get(f"/{name}")
        self._node_get = lambda name: node_inf.get(f"/{name}")
        informer_factory.informer_for("Pod").add_event_handlers(
            ResourceEventHandlers(on_batch=self._pod_batch))
        node_inf.add_event_handlers(ResourceEventHandlers(
            # ADD matters too: informers dispatch on separate threads, so
            # a pod's event can beat its node's
            on_add=lambda node: self.update_node(None, node),
            on_update=self.update_node))
        pvc_inf.add_event_handlers(ResourceEventHandlers(
            on_add=lambda pvc: self.claim_changed(pvc.metadata.key),
            on_update=lambda old, new: self.claim_changed(new.metadata.key),
            on_delete=lambda pvc: self.claim_changed(pvc.metadata.key)))
        pv_inf.add_event_handlers(ResourceEventHandlers(
            on_add=lambda pv: self.volume_changed(pv.metadata.name),
            on_update=lambda old, new: self.volume_changed(new.metadata.name),
            on_delete=lambda pv: self.volume_changed(pv.metadata.name)))

    def _pod_batch(self, events: List[Any]) -> None:
        """One informer batch under one lock hold; pending pods never
        touch the planes."""
        from minisched_tpu_torch.controlplane.store import EventType

        with self._mu:
            for ev in events:
                pod = ev.obj
                if not pod.spec.node_name:
                    continue
                if ev.type != EventType.ADDED:
                    self._remove(pod_key(pod))
                if ev.type != EventType.DELETED:
                    self._add(pod)

    # -- changes -----------------------------------------------------------
    def add_pod(self, pod: Any) -> None:
        """An assigned pod (``spec.node_name`` set); a pod already held is
        not counted twice."""
        with self._mu:
            self._add(pod)

    def add_pods(self, pods: Any) -> None:
        with self._mu:
            for pod in pods:
                self._add(pod)

    def update_pod(self, old: Any, new: Any) -> None:
        with self._mu:
            self._remove(pod_key(new))
            self._add(new)

    def delete_pod(self, pod: Any) -> None:
        with self._mu:
            self._remove(pod_key(pod))

    def update_node(self, old: Any, new: Any) -> None:
        """A node's labels feed the owner domains of the terms of the pods
        on it: re-resolve those.  (Combo domain sums derive from the
        current labels at assemble time.)"""
        if old is not None and old.metadata.labels == new.metadata.labels:
            return
        with self._mu:
            for key in list(self._node_anti.get(new.metadata.name, ())):
                pod = self._pods.get(key)
                if pod is not None:
                    self._remove(key)
                    self._add(pod)

    def claim_changed(self, claim_key: str) -> None:
        """A PVC appeared, bound or changed: the counting identity and
        family of every mount of it may have moved."""
        with self._mu:
            self._reresolve_claims({claim_key})

    def volume_changed(self, pv_name: str) -> None:
        with self._mu:
            refs = self._vol_claims.get(pv_name)
            if refs is None:
                return
            # opportunistic sweep of claims no pod mounts anymore
            dead = {ck for ck in refs if not self._claim_pods.get(ck)}
            refs -= dead
            if not refs:
                del self._vol_claims[pv_name]
                return
            self._reresolve_claims(set(refs))

    def _reresolve_claims(self, claim_keys: Set[str]) -> None:
        keys: Set[str] = set()
        for ck in claim_keys:
            keys |= self._claim_pods.get(ck, set())
        for key in keys:
            pod = self._pods.get(key)
            if pod is not None:
                self._remove(key)
                self._add(pod)

    # -- contribution maintenance -------------------------------------------
    def _lookup_pvc(self, key: str) -> Any:
        return self._pvc_lister(key) if self._pvc_lister is not None else None

    def _lookup_pv(self, name: str) -> Any:
        return self._pv_lister(name) if self._pv_lister is not None else None

    def _node_labels(self, node_name: str) -> Dict[str, str]:
        node = self._node_get(node_name) if self._node_get else None
        return node.metadata.labels if node is not None else {}

    def _contribution(self, pod: Any, key: str) -> Optional[_PodRecord]:
        """The pod's record against the current registry and lookups (None
        without affinity or mounts): the one place the contribution math
        lives."""
        spec = pod.spec
        if spec.affinity is None and not spec.volumes:
            return None
        rec = _PodRecord()
        if spec.affinity is not None:
            self._affinity_terms(pod, spec.affinity, rec)
        if spec.volumes:
            self._mounts(pod, key, rec)
        return rec

    def _affinity_terms(self, pod: Any, aff: Any, rec: _PodRecord) -> None:
        """The pod's required anti-affinity terms and symmetric scoring
        terms, with the owner node's current labels for their domains."""
        if (aff.pod_anti_affinity is not None
                and aff.pod_anti_affinity.required):
            rec.has_anti = True
            ex_keys = []
            owner_labels = self._node_labels(pod.spec.node_name)
            for term in aff.pod_anti_affinity.required:
                owner_val = owner_labels.get(term.topology_key)
                if owner_val is None:
                    continue  # owner's node lacks the key: can't be violated
                nss = _term_namespaces(term, pod.metadata.namespace)
                ex = (nss, _selector_sig(term.label_selector),
                      term.topology_key, owner_val)
                self._ex_sel.setdefault(ex, term.label_selector)
                ex_keys.append(ex)
            rec.ex_keys = ex_keys
        owner_labels = None
        rev = []
        for nss, sel, topo, w in rev_pref_terms_of(pod):
            # label-sensitive either way: a label change can grant or
            # revoke the owner's topology key
            rec.has_anti = True
            if owner_labels is None:
                owner_labels = self._node_labels(pod.spec.node_name)
            owner_val = owner_labels.get(topo)
            if owner_val is None:
                continue  # owner's node lacks the key: no domain to score
            ck: ComboKey = (nss, _selector_sig(sel), topo)
            self._rev_sel.setdefault(ck, sel)
            rev.append((ck, owner_val, w))
        if rev:
            rec.rev = rev

    def _mounts(self, pod: Any, key: str, rec: _PodRecord) -> None:
        """Each mount's counting key, family and writability, from the
        current claims and volumes."""
        rec.vols, rec.claims = [], []
        for j, vol in enumerate(pod.spec.volumes):
            claim_key = f"{pod.metadata.namespace}/{vol}"
            rec.claims.append(claim_key)
            pvc = self._lookup_pvc(claim_key)
            if pvc is None:
                # no identity: each unresolvable mount counts by itself
                rec.vols.append((("miss", key, j), 0, False))
                continue
            fam = volume_family(pvc, _LazyPVMap(self._lookup_pv))
            if pvc.spec.volume_name:
                vk: VolKey = ("pv", pvc.spec.volume_name)
                rw = not pvc.spec.read_only
            else:
                vk = ("pvc", claim_key)
                rw = False  # unbound: no PV identity to conflict on
            rec.vols.append((vk, fam, rw))

    def _sig_of(self, pod: Any) -> int:
        """The pod's label-signature id, created (and combo-matched) on
        first sight; the caller (``_add``) owns the refcount."""
        key = (pod.metadata.namespace,
               tuple(sorted(pod.metadata.labels.items())))
        sid = self._sig_ids.get(key)
        if sid is None:
            rep = _SigRep(pod.metadata.namespace, dict(pod.metadata.labels))
            cids: List[int] = []
            for (nss, _sig), ids in self._group_ids.items():
                sel = self._combo_sel[ids[0]][1]
                if _matches(sel, nss, rep):
                    cids.extend(ids)
            if self._sig_free:
                sid = self._sig_free.pop()
                self._sig_rep[sid] = rep
                self._sig_combos[sid] = cids
                self._sig_nodes[sid] = {}
                self._sig_count[sid] = 0
                self._sig_key[sid] = key
            else:
                sid = len(self._sig_rep)
                self._sig_rep.append(rep)
                self._sig_combos.append(cids)
                self._sig_nodes.append({})
                self._sig_count.append(0)
                self._sig_key.append(key)
            self._sig_ids[key] = sid
        return sid

    def _sig_release(self, sid: int) -> None:
        """Drop one reference; free and recycle the id at zero."""
        self._sig_count[sid] -= 1
        if self._sig_count[sid] <= 0:
            key = self._sig_key[sid]
            if key is not None:
                self._sig_ids.pop(key, None)
            self._sig_rep[sid] = None
            self._sig_combos[sid] = []
            self._sig_nodes[sid] = {}
            self._sig_key[sid] = None
            self._sig_free.append(sid)

    def _add(self, pod: Any) -> None:
        key = pod_key(pod)
        if key in self._node_of:
            return  # already held
        rec = self._contribution(pod, key)
        # the signature last: it creates a refcount-0 entry on first sight,
        # which only ``_remove`` releases, so nothing above may raise after
        sig = self._sig_of(pod)
        node = pod.spec.node_name
        self._node_of[key] = node
        self._sig_by_key[key] = sig
        for cid in self._sig_combos[sig]:
            here = self._combo_here[cid]
            here[node] = here.get(node, 0) + 1
        sn = self._sig_nodes[sig]
        sn[node] = sn.get(node, 0) + 1
        self._sig_count[sig] += 1
        if rec is None:
            return
        self._records[key] = rec
        if rec.has_anti or rec.claims:  # re-resolved on node/claim changes
            self._pods[key] = pod
        for ex in rec.ex_keys:
            owners = self._ex_terms.setdefault(ex, {})
            owners[node] = owners.get(node, 0) + 1
        for ck, owner_val, w in rec.rev:
            vals = self._rev_pref.setdefault(ck, {})
            vals[owner_val] = vals.get(owner_val, 0) + w
        if rec.vols:
            nv = self._node_vols.setdefault(node, {})
            for vk, fam, rw in rec.vols:
                ent = nv.get(vk)
                if ent is None:
                    ent = nv[vk] = [0, 0, fam]
                ent[0] += 1
                ent[1] += 1 if rw else 0
                ent[2] = fam
        for ck in rec.claims:
            self._claim_pods.setdefault(ck, set()).add(key)
            pvc = self._lookup_pvc(ck)
            if pvc is not None and pvc.spec.volume_name:
                self._vol_claims.setdefault(pvc.spec.volume_name,
                                            set()).add(ck)
        if rec.has_anti:
            self._node_anti.setdefault(node, set()).add(key)

    def _remove(self, key: str) -> None:
        node = self._node_of.pop(key, None)
        if node is None:
            return
        sig = self._sig_by_key.pop(key)
        for cid in self._sig_combos[sig]:
            here = self._combo_here[cid]
            n = here.get(node, 0) - 1
            if n <= 0:
                here.pop(node, None)
            else:
                here[node] = n
        sn = self._sig_nodes[sig]
        left = sn.get(node, 0) - 1
        if left <= 0:
            sn.pop(node, None)
        else:
            sn[node] = left
        self._sig_release(sig)
        rec = self._records.pop(key, None)
        if rec is None:
            return
        self._pods.pop(key, None)
        for ex in rec.ex_keys:
            owners = self._ex_terms.get(ex)
            if owners is not None:
                n = owners.get(node, 0) - 1
                if n <= 0:
                    owners.pop(node, None)
                else:
                    owners[node] = n
        for ck, owner_val, w in rec.rev:
            vals = self._rev_pref.get(ck)
            if vals is not None:
                left = vals.get(owner_val, 0) - w
                if left == 0:
                    vals.pop(owner_val, None)
                    if not vals:
                        self._rev_pref.pop(ck, None)
                else:
                    vals[owner_val] = left
        nv = self._node_vols.get(node)
        if nv is not None:
            for vk, _fam, rw in rec.vols:
                ent = nv.get(vk)
                if ent is None:
                    continue
                ent[0] -= 1
                ent[1] -= 1 if rw else 0
                if ent[0] <= 0:
                    del nv[vk]
        for ck in rec.claims:
            pods = self._claim_pods.get(ck)
            if pods is not None:
                pods.discard(key)
                if not pods:
                    # prune the claim's reverse maps with its last pod
                    del self._claim_pods[ck]
                    pvc = self._lookup_pvc(ck)
                    if pvc is not None and pvc.spec.volume_name:
                        refs = self._vol_claims.get(pvc.spec.volume_name)
                        if refs is not None:
                            refs.discard(ck)
                            if not refs:
                                del self._vol_claims[pvc.spec.volume_name]
        if rec.has_anti:
            anti = self._node_anti.get(node)
            if anti is not None:
                anti.discard(key)

    # -- reads (table assembly) ----------------------------------------------
    def combo_aggregate(self, nss: Tuple[str, ...], sel: Any,
                        topo: str) -> Dict[str, int]:
        """Per-node assigned-match counts of one combo (a copy),
        registering and backfilling it over the held pods if unseen."""
        key = (nss, _selector_sig(sel), topo)
        with self._mu:
            cid = self._combo_ids.get(key)
            if cid is None:
                cid = self._register_combo(key, nss, sel)
            return dict(self._combo_here[cid])

    def _register_combo(self, key: ComboKey, nss: Tuple[str, ...],
                        sel: Any) -> int:
        cid = len(self._combo_sel)
        self._combo_ids[key] = cid
        self._combo_sel.append((nss, sel))
        here: Dict[str, int] = {}
        gkey = (nss, key[1])
        group = self._group_ids.get(gkey)
        if group:
            # the same (namespaces, selector) under another topology key
            # matches the same pods: share the counts and the membership
            here.update(self._combo_here[group[0]])
            for cids in self._sig_combos:
                if group[0] in cids:
                    cids.append(cid)
            group.append(cid)
        else:
            # one backfill against the signatures, not the pods
            for sid, rep in enumerate(self._sig_rep):
                if rep is not None and _matches(sel, nss, rep):
                    self._sig_combos[sid].append(cid)
                    for node, cnt in self._sig_nodes[sid].items():
                        here[node] = here.get(node, 0) + cnt
            self._group_ids[gkey] = [cid]
        self._combo_here.append(here)
        return cid

    def lock(self):
        """The index's RLock: hold it across an assembly that must see one
        state of the index."""
        return self._mu

    def assigned_keys(self) -> Set[str]:
        """The keys of the held pods (``pod_key``: the uid when set)."""
        with self._mu:
            return set(self._node_of)

    def assigned_uids(self) -> Set[str]:
        """The uids of the held pods, as the engine's assume cache keys
        them (store objects always carry a uid, so a key is the uid)."""
        return self.assigned_keys()

    def ex_term_list(self) -> List[Tuple[ExKey, Any, Set[str]]]:
        """Live reverse anti-affinity terms: (key, selector, owner nodes)."""
        with self._mu:
            return [(key, self._ex_sel[key], set(owners))
                    for key, owners in self._ex_terms.items() if owners]

    def rev_pref_list(self) -> List[Tuple[ComboKey, Any, Dict[str, int]]]:
        """Live symmetric preferred contributions: (combo key, selector,
        owner topo value → Σ signed weight)."""
        with self._mu:
            return [(ck, self._rev_sel[ck], dict(vals))
                    for ck, vals in self._rev_pref.items() if vals]

    def node_vol_state(self) -> Dict[str, Dict[VolKey, List[int]]]:
        """node → VolKey → [mounts, rw_mounts, family] (a copy)."""
        with self._mu:
            return {node: {vk: list(ent) for vk, ent in nv.items()}
                    for node, nv in self._node_vols.items() if nv}


class _LazyPVMap:
    """A dict-shaped view of the PV lookup: ``volume_family`` only calls
    ``.get(name)``."""

    def __init__(self, lookup: Lookup):
        self._lookup = lookup

    def get(self, name: str, default: Any = None) -> Any:
        out = self._lookup(name)
        return out if out is not None else default
