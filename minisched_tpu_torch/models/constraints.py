"""Cross-pod and volume constraint tables: the pod ↔ pod × node coupling.

Counterpart of ``minisched_tpu/models/constraints.py``, built the same way
on the host: every distinct (namespaces, label selector, topology key)
triple in the wave's constraints becomes a combo; assigned pods are
matched against each combo once and their per-node domain sums land in
dense ``combo_*[C, N]`` planes; assigned pods' required anti-affinity
becomes a ``pod_matches_ex[P, T]`` × ``ex_domain[T, N]`` pair; the volume
planes come from the claims and PersistentVolumes.  The columns are the
JAX package's, field for field (dtypes, capacities, padding), and go to
the device as one pinned buffer and one non-blocking copy
(``models/tables.HostTable``).

With ``index=`` (``models/constraint_index.ConstraintIndex``) the
assigned-pod planes come from the index's aggregates instead of a walk of
every assigned pod, and ``extra_assigned`` pods (placed, not yet in the
index) fold in through the walk's own per-pod logic, as in the JAX
module.  Not here: the packed elision options of ``device=False``
(``elide_zeros``, ``elide_groups``), which keep the number of distinct
compiled shapes of the JAX program small; the port compiles nothing per
shape and always builds the full tables.

``ConstraintTables.in_use`` is the port's own: which constraint slots of
the wave's pods carry anything, read from the host columns.  The batch
plugins skip the slots no pod uses, where the JAX kernels branch on
device values (``lax.cond``) or compute them anyway; a skipped slot is
one whose result is all-pass or zero, so the outputs are the same and no
round waits on the card to decide.  A sequential scan creates state as
it commits pods; ``scan_use`` widens the flags to what the scanned pods
can create.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from minisched_tpu_torch import resolve_device
from minisched_tpu_torch.models.tables import HostTable, pad_to
from minisched_tpu_torch.plugins.volumebinding import claim_node_mask
from minisched_tpu_torch.plugins.volumelimits import FAMILIES, volume_family
from minisched_tpu_torch.plugins.volumezone import pv_zone_ok

MAX_VOLUMES = 4  # PVC references per pod
MAX_TSC = 4  # topology spread constraints per pod
MAX_PA = 4  # required pod-affinity terms per pod
MAX_PAN = 4  # required pod-anti-affinity terms per pod
MAX_PPA = 8  # preferred (anti-)affinity terms per pod, both signs pooled

#: topology keys of spread constraints have at most this many distinct
#: values (zone-like) or one per node (hostname-like)
MAX_DOMAINS = 64

TS_DO_NOT_SCHEDULE = 0
TS_SCHEDULE_ANYWAY = 1

#: capacity quantum of the combo, ex-term, claim and volume axes
CAP_QUANTUM = 32

#: the weight at which assigned pods' REQUIRED affinity terms score toward
#: an incoming pod that matches them (symmetric hard-affinity scoring)
HARD_POD_AFFINITY_WEIGHT = 1


@dataclass(frozen=True)
class ConstraintUse:
    """Which constraint slots any pod row of the wave uses (host values)."""

    ts_hard: Tuple[int, ...] = ()  # spread slots with a DoNotSchedule row
    ts_soft: Tuple[int, ...] = ()  # spread slots with a ScheduleAnyway row
    pa: int = 0  # required affinity slots in use (max pa_n)
    pan: int = 0  # required anti-affinity slots in use (max pan_n)
    ppa: int = 0  # preferred term slots in use (max ppa_n)
    vols: int = 0  # mount slots in use (max pod_n_vols)
    rev: bool = False  # some assigned pod's term scores (rev_weight != 0)
    ex: bool = False  # some assigned pod's anti-affinity term can bind
    #: a pod committed earlier in a scan can exclude later pods
    #: (combo_excl != 0; only the scan sets it, ``scan_use``)
    excl: bool = False


def constraint_use(cols: Dict[str, np.ndarray]) -> ConstraintUse:
    """The slots in use, from the host columns of one wave's tables."""
    slots = np.arange(cols["ts_combo"].shape[1])[None, :]
    ts_live = slots < cols["ts_n"][:, None]
    hard = (ts_live & (cols["ts_mode"] == TS_DO_NOT_SCHEDULE)).any(axis=0)
    soft = (ts_live & (cols["ts_mode"] != TS_DO_NOT_SCHEDULE)).any(axis=0)

    def most(col: str) -> int:
        return int(cols[col].max(initial=0))

    return ConstraintUse(
        ts_hard=tuple(int(c) for c in np.flatnonzero(hard)),
        ts_soft=tuple(int(c) for c in np.flatnonzero(soft)),
        pa=most("pa_n"), pan=most("pan_n"), ppa=most("ppa_n"),
        vols=most("pod_n_vols"),
        rev=bool(cols["rev_weight"].any()),
        ex=bool(cols["pod_matches_ex"].any() and cols["ex_domain"].any()),
    )


def scan_use(use: ConstraintUse) -> ConstraintUse:
    """The flags of a sequential scan over the pods ``use`` describes.

    A committed pod adds its preferred and required affinity terms to
    ``rev_weight`` and its required anti-affinity terms to ``combo_excl``
    (``ops/sequential.py``), so the symmetric score is live once any
    scanned pod has such a term, and the in-scan exclusion once any has a
    required anti-affinity term.  One-row and one-block slices keep these
    chunk-wide flags: a superset of the used slots gives the same result,
    and every step takes the same host-known branches."""
    return replace(use, rev=use.rev or use.pa > 0 or use.ppa > 0,
                   excl=use.pan > 0)


@dataclass
class ConstraintTables:
    """Cross-pod and volume coupling state for one wave; the field
    comments of ``minisched_tpu.models.constraints.ConstraintTables``
    apply."""

    combo_dsum: Any  # i32[C, N] matching assigned pods in n's topo domain
    combo_haskey: Any  # bool[C, N] node carries the combo's topology key
    combo_global: Any  # i32[C] matching assigned pods cluster-wide
    combo_here: Any  # i32[C, N] matching assigned pods ON node n
    combo_key: Any  # i32[C] index into the topology-key axis
    topo_domain: Any  # i32[K, N] dense domain id; == D when keyless
    topo_onehot: Any  # bool[K, D, N] node ∈ domain d of key k (zone-like)
    topo_unique: Any  # bool[K] key is unique-per-node (hostname-like)
    ts_combo: Any  # i32[P, MAX_TSC]
    ts_skew: Any  # i32[P, MAX_TSC] max skew
    ts_mode: Any  # i32[P, MAX_TSC] 0=DoNotSchedule 1=ScheduleAnyway
    ts_n: Any  # i32[P]
    pa_combo: Any  # i32[P, MAX_PA]
    pa_self: Any  # bool[P, MAX_PA] pod matches its own term selector
    pa_n: Any  # i32[P]
    pan_combo: Any  # i32[P, MAX_PAN]
    pan_n: Any  # i32[P]
    ppa_combo: Any  # i32[P, MAX_PPA]
    ppa_w: Any  # i32[P, MAX_PPA] (weight < 0 encodes anti-affinity)
    ppa_n: Any  # i32[P]
    ex_domain: Any  # bool[T, N] nodes in the owning pod's topo domain
    pod_matches_ex: Any  # bool[P, T] pending pod matches term selector
    rev_weight: Any  # i32[C, N] Σ signed term weights whose domain holds n
    pod_matches_combo: Any  # bool[P, C]
    combo_excl: Any  # bool[C, N] (all-False outside the scan)
    claim_mask: Any  # bool[C2, N] nodes OK for referenced claim c
    pod_claims: Any  # i32[P, MAX_VOLUMES] indices into claim_mask
    vol_ok: Any  # bool[P] every referenced PVC exists
    pod_n_vols: Any  # i32[P] volumes this pod mounts
    claim_zone_ok: Any  # bool[C2, N] bound PV's zone labels match node
    pod_vols_fam: Any  # i32[P, F] pod's distinct volumes per driver family
    node_vols_fam: Any  # i32[F, N] distinct assigned volumes per family
    claim_vol: Any  # i32[C2] volume row of claim c; -1 when unbound
    claim_cnt: Any  # i32[C2] counting row of claim c (always >= 0)
    claim_family: Any  # i32[C2] driver family of claim c
    claim_ro: Any  # bool[C2] the claim mounts its volume read-only
    pod_claim_valid: Any  # bool[P, MAX_VOLUMES] slot holds a real claim
    pod_missing: Any  # i32[P] mounts whose PVC doesn't exist (generic)
    vol_any: Any  # bool[Vd, N] some assigned pod on n mounts volume v
    vol_rw: Any  # bool[Vd, N] ... with a writable mount
    #: the port's own: which slots the wave uses (not a device column)
    in_use: ConstraintUse = ConstraintUse()


def rev_pref_terms_of(p: Any):
    """The (namespaces, selector, topology key, signed weight) stream of
    an ASSIGNED pod's scoring terms toward incoming pods: preferred
    affinity (+w), preferred anti-affinity (−w), required affinity
    (×HARD_POD_AFFINITY_WEIGHT)."""
    aff = p.spec.affinity
    if aff is None:
        return
    ns = p.metadata.namespace
    pa = aff.pod_affinity
    if pa is not None:
        for term in pa.required:
            yield (_term_namespaces(term, ns), term.label_selector,
                   term.topology_key, HARD_POD_AFFINITY_WEIGHT)
        for wt in pa.preferred:
            yield (_term_namespaces(wt.term, ns), wt.term.label_selector,
                   wt.term.topology_key, wt.weight)
    pan = aff.pod_anti_affinity
    if pan is not None:
        for wt in pan.preferred:
            yield (_term_namespaces(wt.term, ns), wt.term.label_selector,
                   wt.term.topology_key, -wt.weight)


def _selector_sig(sel: Any) -> Tuple:
    return (
        tuple(sorted(sel.match_labels.items())),
        tuple((r.key, r.operator, tuple(r.values))
              for r in sel.match_expressions),
    )


def _term_namespaces(term: Any, pod_ns: str) -> Tuple[str, ...]:
    return tuple(sorted(term.namespaces)) if term.namespaces else (pod_ns,)


class _ComboRegistry:
    def __init__(self) -> None:
        self.ids: Dict[Tuple, int] = {}
        self.combos: List[Tuple[Tuple[str, ...], Any, str]] = []

    def get(self, namespaces: Tuple[str, ...], sel: Any, topo: str) -> int:
        key = (namespaces, _selector_sig(sel), topo)
        if key not in self.ids:
            self.ids[key] = len(self.combos)
            self.combos.append((namespaces, sel, topo))
        return self.ids[key]


def _topo_key_axis(combos, nodes):
    """Dense domain encoding per distinct topology key: (key → index,
    topo_domain i32[K, N], topo_onehot bool[K, D, N], topo_unique bool[K],
    val_id i32[K, N], value → id dicts per key).  ``val_id[k, i]`` is node
    i's label-value id under key k, −1 when the node lacks the key.  A key
    with more than MAX_DOMAINS values must be unique per node."""
    N = len(nodes)
    keys = sorted({topo for (_, _, topo) in combos})
    key_ids = {k: i for i, k in enumerate(keys)}
    K = pad_to(max(len(keys), 1), 4)
    values: List[Dict[str, int]] = [{} for _ in range(K)]
    vals_per_node: List[List[Optional[int]]] = [[None] * N for _ in range(K)]
    for k, key in enumerate(keys):
        for i, node in enumerate(nodes):
            v = node.metadata.labels.get(key)
            if v is None:
                continue
            if v not in values[k]:
                values[k][v] = len(values[k])
            vals_per_node[k][i] = values[k][v]
    unique = np.zeros(K, bool)
    for k, key in enumerate(keys):
        n_domains = len(values[k])
        n_keyed = sum(1 for v in vals_per_node[k] if v is not None)
        unique[k] = n_domains == n_keyed and n_domains > 0
        if n_domains > MAX_DOMAINS and not unique[k]:
            raise ValueError(
                f"topology key {key!r}: {n_domains} domains exceed "
                f"MAX_DOMAINS={MAX_DOMAINS} and the key is not unique-per-node"
            )
    D = MAX_DOMAINS
    topo_domain = np.full((K, N), D, np.int32)
    topo_onehot = np.zeros((K, D, N), bool)
    val_id = np.full((K, N), -1, np.int32)
    for k in range(len(keys)):
        for i, dom in enumerate(vals_per_node[k]):
            if dom is None:
                continue
            val_id[k, i] = dom
            if unique[k]:
                topo_domain[k, i] = 0  # unused by the unique path; != D marks haskey
            else:
                topo_domain[k, i] = dom
                topo_onehot[k, dom, i] = True
    return key_ids, topo_domain, topo_onehot, unique, val_id, values


def pod_key(pod: Any) -> str:
    """A pod's identity in the index and in the walk's per-mount volume
    keys: its uid, or ``namespace/name`` when the uid is empty (the port's
    objects leave it empty)."""
    return pod.metadata.uid or f"{pod.metadata.namespace}/{pod.metadata.name}"


def _matches(sel: Any, namespaces: Tuple[str, ...], pod: Any) -> bool:
    return pod.metadata.namespace in namespaces and sel.matches(pod.metadata.labels)


def _sig_groups(pods: Sequence[Any]):
    """Group pods by their (namespace, labels) signature, on which
    selector matching depends alone: (representative pods, int32 group id
    per pod)."""
    group_of: Dict[Tuple, int] = {}
    reps: List[Any] = []
    ids = np.empty(len(pods), np.int32)
    for i, p in enumerate(pods):
        sig = (p.metadata.namespace, tuple(sorted(p.metadata.labels.items())))
        g = group_of.get(sig)
        if g is None:
            g = group_of[sig] = len(reps)
            reps.append(p)
        ids[i] = g
    return reps, ids


def _claim_zone_row(pvc: Any, pv_by_name: Dict, nodes: Sequence[Any],
                    zone_ok) -> List[bool]:
    """VolumeZone's per-node verdict for one claim: unbound claims pass
    everywhere, a dangling volume_name passes nowhere, bound claims defer
    to ``zone_ok``."""
    if not pvc.spec.volume_name:
        return [True] * len(nodes)
    pv = pv_by_name.get(pvc.spec.volume_name)
    if pv is None:
        return [False] * len(nodes)
    return [zone_ok(pv, n) for n in nodes]


def _pod_rows(pending_pods: Sequence[Any], reg: _ComboRegistry):
    """(pod index, {"ts", "pa", "pan", "ppa": entries}) for the pending
    pods that carry cross-pod constraints, registering their combos."""
    pod_rows: List[Tuple[int, Dict[str, List]]] = []
    for pi, pod in enumerate(pending_pods):
        aff = pod.spec.affinity
        if not pod.spec.topology_spread_constraints and (
            aff is None
            or (aff.pod_affinity is None and aff.pod_anti_affinity is None)
        ):
            continue
        row: Dict[str, List] = {"ts": [], "pa": [], "pan": [], "ppa": []}
        ns = pod.metadata.namespace
        for c in pod.spec.topology_spread_constraints:
            cid = reg.get((ns,), c.label_selector, c.topology_key)
            mode = (TS_DO_NOT_SCHEDULE if c.when_unsatisfiable == "DoNotSchedule"
                    else TS_SCHEDULE_ANYWAY)
            row["ts"].append((cid, c.max_skew, mode))
        if aff is not None and aff.pod_affinity is not None:
            for term in aff.pod_affinity.required:
                nss = _term_namespaces(term, ns)
                cid = reg.get(nss, term.label_selector, term.topology_key)
                row["pa"].append((cid, _matches(term.label_selector, nss, pod)))
            for wt in aff.pod_affinity.preferred:
                nss = _term_namespaces(wt.term, ns)
                cid = reg.get(nss, wt.term.label_selector, wt.term.topology_key)
                row["ppa"].append((cid, wt.weight))
        if aff is not None and aff.pod_anti_affinity is not None:
            for term in aff.pod_anti_affinity.required:
                nss = _term_namespaces(term, ns)
                row["pan"].append(
                    reg.get(nss, term.label_selector, term.topology_key))
            for wt in aff.pod_anti_affinity.preferred:
                nss = _term_namespaces(wt.term, ns)
                cid = reg.get(nss, wt.term.label_selector, wt.term.topology_key)
                row["ppa"].append((cid, -wt.weight))
        for kind, cap in (("ts", MAX_TSC), ("pa", MAX_PA), ("pan", MAX_PAN),
                          ("ppa", MAX_PPA)):
            if len(row[kind]) > cap:
                raise ValueError(
                    f"pod {pod.metadata.name}: >{cap} {kind} constraints")
        pod_rows.append((pi, row))
    return pod_rows


def constraint_columns(
    pending_pods: Sequence[Any],
    nodes: Sequence[Any],
    assigned_pods: Sequence[Any],
    pod_capacity: Optional[int] = None,
    node_capacity: Optional[int] = None,
    pvcs: Sequence[Any] = (),
    pvs: Sequence[Any] = (),
    scan_planes: bool = True,
    index: Any = None,
    extra_assigned: Sequence[Any] = (),
) -> Dict[str, np.ndarray]:
    """The host half of ``build_constraint_tables``: its numpy columns.

    ``nodes`` must be in the NodeTable's order.  ``assigned_pods`` are pods
    with ``spec.node_name`` set; pods on other nodes are ignored.
    ``scan_planes=False`` is the JAX package's wave mode:
    ``pod_matches_combo`` is filled only for the combos that assigned pods'
    scoring terms use.  ``index``: a ``ConstraintIndex`` holding the
    assigned pods (pass ``()`` as ``assigned_pods``); ``extra_assigned``:
    assigned pods it does not hold yet, folded in per pod."""
    P = pod_capacity or pad_to(len(pending_pods))
    N = node_capacity or pad_to(len(nodes))
    node_idx = {n.metadata.name: i for i, n in enumerate(nodes)}
    assigned = [p for p in assigned_pods if p.spec.node_name in node_idx]
    if index is not None:
        # pods on nodes outside this view are skipped, as above
        extra_assigned = [p for p in extra_assigned
                          if p.spec.node_name in node_idx]

    reg = _ComboRegistry()
    pod_rows = _pod_rows(pending_pods, reg)

    # --- symmetric preferred contributions (assigned pods' terms) ----------
    # cid → topology value → Σ signed weight; combos register here too
    rev_vals: Dict[int, Dict[str, int]] = {}

    def collect_rev(p: Any) -> None:
        labels = nodes[node_idx[p.spec.node_name]].metadata.labels
        for nss, sel, topo, w in rev_pref_terms_of(p):
            val = labels.get(topo)
            if val is None:
                continue  # owner's node lacks the key: no domain to score
            cid = reg.get(nss, sel, topo)
            vals = rev_vals.setdefault(cid, {})
            vals[val] = vals.get(val, 0) + w

    if index is not None:
        for (nss, _sig, topo), sel, vals in index.rev_pref_list():
            dst = rev_vals.setdefault(reg.get(nss, sel, topo), {})
            for val, w in vals.items():
                dst[val] = dst.get(val, 0) + w
    for p in (extra_assigned if index is not None else assigned):
        collect_rev(p)

    # --- combo matrices ----------------------------------------------------
    C = pad_to(max(len(reg.combos), 1), CAP_QUANTUM)
    combo_dsum = np.zeros((C, N), np.int32)
    combo_haskey = np.zeros((C, N), bool)
    combo_global = np.zeros(C, np.int32)
    combo_here = np.zeros((C, N), np.int32)
    combo_key = np.zeros(C, np.int32)
    key_ids, topo_domain_, topo_onehot_, topo_unique, val_id_, key_vals = (
        _topo_key_axis(reg.combos, nodes))
    K, D = topo_onehot_.shape[0], topo_onehot_.shape[1]
    topo_domain = np.full((K, N), D, np.int32)
    topo_domain[:, : topo_domain_.shape[1]] = topo_domain_
    topo_onehot = np.zeros((K, D, N), bool)
    topo_onehot[:, :, : topo_onehot_.shape[2]] = topo_onehot_
    pod_matches_combo = np.zeros((P, C), bool)
    combo_excl = np.zeros((C, N), bool)
    rev_weight = np.zeros((C, N), np.int32)
    match_combos = range(len(reg.combos)) if scan_planes else sorted(rev_vals)
    if match_combos:
        # combos sharing (namespaces, selector) match identically: each
        # distinct group once, against pod signatures
        p_reps, p_gid = _sig_groups(pending_pods)
        match_cache: Dict[Tuple, Any] = {}
        for cid in match_combos:
            nss, sel, _topo = reg.combos[cid]
            mkey = (nss, _selector_sig(sel))
            row = match_cache.get(mkey)
            if row is None:
                grp = np.fromiter((_matches(sel, nss, r) for r in p_reps),
                                  dtype=bool, count=len(p_reps))
                row = match_cache[mkey] = grp[p_gid]
            pod_matches_combo[: len(pending_pods), cid] = row
    n_real = len(nodes)
    # assigned pods by signature group: sig → {node: count}; only combos
    # read it, so a wave without combos skips the walk.  With an index
    # only the extra pods fold in here.
    fold = extra_assigned if index is not None else assigned
    a_reps, a_nodes = [], []
    if fold and reg.combos:
        a_reps, a_gid = _sig_groups(fold)
        a_nodes = [dict() for _ in a_reps]
        for g, p in zip(a_gid, fold):
            d = a_nodes[g]
            d[p.spec.node_name] = d.get(p.spec.node_name, 0) + 1
    for cid, (nss, sel, topo) in enumerate(reg.combos):
        k = key_ids[topo]
        combo_key[cid] = k
        domain_count: Dict[str, int] = {}
        here: Dict[str, int] = (index.combo_aggregate(nss, sel, topo)
                                if index is not None else {})
        for g, rep in enumerate(a_reps):
            if _matches(sel, nss, rep):
                for node, cnt in a_nodes[g].items():
                    here[node] = here.get(node, 0) + cnt
        total = 0
        for node, cnt in here.items():
            i = node_idx.get(node)
            if i is None:
                continue  # an index pod on a node outside this view
            total += cnt
            combo_here[cid, i] = cnt
            val = nodes[i].metadata.labels.get(topo)
            if val is not None:
                domain_count[val] = domain_count.get(val, 0) + cnt
        combo_global[cid] = total
        # haskey/dsum/rev rows as gathers through the node → value-id axis
        rv = rev_vals.get(cid)
        vid = val_id_[k, :n_real]
        has = vid >= 0
        combo_haskey[cid, :n_real] = has
        vals_k = key_vals[k]
        safe_vid = np.where(has, vid, 0)
        if domain_count:
            cnt_by_vid = np.zeros(max(len(vals_k), 1), np.int32)
            for val, c in domain_count.items():
                vi = vals_k.get(val)
                if vi is not None:
                    cnt_by_vid[vi] = c
            combo_dsum[cid, :n_real] = np.where(has, cnt_by_vid[safe_vid], 0)
        if rv:
            rw_by_vid = np.zeros(max(len(vals_k), 1), np.int32)
            for val, w in rv.items():
                vi = vals_k.get(val)
                if vi is not None:
                    rw_by_vid[vi] = w
            rev_weight[cid, :n_real] = np.where(has, rw_by_vid[safe_vid], 0)

    # --- reverse anti-affinity terms (replicas sharing one term and one
    # topology domain collapse to a single row) ----------------------------
    ex_ids: Dict[Tuple, int] = {}
    ex_terms: List[Tuple[Tuple[str, ...], Any, str, str]] = []
    if index is not None:
        for key, sel, owner_nodes in index.ex_term_list():
            if key in ex_ids or not any(n in node_idx for n in owner_nodes):
                continue
            nss, _sig, topo, owner_val = key
            ex_ids[key] = len(ex_terms)
            ex_terms.append((nss, sel, topo, owner_val))
    for p in fold:
        aff = p.spec.affinity
        if aff is None or aff.pod_anti_affinity is None:
            continue
        for term in aff.pod_anti_affinity.required:
            owner_val = nodes[node_idx[p.spec.node_name]].metadata.labels.get(
                term.topology_key)
            if owner_val is None:
                continue  # owner's node lacks the key: term can't be violated
            nss = _term_namespaces(term, p.metadata.namespace)
            key = (nss, _selector_sig(term.label_selector), term.topology_key,
                   owner_val)
            if key not in ex_ids:
                ex_ids[key] = len(ex_terms)
                ex_terms.append(
                    (nss, term.label_selector, term.topology_key, owner_val))
    T = pad_to(max(len(ex_terms), 1), CAP_QUANTUM)
    ex_domain = np.zeros((T, N), bool)
    pod_matches_ex = np.zeros((P, T), bool)
    for t, (nss, sel, topo, owner_val) in enumerate(ex_terms):
        for i, node in enumerate(nodes):
            if node.metadata.labels.get(topo) == owner_val:
                ex_domain[t, i] = True
        for i, pod in enumerate(pending_pods):
            pod_matches_ex[i, t] = _matches(sel, nss, pod)

    vols = _volume_columns(pending_pods, nodes, fold, node_idx, P, N,
                           pvcs, pvs, index)

    # --- per-pod constraint arrays ----------------------------------------
    ts_combo = np.zeros((P, MAX_TSC), np.int32)
    ts_skew = np.zeros((P, MAX_TSC), np.int32)
    ts_mode = np.zeros((P, MAX_TSC), np.int32)
    ts_n = np.zeros(P, np.int32)
    pa_combo = np.zeros((P, MAX_PA), np.int32)
    pa_self = np.zeros((P, MAX_PA), bool)
    pa_n = np.zeros(P, np.int32)
    pan_combo = np.zeros((P, MAX_PAN), np.int32)
    pan_n = np.zeros(P, np.int32)
    ppa_combo = np.zeros((P, MAX_PPA), np.int32)
    ppa_w = np.zeros((P, MAX_PPA), np.int32)
    ppa_n = np.zeros(P, np.int32)
    for i, row in pod_rows:
        for j, (cid, skew, mode) in enumerate(row["ts"]):
            ts_combo[i, j], ts_skew[i, j], ts_mode[i, j] = cid, skew, mode
        ts_n[i] = len(row["ts"])
        for j, (cid, self_match) in enumerate(row["pa"]):
            pa_combo[i, j], pa_self[i, j] = cid, self_match
        pa_n[i] = len(row["pa"])
        for j, cid in enumerate(row["pan"]):
            pan_combo[i, j] = cid
        pan_n[i] = len(row["pan"])
        for j, (cid, w) in enumerate(row["ppa"]):
            ppa_combo[i, j], ppa_w[i, j] = cid, w
        ppa_n[i] = len(row["ppa"])

    return dict(
        combo_dsum=combo_dsum, combo_haskey=combo_haskey,
        combo_global=combo_global, combo_here=combo_here,
        combo_key=combo_key, topo_domain=topo_domain,
        topo_onehot=topo_onehot, topo_unique=topo_unique,
        ts_combo=ts_combo, ts_skew=ts_skew, ts_mode=ts_mode, ts_n=ts_n,
        pa_combo=pa_combo, pa_self=pa_self, pa_n=pa_n,
        pan_combo=pan_combo, pan_n=pan_n,
        ppa_combo=ppa_combo, ppa_w=ppa_w, ppa_n=ppa_n,
        ex_domain=ex_domain, pod_matches_ex=pod_matches_ex,
        rev_weight=rev_weight, pod_matches_combo=pod_matches_combo,
        combo_excl=combo_excl, **vols,
    )


def _volume_columns(pending_pods, nodes, assigned, node_idx, P: int, N: int,
                    pvcs, pvs, index: Any = None) -> Dict[str, np.ndarray]:
    """The volume planes: per-claim node verdicts, each pod's claim slots
    and per-family counts, and the assigned pods' mount state per volume
    row (a bound claim's PV, or an unbound claim itself: claims bound to
    one PV share a row).  The last volume row is a dummy scatter target.
    With ``index`` the mount state is the index's, ``assigned`` the extra
    pods folded on top of it."""
    pvc_by_key = {pvc.metadata.key: pvc for pvc in pvcs}
    pv_by_name = {pv.metadata.name: pv for pv in pvs}

    def count_key(pvc: Any) -> Tuple[str, str]:
        if pvc.spec.volume_name:
            return ("pv", pvc.spec.volume_name)
        return ("pvc", pvc.metadata.key)

    vol_ids: Dict[Tuple[str, str], int] = {}  # counting key → vol-plane row

    def vol_id(key: Tuple[str, str]) -> int:
        if key not in vol_ids:
            vol_ids[key] = len(vol_ids)
        return vol_ids[key]

    claim_ids: Dict[str, int] = {}
    claim_rows: List[List[bool]] = []
    zone_rows: List[List[bool]] = []
    claim_vol_l: List[int] = []
    claim_cnt_l: List[int] = []
    claim_fam_l: List[int] = []
    claim_ro_l: List[bool] = []
    vol_ok = np.zeros(P, bool)
    pod_claims = np.zeros((P, MAX_VOLUMES), np.int32)
    pod_claim_valid = np.zeros((P, MAX_VOLUMES), bool)
    pod_missing = np.zeros(P, np.int32)
    pod_n_vols = np.zeros(P, np.int32)
    F = len(FAMILIES)
    pod_vols_fam = np.zeros((P, F), np.int32)
    vol_ok[: len(pending_pods)] = True
    for i, pod in enumerate(pending_pods):
        vols = pod.spec.volumes
        if not vols:
            continue
        if len(vols) > MAX_VOLUMES:
            raise ValueError(f"pod {pod.metadata.name}: >{MAX_VOLUMES} volumes")
        pod_n_vols[i] = len(vols)
        ok = True
        seen_keys: set = set()
        for j, vol in enumerate(vols):
            key = f"{pod.metadata.namespace}/{vol}"
            if key not in pvc_by_key:
                ok = False
                pod_missing[i] += 1
                pod_vols_fam[i, volume_family(None, pv_by_name)] += 1
                continue
            pvc = pvc_by_key[key]
            ck = count_key(pvc)
            if ck not in seen_keys:  # distinct volumes, not mounts
                seen_keys.add(ck)
                pod_vols_fam[i, volume_family(pvc, pv_by_name)] += 1
            if key not in claim_ids:
                claim_ids[key] = len(claim_rows)
                claim_rows.append(claim_node_mask(pvc, pvs, nodes))
                zone_rows.append(_claim_zone_row(pvc, pv_by_name, nodes,
                                                 pv_zone_ok))
                row = vol_id(ck)
                claim_cnt_l.append(row)
                claim_vol_l.append(row if pvc.spec.volume_name else -1)
                claim_fam_l.append(volume_family(pvc, pv_by_name))
                claim_ro_l.append(pvc.spec.read_only)
            pod_claims[i, j] = claim_ids[key]
            pod_claim_valid[i, j] = True
        vol_ok[i] = ok
    C2 = pad_to(max(len(claim_rows), 1), CAP_QUANTUM)
    claim_mask = np.zeros((C2, N), bool)
    claim_zone_ok = np.zeros((C2, N), bool)
    claim_vol = np.full(C2, -1, np.int32)
    claim_cnt = np.zeros(C2, np.int32)
    claim_family = np.zeros(C2, np.int32)
    claim_ro = np.zeros(C2, bool)
    for cid, row in enumerate(claim_rows):
        claim_mask[cid, : len(row)] = row
        claim_zone_ok[cid, : len(row)] = zone_rows[cid]
        claim_vol[cid] = claim_vol_l[cid]
        claim_cnt[cid] = claim_cnt_l[cid]
        claim_family[cid] = claim_fam_l[cid]
        claim_ro[cid] = claim_ro_l[cid]
    Vd = pad_to(len(vol_ids) + 1, CAP_QUANTUM)
    vol_any = np.zeros((Vd, N), bool)
    vol_rw = np.zeros((Vd, N), bool)
    node_vols_fam = np.zeros((F, N), np.int32)
    if index is not None:
        # the index's per-node volume state, the extra pods folded in
        # through this build's own PVC/PV view
        nvs = index.node_vol_state()
        for p in assigned:
            nv = nvs.setdefault(p.spec.node_name, {})
            for j, vol in enumerate(p.spec.volumes):
                opvc = pvc_by_key.get(f"{p.metadata.namespace}/{vol}")
                if opvc is None:
                    ent = nv.setdefault(("miss", pod_key(p), j),
                                        [0, 0, volume_family(None, pv_by_name)])
                    ent[0] += 1
                    continue
                ck = count_key(opvc)
                fam = volume_family(opvc, pv_by_name)
                ent = nv.setdefault(ck, [0, 0, fam])
                ent[0] += 1
                ent[2] = fam
                if opvc.spec.volume_name and not opvc.spec.read_only:
                    ent[1] += 1
        for node_name, entries in nvs.items():
            n = node_idx.get(node_name)
            if n is None:
                continue
            for vk, (mounts, rw_mounts, fam) in entries.items():
                if mounts <= 0:
                    continue
                node_vols_fam[fam, n] += 1  # distinct volumes per node
                v = vol_ids.get(vk)
                if v is not None:
                    vol_any[v, n] = True
                    if rw_mounts > 0:
                        vol_rw[v, n] = True
    else:
        node_claims: List[List[Any]] = [[] for _ in range(len(nodes))]
        for p in assigned:
            for vol in p.spec.volumes:
                opvc = pvc_by_key.get(f"{p.metadata.namespace}/{vol}")
                node_claims[node_idx[p.spec.node_name]].append(opvc)
        for n, claims in enumerate(node_claims):
            seen_node: set = set()
            for opvc in claims:
                if opvc is None:
                    # no identity: each unresolvable mount counts by itself
                    node_vols_fam[0, n] += 1
                    continue
                ck = count_key(opvc)
                if ck not in seen_node:  # distinct volumes per node
                    seen_node.add(ck)
                    node_vols_fam[volume_family(opvc, pv_by_name), n] += 1
                v = vol_ids.get(ck)
                if v is not None:
                    vol_any[v, n] = True
                    if opvc.spec.volume_name and not opvc.spec.read_only:
                        vol_rw[v, n] = True
    return dict(
        claim_mask=claim_mask, pod_claims=pod_claims, vol_ok=vol_ok,
        pod_n_vols=pod_n_vols, claim_zone_ok=claim_zone_ok,
        pod_vols_fam=pod_vols_fam, node_vols_fam=node_vols_fam,
        claim_vol=claim_vol, claim_cnt=claim_cnt, claim_family=claim_family,
        claim_ro=claim_ro, pod_claim_valid=pod_claim_valid,
        pod_missing=pod_missing, vol_any=vol_any, vol_rw=vol_rw,
    )


def pack_constraint_tables(cols: Dict[str, Any]) -> HostTable:
    """The host half of ``constraint_tables_from_numpy``: the columns in
    one flat buffer, ``in_use`` read from them (host work only)."""
    cols = {name: np.asarray(cols[name]) for name in _COLUMNS}
    host = HostTable.pack(ConstraintTables, cols)
    host.host_fields["in_use"] = constraint_use(cols)
    return host


def constraint_tables_from_numpy(cols: Dict[str, Any],
                                 device) -> ConstraintTables:
    """ConstraintTables on ``device`` from numpy columns (the port's own,
    or a JAX table's ``np.asarray`` per field): one host→device copy."""
    return pack_constraint_tables(cols).to_device(resolve_device(device))


def build_constraint_tables(
    pending_pods: Sequence[Any],
    nodes: Sequence[Any],
    assigned_pods: Sequence[Any],
    pod_capacity: Optional[int] = None,
    node_capacity: Optional[int] = None,
    pvcs: Sequence[Any] = (),
    pvs: Sequence[Any] = (),
    scan_planes: bool = True,
    device=None,
    index: Any = None,
    extra_assigned: Sequence[Any] = (),
) -> ConstraintTables:
    """The wave's coupling tables on ``device`` (``None``: the card);
    arguments as ``constraint_columns``."""
    return constraint_tables_from_numpy(
        constraint_columns(pending_pods, nodes, assigned_pods, pod_capacity,
                           node_capacity, pvcs, pvs, scan_planes, index,
                           extra_assigned),
        device)


#: the device columns, in declaration order (every field but ``in_use``)
_COLUMNS = tuple(f for f in ConstraintTables.__dataclass_fields__
                 if f != "in_use")

#: column → (kind, axis): the one map of how each plane is laid out
#: ("first": a leading pod axis, "last": a trailing node axis, "rep":
#: small metadata), JAX ``models/constraints.py:161``;
#: ``parallel/sharding.py`` splits a wave's tables over a mesh by it
CONSTRAINT_AXES = {
    "combo_dsum": ("last", "nodes"),
    "combo_haskey": ("last", "nodes"),
    "combo_here": ("last", "nodes"),
    "combo_global": ("rep", None),
    "combo_key": ("rep", None),
    "topo_domain": ("last", "nodes"),
    "topo_onehot": ("last", "nodes"),
    "topo_unique": ("rep", None),
    "ex_domain": ("last", "nodes"),
    "pod_matches_ex": ("first", "pods"),
    "rev_weight": ("last", "nodes"),
    "pod_matches_combo": ("first", "pods"),
    "combo_excl": ("last", "nodes"),
    "claim_mask": ("last", "nodes"),
    "claim_zone_ok": ("last", "nodes"),
    "node_vols_fam": ("last", "nodes"),
    "pod_vols_fam": ("first", "pods"),
    "claim_vol": ("rep", None),
    "claim_cnt": ("rep", None),
    "claim_family": ("rep", None),
    "claim_ro": ("rep", None),
    "pod_claim_valid": ("first", "pods"),
    "pod_missing": ("first", "pods"),
    "vol_any": ("last", "nodes"),
    "vol_rw": ("last", "nodes"),
    "ts_combo": ("first", "pods"),
    "ts_skew": ("first", "pods"),
    "ts_mode": ("first", "pods"),
    "ts_n": ("first", "pods"),
    "pa_combo": ("first", "pods"),
    "pa_self": ("first", "pods"),
    "pa_n": ("first", "pods"),
    "pan_combo": ("first", "pods"),
    "pan_n": ("first", "pods"),
    "ppa_combo": ("first", "pods"),
    "ppa_w": ("first", "pods"),
    "ppa_n": ("first", "pods"),
    "pod_claims": ("first", "pods"),
    "vol_ok": ("first", "pods"),
    "pod_n_vols": ("first", "pods"),
}

#: columns with a leading pod axis (a scan step takes its rows of them),
#: in the JAX package's order
POD_AXIS_FIELDS = (
    "pod_matches_ex", "pod_matches_combo", "pod_vols_fam", "pod_claim_valid",
    "pod_missing", "ts_combo", "ts_skew", "ts_mode", "ts_n", "pa_combo",
    "pa_self", "pa_n", "pan_combo", "pan_n", "ppa_combo", "ppa_w", "ppa_n",
    "pod_claims", "vol_ok", "pod_n_vols",
)

#: columns the sequential scan carries and updates as pods commit
SCAN_CARRIED_FIELDS = (
    "combo_dsum", "combo_here", "combo_global", "combo_excl", "rev_weight",
    "vol_any", "vol_rw", "node_vols_fam",
)
