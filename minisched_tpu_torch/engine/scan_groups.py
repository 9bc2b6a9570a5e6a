"""Interaction grouping for the blocked scan lane (ops/sequential.
blocked_scan_schedule).

A copy of ``minisched_tpu/engine/scan_groups.py`` (pure host code) over
the port's own selector helpers (``models/constraints.py``).

Two cross-pod-constrained pods INTERACT when one's commit can change what
the other observes: they share a selector group (one's labels match a
selector another's constraint carries — in either direction), or they
reference a shared volume identity.  Pods that don't interact can be
evaluated in one block: their carried-plane updates commute, so the block
result equals a sequential order — capacity races are separately caught
by repair acceptance and retried.

``order_into_blocks`` assigns pods first-fit into fixed-size blocks whose
member interaction sets stay pairwise disjoint.  First-fit preserves
per-group FIFO order: a block rejected for an earlier same-group pod
keeps rejecting later ones (blocks only grow), so a group's members land
in strictly increasing blocks — the within-group sequential semantics the
blocked kernel's exactness claim rests on.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from minisched_tpu_torch.models.constraints import (
    _matches,
    _selector_sig,
    _term_namespaces,
    rev_pref_terms_of,
)


def _own_terms(pod: Any):
    """Every (namespaces, selector) group a pod's constraints carry —
    spread constraints, required/preferred (anti-)affinity both signs."""
    ns = pod.metadata.namespace
    for c in pod.spec.topology_spread_constraints:
        yield ((ns,), c.label_selector)
    aff = pod.spec.affinity
    if aff is None:
        return
    pa, pan = aff.pod_affinity, aff.pod_anti_affinity
    if pa is not None:
        for term in pa.required:
            yield (_term_namespaces(term, ns), term.label_selector)
        for wt in pa.preferred:
            yield (_term_namespaces(wt.term, ns), wt.term.label_selector)
    if pan is not None:
        for term in pan.required:
            yield (_term_namespaces(term, ns), term.label_selector)
        for wt in pan.preferred:
            yield (_term_namespaces(wt.term, ns), wt.term.label_selector)


def interaction_sets(pods: Sequence[Any]) -> List[Set]:
    """Per-pod interaction-identity sets over the given pods.

    Identities: selector-group ids (a pod holds a group if its constraints
    carry it OR its labels match it — matching covers both directions of
    every coupling, incl. the symmetric rev_weight scoring, whose term
    stream is a subset of ``_own_terms``) and volume claim keys."""
    group_ids: Dict[Tuple, int] = {}
    group_sel: List[Tuple[Tuple[str, ...], Any]] = []

    def gid(nss: Tuple[str, ...], sel: Any) -> int:
        key = (nss, _selector_sig(sel))
        g = group_ids.get(key)
        if g is None:
            g = group_ids[key] = len(group_sel)
            group_sel.append((nss, sel))
        return g

    own: List[Set] = []
    for pod in pods:
        s: Set = {gid(nss, sel) for nss, sel in _own_terms(pod)}
        for _nss, _sel, _topo, _w in rev_pref_terms_of(pod):
            s.add(gid(_nss, _sel))
        for vol in pod.spec.volumes:
            s.add(("vol", f"{pod.metadata.namespace}/{vol}"))
        own.append(s)
    # matching direction: pod's labels hit a group's selector
    for i, pod in enumerate(pods):
        for g, (nss, sel) in enumerate(group_sel):
            if g not in own[i] and _matches(sel, nss, pod):
                own[i].add(g)
    return own


def order_into_blocks(
    items: Sequence[Any], sets: Sequence[Set], block_size: int
) -> List[List[Optional[Any]]]:
    """First-fit the items into blocks of ``block_size`` with pairwise-
    disjoint sets; short blocks are padded with None.  Items appear in
    non-decreasing block order per interaction group (see module doc)."""
    blocks: List[Tuple[List[Any], Set]] = []
    for item, s in zip(items, sets):
        placed = False
        for members, union in blocks:
            if len(members) < block_size and not (union & s):
                members.append(item)
                union |= s
                placed = True
                break
        if not placed:
            blocks.append(([item], set(s)))
    return [
        members + [None] * (block_size - len(members))
        for members, _ in blocks
    ]
