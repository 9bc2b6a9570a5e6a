"""The comparison that decides ``correct``.

The program's output is the sequence of binds the harness's watch saw,
in the store's order, beside the deletes the traffic made; the
reference (``reference.py``) starts from the cluster made from the seed
and follows that sequence.  Each bind is judged against the state before
it: the node the reference picks for that pod must be the node the
program bound it to, the node must have room (NodeResourcesFit's
guarantee) and every DoNotSchedule spread constraint must keep its
skew.  The program's bind is then applied, so one wrong placement is
counted once and does not shift every later one.  The order in which
pods are placed is the program's (its queue and its lanes); the
reference checks each placement given that order.

After the drain, every pod the traffic created and did not delete must
have been seen bound once, and the store must read back each bind the
watch acknowledged.  Every number compared is a count with the limit 0.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from schedbench.cluster import PodTemplate
from schedbench.reference import Reference

#: the numbers compared, each with its limit
LIMITS = {
    "placement_mismatch": 0,
    "over_capacity": 0,
    "skew_exceeded": 0,
    "double_bind": 0,
    "unbound": 0,
    "readback_mismatch": 0,
}


def judge(cluster, plans: Dict[str, Tuple[str, PodTemplate]],
          events: Iterable[Tuple], store_nodes: Optional[Dict[str, str]],
          ) -> Dict[str, int]:
    """Counts of each fault.  ``plans``: pod name → (uid, template) of
    every pod the traffic created; ``events``: ``("bind", name, node)``
    and ``("delete", name)`` in the store's order; ``store_nodes``: pod
    name → node name ("" when unbound) as the store reads after the drain,
    or None to skip the read-back."""
    ref = Reference(cluster)
    out = dict.fromkeys(LIMITS, 0)
    seen: Dict[str, str] = {}
    deleted = set()
    for ev in events:
        if ev[0] == "delete":
            ref.remove(ev[1])
            deleted.add(ev[1])
            seen.pop(ev[1], None)
            continue
        _kind, name, node = ev
        if name in seen or name not in plans:
            out["double_bind" if name in seen else "placement_mismatch"] += 1
            continue
        seen[name] = node
        uid, pod = plans[name]
        row = ref.node_row.get(node)
        fit, spread = ref.fits(pod), ref.spread_ok(pod)
        if row is None or row != ref.pick(uid, pod, fit & spread):
            out["placement_mismatch"] += 1
        if row is None:
            continue
        if not fit[row]:
            out["over_capacity"] += 1
        if not spread[row]:
            out["skew_exceeded"] += 1
        ref.add(name, row, pod)
    for name in plans:
        if name not in deleted and name not in seen:
            out["unbound"] += 1
    if store_nodes is not None:
        for name, node in seen.items():
            if store_nodes.get(name) != node:
                out["readback_mismatch"] += 1
        for name, node in store_nodes.items():
            if node and name in plans and name not in seen:
                out["readback_mismatch"] += 1
    return out


class _FirstBest(Reference):
    """A scheduler that takes the first of the best nodes, leaving out the
    seeded tie-break."""

    def pick(self, uid: str, pod: PodTemplate, feas: np.ndarray) -> int:
        if not feas.any():
            return -1
        score = self.scores(pod)
        return int(np.flatnonzero(feas & (score == score[feas].max()))[0])


#: the controls: the reference in the program's place with one guarantee
#: the configurations state left out
CONTROLS = {
    "spread": lambda cluster: Reference(cluster, check_spread=False),
    "tiebreak": _FirstBest,
}


def control_events(cluster, order: List[Tuple], kind: str = "spread"
                   ) -> List[Tuple]:
    """What the control ``kind`` (``CONTROLS``) would have produced in the
    program's place, placing ``order``'s ``("create", name, uid, pod)``
    and ``("delete", name)`` steps one by one: ``spread`` leaves the
    PodTopologySpread filter out, ``tiebreak`` the seeded tie-break."""
    ctl = CONTROLS[kind](cluster)
    events: List[Tuple] = []
    for step in order:
        if step[0] == "delete":
            ctl.remove(step[1])
            events.append(step)
            continue
        _kind, name, uid, pod = step
        row = ctl.choose(uid, pod)
        if row >= 0:
            ctl.add(name, row, pod)
            events.append(("bind", name, cluster.names[row]))
    return events


def passed(counts: Dict[str, int]) -> bool:
    return all(counts[k] <= lim for k, lim in LIMITS.items())
