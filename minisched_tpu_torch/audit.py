"""Checks of a placement run that read only the objects and the final
node table (no plugin code), shared by ``chip_smoke.py`` and the bench
roles (``bench.py``).

* ``audit_config5``: config 5's safety rules over every pod;
* ``spread_audit``: ``bench.py``'s max-skew audit of the spread pods;
* ``one_slice_share``: the share of gangs whose members all sit on one
  slice, which ``bench.py`` ``bench_gang`` reports (not a gate).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

from minisched_tpu_torch.api.objects import gang_key
from minisched_tpu_torch.headline import pods_by_node
from minisched_tpu_torch.models import tables


def audit_config5(run: Any, nodes: Sequence[Any], pods: Sequence[Any],
                  assigned: Sequence[Any] = ()) -> None:
    """Raise unless ``run`` (``choices`` per pod, final ``node_table``)
    keeps config 5's rules: (a) the final table is the initial one (with
    the ``assigned`` pods) plus a recount from the choices; (b) no node is
    over its allocatable; (c) no pod sits on a cordoned node; (d) no
    ``special*`` pod is placed; (e) every unplaced plain pod fits no
    node."""
    init = {k: v.numpy() for k, v in tables.table_columns(
        tables.build_node_table(nodes, pods_by_node(assigned),
                                device="cpu")[0]).items()}
    final = {k: v.cpu().numpy() for k, v in tables.table_columns(
        run.node_table).items()}
    choice = run.choices
    placed = choice >= 0
    reqs = [p.resource_requests() for p in pods]
    mib = 1024 * 1024
    cpu = np.array([r.milli_cpu for r in reqs], np.int64)
    mem = np.array([r.memory // mib for r in reqs], np.int64)
    eph = np.array([r.ephemeral_storage // mib for r in reqs], np.int64)
    demand = {"req_cpu": cpu, "req_mem": mem, "req_eph": eph,
              "req_pods": np.ones_like(cpu),
              "nzreq_cpu": np.where(cpu == 0, 100, cpu),
              "nzreq_mem": np.where(mem == 0, 200, mem)}
    n = len(init["valid"])
    for col, amount in demand.items():  # (a)
        want = init[col] + np.bincount(choice[placed], amount[placed],
                                       minlength=n).astype(np.int64)
        if not np.array_equal(final[col].astype(np.int64), want):
            raise AssertionError(f"config 5 audit (a): {col} is not the "
                                 "initial table plus the recount")
    valid = final["valid"]
    for res in ("cpu", "mem", "eph", "pods"):  # (b)
        over = valid & (final[f"req_{res}"] > final[f"alloc_{res}"])
        if over.any():
            raise AssertionError(f"config 5 audit (b): {int(over.sum())} "
                                 f"nodes over their {res} allocatable")
    if final["unschedulable"][choice[placed]].any():  # (c)
        raise AssertionError("config 5 audit (c): a pod on a cordoned node")
    special = np.array([p.metadata.name.startswith("special") for p in pods])
    if (placed & special).any():  # (d)
        raise AssertionError("config 5 audit (d): a special pod was placed")
    open_node = valid & ~final["unschedulable"]

    def room(res: str, amount: int):
        # a resource the pod does not ask for fits any node
        return amount == 0 or final[f"alloc_{res}"] - final[f"req_{res}"] >= amount

    for i in np.flatnonzero(~placed & ~special):  # (e)
        fits = (open_node & room("cpu", cpu[i]) & room("mem", mem[i])
                & room("eph", eph[i])
                & (final["req_pods"] + 1 <= final["alloc_pods"]))
        if fits.any():
            raise AssertionError(f"config 5 audit (e): unplaced "
                                 f"{pods[i].metadata.name} fits "
                                 f"{int(fits.sum())} nodes")


def spread_audit(nodes: Sequence[Any], pods: Sequence[Any], choices,
                 max_skew: int) -> int:
    """``bench.py``'s spread audit: for each app of the ``spread*`` pods,
    its pods per zone, over the zones that hold a schedulable node, differ
    by at most ``max_skew``.  Returns the number of apps."""
    zone = [n.metadata.labels.get("zone") for n in nodes]
    zones = sorted({z for n, z in zip(nodes, zone)
                    if z and not n.spec.unschedulable})
    per_app: Dict[str, Dict[str, int]] = {}
    for p, c in zip(pods, choices):
        if p.metadata.name.startswith("spread") and c >= 0:
            counts = per_app.setdefault(p.metadata.labels["app"], {})
            counts[zone[c]] = counts.get(zone[c], 0) + 1
    for app, counts in per_app.items():
        row = [counts.get(z, 0) for z in zones]
        if max(row) - min(row) > max_skew:
            raise AssertionError(f"spread audit: {app} has {row} pods per "
                                 f"zone, skew above {max_skew}")
    return len(per_app)


def one_slice_share(nodes: Sequence[Any], assigned: Sequence[Any],
                    pods: Sequence[Any], choices) -> Dict[str, Any]:
    """Of the gangs whose members are all placed (the ``assigned`` ones
    and the ``pods`` with a choice), how many sit on one slice: ``gangs``,
    ``complete`` and ``one_slice`` counts and ``share`` (one_slice over
    complete)."""
    slice_of = {n.metadata.name: n.spec.slice_id for n in nodes}
    members: Dict[str, list] = {}
    for p in assigned:
        members.setdefault(gang_key(p), []).append(slice_of[p.spec.node_name])
    for p, c in zip(pods, choices):
        key = gang_key(p)
        if key is not None:
            members.setdefault(key, []).append(
                nodes[c].spec.slice_id if c >= 0 else None)
    members.pop(None, None)
    complete = [s for s in members.values() if None not in s]
    one = sum(1 for s in complete if len(set(s)) == 1)
    return {"gangs": len(members), "complete": len(complete),
            "one_slice": one,
            "share": one / len(complete) if complete else 0.0}
