"""Construction-time guard for the repair loop's static/dynamic split.

Counterpart of ``minisched_tpu/ops/staticcheck.py``.  With
``split_static`` the repair loop computes plugins whose
``reads_committed_state`` is False once per wave.  That flag is kept by
hand, and a wrong one fails silently: a kernel that does read committed
state (the planes ``ops/state.apply_placements`` updates) would serve
round-1 verdicts all wave long.

So each static-classified plugin's batch kernels run twice on a tiny
probe cluster, on CPU tensors: once as built and once with every
committed-state plane changed, those of the NodeTable and the volume
planes the repair loop carries in the constraint tables.  Any difference
in the output means the plugin reads committed state, and construction
is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import torch

from minisched_tpu_torch.ops.fused import run_filter, run_score

#: NodeTable planes apply_placements updates within a wave
_NODE_COMMITTED = (
    "req_cpu", "req_mem", "req_eph", "req_pods", "nzreq_cpu", "nzreq_mem",
    "used_port", "num_used_ports",
)
#: ConstraintTables planes the repair loop carries across rounds
_EXTRA_COMMITTED = ("vol_any", "vol_rw", "node_vols_fam")


def _probe_tables():
    """A tiny cluster on the CPU whose committed-state perturbation flips
    verdicts: nodes with room on every resource for one probe pod, which
    asks for CPU, memory, ephemeral storage and a host port, and mounts a
    claim bound to an EBS PersistentVolume.  Returns (pods, nodes, extra)."""
    from minisched_tpu_torch.api.objects import (
        ObjectMeta,
        PersistentVolume,
        PersistentVolumeClaim,
        PVCSpec,
        PVSpec,
        make_node,
        make_pod,
    )
    from minisched_tpu_torch.models.constraints import build_constraint_tables
    from minisched_tpu_torch.models.tables import build_node_table, build_pod_table

    nodes = [
        make_node(
            f"probe{i}",
            labels={"zone": f"z{i % 2}"},
            capacity={"cpu": "1", "memory": "1Gi", "pods": 2,
                      "ephemeral-storage": "1Gi"},
        )
        for i in range(4)
    ]
    pod = make_pod(
        "probe-pod",
        requests={"cpu": "600m", "memory": "600Mi",
                  "ephemeral-storage": "600Mi"},
        volumes=["probe-claim"],
    )
    pod.spec.containers[0].ports = [8080]
    pv = PersistentVolume(
        ObjectMeta(name="probe-pv", namespace=""),
        PVSpec(capacity=1 << 30, claim_ref="default/probe-claim", driver="ebs"),
    )
    pvc = PersistentVolumeClaim(
        ObjectMeta(name="probe-claim"),
        PVCSpec(request=1 << 30, volume_name="probe-pv"),
    )
    node_table, _ = build_node_table(nodes, device="cpu")
    pod_table, _ = build_pod_table([pod], device="cpu")
    extra = build_constraint_tables(
        [pod], nodes, [], pod_capacity=pod_table.capacity,
        node_capacity=node_table.capacity, pvcs=[pvc], pvs=[pv], device="cpu")
    return pod_table, node_table, extra


def _perturb(nodes: Any, extra: Any) -> Tuple[Any, Any]:
    """Every committed-state plane, substantially changed: resources near
    the allocatable ceiling, the probe pod's own port claimed, every
    volume mounted read-write, family counts at the cap."""
    used_port = nodes.used_port.clone()
    used_port[:, 0] = 8080
    changed = {
        "req_cpu": nodes.alloc_cpu // 2 + 300,
        "req_mem": nodes.alloc_mem // 2 + 300,
        "req_eph": nodes.alloc_eph // 2 + 300,
        "req_pods": nodes.alloc_pods.clamp(min=2),
        "nzreq_cpu": nodes.alloc_cpu // 2 + 300,
        "nzreq_mem": nodes.alloc_mem // 2 + 300,
        "used_port": used_port,
        "num_used_ports": torch.ones_like(nodes.num_used_ports),
    }
    extra_p = dataclasses.replace(
        extra,
        vol_any=torch.ones_like(extra.vol_any),
        vol_rw=torch.ones_like(extra.vol_rw),
        node_vols_fam=extra.node_vols_fam + 39,
    )
    return dataclasses.replace(nodes, **changed), extra_p


def verify_static_classification(static_filters: Sequence[Any],
                                 static_scores: Sequence[Any],
                                 ctx: Any) -> None:
    """Raise TypeError naming any plugin classified round-invariant whose
    batch kernels are sensitive to committed-state planes."""
    if not static_filters and not static_scores:
        return
    pods, nodes, extra = _probe_tables()
    nodes_p, extra_p = _perturb(nodes, extra)

    def run(pl, kind: str, n, e):
        if kind == "filter":
            return run_filter(pl, ctx, pods, n, e)
        aux = pl.batch_pre_score(ctx, pods, n)
        return run_score(pl, ctx, pods, n, aux, e)

    for kind, chain in (("filter", static_filters), ("score", static_scores)):
        for pl in chain:
            if not torch.equal(run(pl, kind, nodes, extra),
                               run(pl, kind, nodes_p, extra_p)):
                raise TypeError(
                    f"plugin {pl.name()}: batch_{kind} output changes when "
                    "committed-state planes change, but the plugin is "
                    "classified round-invariant (reads_committed_state is "
                    "False).  Set `reads_committed_state = True` on the "
                    "plugin class so the repair loop re-evaluates it every "
                    "round."
                )
