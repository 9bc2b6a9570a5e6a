"""Node-resources plugins: the Fit filter and the LeastAllocated and
BalancedAllocation scorers.

Counterpart of ``minisched_tpu/plugins/noderesources.py``, both halves.
The scalar halves read a NodeInfo's sums, in Python integers.  All batch
resource math is int32 in (milli-CPU, MiB), as in the JAX package, and
wraps where its int32 math wraps: ``requested * FRAC_SCALE`` in
BalancedAllocation and ``(a - requested) * MAX_NODE_SCORE`` in
LeastAllocated overflow on nodes of a few TiB.  ``//`` on torch integer
tensors floors, as ``jnp``'s does.  Every plugin here reads the node
table's committed requests, so the repair loop re-evaluates it every
round (``reads_committed_state``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.nodeinfo import MIB, non_zero_requests
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.framework.types import (
    MAX_NODE_SCORE,
    CycleState,
    Status,
)
from minisched_tpu_torch.models import tables

FIT_NAME = "NodeResourcesFit"
LEAST_ALLOCATED_NAME = "NodeResourcesLeastAllocated"
BALANCED_ALLOCATION_NAME = "NodeResourcesBalancedAllocation"

# BalancedAllocation's fraction quantum: fractions are scaled by 1,000
FRAC_SCALE = 1_000


def _nonzero_requests(pods: Any):
    """(cpu, mem) i32[P]: the pod's requests with upstream's non-zero
    defaults (100m CPU, 200 MiB) for a zero request."""
    cpu = torch.where(pods.req_cpu == 0, tables.DEFAULT_NONZERO_CPU,
                      pods.req_cpu)
    mem = torch.where(pods.req_mem == 0, tables.DEFAULT_NONZERO_MEM_MIB,
                      pods.req_mem)
    return cpu.to(torch.int32), mem.to(torch.int32)


def _nz_cpu(milli: int) -> int:
    return milli or tables.DEFAULT_NONZERO_CPU


def _nz_mem_mib(mib: int) -> int:
    return mib or tables.DEFAULT_NONZERO_MEM_MIB


def _nz_sums(pod: Any, ni: Any) -> Tuple[int, int, int, int]:
    """(cpu requested, cpu allocatable, MiB requested, MiB allocatable) of
    ``ni`` with ``pod`` placed, requests at their non-zero defaults."""
    alloc = ni.node.status.allocatable
    nz = non_zero_requests(pod)
    return (ni.non_zero_requested.milli_cpu + _nz_cpu(nz.milli_cpu),
            alloc.milli_cpu,
            ni.nzreq_mem_mib + _nz_mem_mib(nz.memory // MIB),
            alloc.memory // MIB)


class NodeResourcesFit(BatchEvaluable):
    """Filter: the pod's requests fit the node's remaining allocatable
    (pod count always; a resource only where the pod requests it).  Also a
    scorer through its LeastAllocated scoring strategy."""

    reads_committed_state = True  # intra-wave commits change the verdict

    def events_to_register(self) -> List[ClusterEvent]:
        """The cluster events that may make a pod this plugin rejected
        schedulable again (the JAX plugin's registration)."""
        return [
            ClusterEvent(GVK.POD, ActionType.DELETE),
            ClusterEvent(GVK.NODE,
                ActionType.ADD | ActionType.UPDATE_NODE_ALLOCATABLE),
        ]

    def __init__(self, scoring_strategy: str = "LeastAllocated"):
        if scoring_strategy != "LeastAllocated":
            raise ValueError(
                f"unsupported ScoringStrategy {scoring_strategy!r} "
                "(LeastAllocated only)"
            )
        self._scorer = NodeResourcesLeastAllocated()

    def name(self) -> str:
        return FIT_NAME

    def filter(self, state: CycleState, pod: Any, node_info: Any) -> Status:
        node = node_info.node
        if node is None:
            return Status.unresolvable("node not found")
        alloc = node.status.allocatable
        reasons: List[str] = []
        if len(node_info.pods) + 1 > alloc.pods:
            reasons.append("Too many pods")
        req = pod.resource_requests()
        if (req.milli_cpu > 0 and req.milli_cpu
                > alloc.milli_cpu - node_info.requested.milli_cpu):
            reasons.append("Insufficient cpu")
        req_mem = req.memory // MIB
        if req_mem > 0 and req_mem > alloc.memory // MIB - node_info.req_mem_mib:
            reasons.append("Insufficient memory")
        req_eph = req.ephemeral_storage // MIB
        if (req_eph > 0 and req_eph
                > alloc.ephemeral_storage // MIB - node_info.req_eph_mib):
            reasons.append("Insufficient ephemeral-storage")
        if reasons:
            return Status.unschedulable(*reasons).with_plugin(FIT_NAME)
        return Status.success()

    def score(self, state: CycleState, pod: Any,
              node_name: str) -> Tuple[int, Status]:
        return self._scorer.score(state, pod, node_name)

    def score_extensions(self) -> None:
        return None

    def batch_score(self, ctx: Any, pods: Any, nodes: Any,
                    aux: Dict[str, Any]) -> torch.Tensor:
        return self._scorer.batch_score(ctx, pods, nodes, aux)

    def batch_filter(self, ctx: Any, pods: Any, nodes: Any) -> torch.Tensor:
        pods_ok = (nodes.req_pods + 1 <= nodes.alloc_pods)[None, :]

        def fits(pod_req, node_req, node_alloc):
            remaining = (node_alloc - node_req)[None, :]
            r = pod_req[:, None]
            return (r == 0) | (r <= remaining)

        return (
            pods_ok
            & fits(pods.req_cpu, nodes.req_cpu, nodes.alloc_cpu)
            & fits(pods.req_mem, nodes.req_mem, nodes.alloc_mem)
            & fits(pods.req_eph, nodes.req_eph, nodes.alloc_eph)
        )


class NodeResourcesLeastAllocated(BatchEvaluable):
    """Score: ``(allocatable - requested) * 100 // allocatable`` per
    resource (0 when over-allocated), cpu and memory averaged."""

    reads_committed_state = True  # intra-wave commits change the verdict

    def name(self) -> str:
        return LEAST_ALLOCATED_NAME

    def score(self, state: CycleState, pod: Any,
              node_name: str) -> Tuple[int, Status]:
        cpu_req, cpu_alloc, mem_req, mem_alloc = _nz_sums(
            pod, state.read("nodeinfo/" + node_name))
        cpu = self._least(cpu_req, cpu_alloc)
        mem = self._least(mem_req, mem_alloc)
        return (cpu + mem) // 2, Status.success()

    @staticmethod
    def _least(requested: int, allocatable: int) -> int:
        if allocatable <= 0 or requested > allocatable:
            return 0
        return (allocatable - requested) * MAX_NODE_SCORE // allocatable

    def score_extensions(self) -> None:
        return None

    def batch_score(self, ctx: Any, pods: Any, nodes: Any,
                    aux: Dict[str, Any]) -> torch.Tensor:
        def least(pod_nz, node_nz, alloc):
            requested = pod_nz[:, None] + node_nz[None, :]
            a = alloc[None, :]
            score = (a - requested) * MAX_NODE_SCORE // a.clamp(min=1)
            return torch.where((a <= 0) | (requested > a), 0, score)

        pod_cpu, pod_mem = _nonzero_requests(pods)
        cpu = least(pod_cpu, nodes.nzreq_cpu, nodes.alloc_cpu)
        mem = least(pod_mem, nodes.nzreq_mem, nodes.alloc_mem)
        return ((cpu + mem) // 2).to(torch.int32)


class NodeResourcesBalancedAllocation(BatchEvaluable):
    """Score: ``(1 - |cpuFraction - memFraction|) * 100`` with fractions
    of allocatable after placement in units of 1/FRAC_SCALE, 0 when either
    fraction reaches 1."""

    reads_committed_state = True  # intra-wave commits change the verdict

    def name(self) -> str:
        return BALANCED_ALLOCATION_NAME

    def score(self, state: CycleState, pod: Any,
              node_name: str) -> Tuple[int, Status]:
        cpu_req, cpu_alloc, mem_req, mem_alloc = _nz_sums(
            pod, state.read("nodeinfo/" + node_name))
        cpu_frac = self._frac(cpu_req, cpu_alloc)
        mem_frac = self._frac(mem_req, mem_alloc)
        if cpu_frac >= FRAC_SCALE or mem_frac >= FRAC_SCALE:
            return 0, Status.success()
        diff = abs(cpu_frac - mem_frac)
        return ((FRAC_SCALE - diff) * MAX_NODE_SCORE // FRAC_SCALE,
                Status.success())

    @staticmethod
    def _frac(requested: int, allocatable: int) -> int:
        if allocatable <= 0:
            return FRAC_SCALE  # saturated
        # clamped before scaling, as the batch form clamps to keep its
        # int32 multiply in range: a request at or past the allocatable
        # scores 0 either way
        return min(requested, 2 * allocatable) * FRAC_SCALE // allocatable

    def score_extensions(self) -> None:
        return None

    def batch_score(self, ctx: Any, pods: Any, nodes: Any,
                    aux: Dict[str, Any]) -> torch.Tensor:
        def frac(pod_nz, node_nz, alloc):
            requested = pod_nz[:, None] + node_nz[None, :]
            a = alloc[None, :]
            requested = torch.minimum(requested, 2 * a)
            return torch.where(
                a > 0, requested * FRAC_SCALE // a.clamp(min=1), FRAC_SCALE)

        pod_cpu, pod_mem = _nonzero_requests(pods)
        cpu_frac = frac(pod_cpu, nodes.nzreq_cpu, nodes.alloc_cpu)
        mem_frac = frac(pod_mem, nodes.nzreq_mem, nodes.alloc_mem)
        diff = (cpu_frac - mem_frac).abs()
        score = (FRAC_SCALE - diff) * MAX_NODE_SCORE // FRAC_SCALE
        saturated = (cpu_frac >= FRAC_SCALE) | (mem_frac >= FRAC_SCALE)
        return torch.where(saturated, 0, score).to(torch.int32)
