"""NodeInfo: a node plus scheduler-relevant aggregates.

A copy of ``minisched_tpu/framework/nodeinfo.py``.

Re-creates framework.NodeInfo (wrapped per listed node at
minisched/minisched.go:126-127).  Tracks the pods assigned to the node and
their aggregate resource requests so filter/score plugins can read
``requested`` vs ``allocatable`` without rescanning pods.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from minisched_tpu_torch.api.objects import (
    DEFAULT_POD_CPU_REQUEST,
    DEFAULT_POD_MEMORY_REQUEST,
    MIB,
    Node,
    Pod,
    ResourceList,
)


def non_zero_requests(pod: Pod) -> ResourceList:
    """Upstream GetNonzeroRequests: pods with no explicit cpu/memory request
    count as 100m / 200Mi for the resource scorers (never the Fit filter)."""
    req = pod.resource_requests()
    nz = req.clone()
    if nz.milli_cpu == 0:
        nz.milli_cpu = DEFAULT_POD_CPU_REQUEST
    if nz.memory == 0:
        nz.memory = DEFAULT_POD_MEMORY_REQUEST
    return nz


class NodeInfo:
    """Aggregates use the device unit discipline (models/tables.py): memory
    is accumulated as per-pod MiB-floored int (sum-of-floors), exactly the
    way the NodeTable builder accumulates — bit-exact oracle/kernel parity
    depends on the two paths quantizing identically."""

    __slots__ = (
        "node",
        "pods",
        "requested",
        "non_zero_requested",
        "req_mem_mib",
        "req_eph_mib",
        "nzreq_mem_mib",
        "used_ports",
        "_cow",
    )

    def __init__(self, node: Optional[Node] = None):
        self.node: Optional[Node] = node
        self.pods: List[Pod] = []
        self.requested: ResourceList = ResourceList()
        self.non_zero_requested: ResourceList = ResourceList()
        self.req_mem_mib: int = 0
        self.req_eph_mib: int = 0
        self.nzreq_mem_mib: int = 0
        #: host ports claimed by assigned pods, in pod-then-container order
        #: (the NodeTable used_port encoding reads this directly instead of
        #: re-walking every pod's containers per wave)
        self.used_ports: List[int] = []
        #: copy-on-write: clone() shares the mutable state and flags BOTH
        #: sides; the first mutation on either materializes private copies
        self._cow = False

    @property
    def name(self) -> str:
        return self.node.metadata.name if self.node else ""

    def _materialize(self) -> None:
        if self._cow:
            self.pods = list(self.pods)
            self.used_ports = list(self.used_ports)
            self.requested = self.requested.clone()
            self.non_zero_requested = self.non_zero_requested.clone()
            self._cow = False

    def add_pod(self, pod: Pod) -> None:
        self._materialize()
        self.pods.append(pod)
        req = pod.resource_requests()
        self.requested.add(req)
        # non_zero_requests(pod), inlined against the one walk above — the
        # second resource_requests walk per event was a quarter of the
        # cache's cost at wave scale (quantization identical: only cpu and
        # memory get the non-zero defaults)
        nz = self.non_zero_requested
        nz.milli_cpu += req.milli_cpu or DEFAULT_POD_CPU_REQUEST
        nz.memory += req.memory or DEFAULT_POD_MEMORY_REQUEST
        nz.pods += req.pods
        nz.ephemeral_storage += req.ephemeral_storage
        for k, v in req.scalar.items():
            nz.scalar[k] = nz.scalar.get(k, 0) + v
        self.req_mem_mib += req.memory // MIB
        self.req_eph_mib += req.ephemeral_storage // MIB
        self.nzreq_mem_mib += (req.memory // MIB) or (
            DEFAULT_POD_MEMORY_REQUEST // MIB
        )
        for c in pod.spec.containers:
            if c.ports:
                self.used_ports.extend(c.ports)

    def remove_pod(self, pod: Pod) -> None:
        self._materialize()
        for i, p in enumerate(self.pods):
            if p.metadata.uid == pod.metadata.uid:
                del self.pods[i]
                # subtract what the STORED object contributed (the caller's
                # copy may differ, e.g. an update refreshing the object)
                req = p.resource_requests()
                self.requested.sub(req)
                nz = self.non_zero_requested
                nz.milli_cpu -= req.milli_cpu or DEFAULT_POD_CPU_REQUEST
                nz.memory -= req.memory or DEFAULT_POD_MEMORY_REQUEST
                nz.pods -= req.pods
                nz.ephemeral_storage -= req.ephemeral_storage
                for k, v in req.scalar.items():
                    nz.scalar[k] = nz.scalar.get(k, 0) - v
                self.req_mem_mib -= req.memory // MIB
                self.req_eph_mib -= req.ephemeral_storage // MIB
                self.nzreq_mem_mib -= (req.memory // MIB) or (
                    DEFAULT_POD_MEMORY_REQUEST // MIB
                )
                for c in p.spec.containers:
                    for port in c.ports:
                        self.used_ports.remove(port)
                return

    def clone(self) -> "NodeInfo":
        """O(1) copy-on-write clone.  Both sides keep reading the shared
        pods/ports/request state; whichever mutates first (via
        add_pod/remove_pod) materializes its own copies.  A 10k-node
        snapshot clone was ~200ms per wave of list/ResourceList copying
        for nodes that mostly don't change; now only touched nodes pay."""
        self._cow = True
        ni = NodeInfo(self.node)
        ni.pods = self.pods
        ni.requested = self.requested
        ni.non_zero_requested = self.non_zero_requested
        ni.req_mem_mib = self.req_mem_mib
        ni.req_eph_mib = self.req_eph_mib
        ni.nzreq_mem_mib = self.nzreq_mem_mib
        ni.used_ports = self.used_ports
        ni._cow = True
        return ni


def build_node_infos(nodes: List[Node], pods: List[Pod]) -> List[NodeInfo]:
    """Snapshot helper: wrap nodes and attach assigned pods."""
    by_name: Dict[str, NodeInfo] = {}
    infos: List[NodeInfo] = []
    for n in nodes:
        ni = NodeInfo(n)
        by_name[n.metadata.name] = ni
        infos.append(ni)
    for p in pods:
        if p.spec.node_name and p.spec.node_name in by_name:
            by_name[p.spec.node_name].add_pod(p)
    return infos
