"""The corev1 subset the device tables and the headline oracle read.

A copy of what ``minisched_tpu/api/objects.py`` defines for these readers:
quantities in integer base units (milli-CPU, bytes), names as the
identity (``uid`` defaults to ``""``, so tie-break seeds come from names),
taints and tolerations.  The table encoders read these objects
duck-typed, so the JAX package's objects build the same tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

CPU = "cpu"  # milli-cores
MEMORY = "memory"  # bytes
PODS = "pods"  # count
EPHEMERAL_STORAGE = "ephemeral-storage"  # bytes

MIB = 1024 * 1024

DEFAULT_POD_CPU_REQUEST = 100  # milli-CPU, mirrors upstream non-zero default
DEFAULT_POD_MEMORY_REQUEST = 200 * MIB  # bytes

_SUFFIXES = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "k": 1000,
    "M": 1000**2,
    "G": 1000**3,
    "T": 1000**4,
}


def parse_quantity(value: Any, resource: str) -> int:
    """Parse '4', '4000m', '8Gi', '512Mi' → integer base units."""
    if isinstance(value, int):
        return value
    s = str(value).strip()
    if resource == CPU:
        if s.endswith("m"):
            return int(s[:-1])
        return int(float(s) * 1000)
    for suf, mult in _SUFFIXES.items():
        if s.endswith(suf):
            return int(float(s[: -len(suf)]) * mult)
    return int(float(s))


@dataclass
class ResourceList:
    """Typed resource vector in integer base units."""

    milli_cpu: int = 0
    memory: int = 0
    pods: int = 0
    ephemeral_storage: int = 0
    scalar: Dict[str, int] = field(default_factory=dict)

    @staticmethod
    def parse(raw: Optional[Dict[str, Any]]) -> "ResourceList":
        rl = ResourceList()
        for k, v in (raw or {}).items():
            if k == CPU:
                rl.milli_cpu = parse_quantity(v, CPU)
            elif k == MEMORY:
                rl.memory = parse_quantity(v, MEMORY)
            elif k == PODS:
                rl.pods = int(v)
            elif k == EPHEMERAL_STORAGE:
                rl.ephemeral_storage = parse_quantity(v, EPHEMERAL_STORAGE)
            else:
                rl.scalar[k] = parse_quantity(v, k)
        return rl

    def add(self, other: "ResourceList") -> None:
        self.milli_cpu += other.milli_cpu
        self.memory += other.memory
        self.pods += other.pods
        self.ephemeral_storage += other.ephemeral_storage
        for k, v in other.scalar.items():
            self.scalar[k] = self.scalar.get(k, 0) + v

    def clone(self) -> "ResourceList":
        return ResourceList(
            self.milli_cpu, self.memory, self.pods, self.ephemeral_storage,
            dict(self.scalar),
        )


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)


TAINT_EFFECT_NO_SCHEDULE = "NoSchedule"
TOLERATION_OP_EXISTS = "Exists"
TOLERATION_OP_EQUAL = "Equal"


@dataclass
class Taint:
    key: str
    value: str = ""
    effect: str = TAINT_EFFECT_NO_SCHEDULE


@dataclass
class Toleration:
    key: str = ""
    operator: str = TOLERATION_OP_EQUAL
    value: str = ""
    effect: str = ""  # empty matches all effects

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if not self.key:
            # empty key with Exists tolerates everything
            return self.operator == TOLERATION_OP_EXISTS
        if self.key != taint.key:
            return False
        if self.operator == TOLERATION_OP_EXISTS:
            return True
        return self.value == taint.value


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: List[Taint] = field(default_factory=list)
    #: multi-host slice topology: slice id ('' = none), torus coordinates,
    #: host index within the slice and the slice's torus dimensions
    slice_id: str = ""
    torus_x: int = 0
    torus_y: int = 0
    torus_z: int = 0
    host_index: int = -1
    slice_dx: int = 0
    slice_dy: int = 0
    slice_dz: int = 0


@dataclass
class NodeStatus:
    capacity: ResourceList = field(default_factory=ResourceList)
    allocatable: ResourceList = field(default_factory=ResourceList)
    images: Dict[str, int] = field(default_factory=dict)  # image → bytes


@dataclass
class Node:
    metadata: ObjectMeta
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)


@dataclass
class Container:
    name: str = "main"
    image: str = ""
    requests: ResourceList = field(default_factory=ResourceList)
    limits: ResourceList = field(default_factory=ResourceList)
    ports: List[int] = field(default_factory=list)


@dataclass
class PodSpec:
    node_name: str = ""  # set by binding
    containers: List[Container] = field(default_factory=list)
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Toleration] = field(default_factory=list)
    #: node affinity and gang membership are encoded by the table encoder
    #: when present; their object model arrives with the slices that
    #: schedule them (read duck-typed until then)
    affinity: Optional[Any] = None
    topology_spread_constraints: List[Any] = field(default_factory=list)
    gang: Optional[Any] = None


@dataclass
class Pod:
    metadata: ObjectMeta
    spec: PodSpec = field(default_factory=PodSpec)

    def resource_requests(self) -> ResourceList:
        """Sum of container requests, with ``pods`` floored at 1 (the
        non-zero scorer defaults are applied by the table, not here)."""
        total = ResourceList()
        for c in self.spec.containers:
            total.add(c.requests)
        total.pods = max(total.pods, 1)
        return total


def gang_key(pod: Any) -> Optional[str]:
    """'namespace/gangname' for a gang member, None for singletons."""
    g = pod.spec.gang
    if g is None or not g.name:
        return None
    return f"{pod.metadata.namespace}/{g.name}"


def make_node(
    name: str,
    unschedulable: bool = False,
    labels: Optional[Dict[str, str]] = None,
    capacity: Optional[Dict[str, Any]] = None,
    taints: Optional[List[Taint]] = None,
    slice_id: str = "",
    torus: Optional[tuple] = None,
    host_index: int = -1,
    slice_dims: Optional[tuple] = None,
) -> Node:
    cap = ResourceList.parse(capacity or {CPU: "4", MEMORY: "16Gi", PODS: 110})
    tx, ty, tz = (tuple(torus) + (0, 0, 0))[:3] if torus else (0, 0, 0)
    dx, dy, dz = (
        (tuple(slice_dims) + (0, 0, 0))[:3] if slice_dims else (0, 0, 0)
    )
    return Node(
        metadata=ObjectMeta(name=name, namespace="", labels=dict(labels or {})),
        spec=NodeSpec(
            unschedulable=unschedulable,
            taints=list(taints or []),
            slice_id=slice_id,
            torus_x=tx, torus_y=ty, torus_z=tz,
            host_index=host_index,
            slice_dx=dx, slice_dy=dy, slice_dz=dz,
        ),
        status=NodeStatus(capacity=cap, allocatable=cap.clone()),
    )


def make_pod(
    name: str,
    namespace: str = "default",
    requests: Optional[Dict[str, Any]] = None,
    labels: Optional[Dict[str, str]] = None,
    **spec_kwargs: Any,
) -> Pod:
    containers = (
        [Container(requests=ResourceList.parse(requests))]
        if requests else [Container()]
    )
    return Pod(
        metadata=ObjectMeta(
            name=name, namespace=namespace, labels=dict(labels or {})
        ),
        spec=PodSpec(containers=containers, **spec_kwargs),
    )
