"""The corev1 subset the device tables and the headline oracle read.

A copy of what ``minisched_tpu/api/objects.py`` defines for these readers:
quantities in integer base units (milli-CPU, bytes), names as the
identity (``uid`` defaults to ``""``, so tie-break seeds come from names),
taints and tolerations, node affinity, pod (anti-)affinity, topology
spread constraints, the volumes a pod mounts with their claims and
PersistentVolumes, and gang membership (``GangSpec``) with the slice
topology of nodes, and the ``Lease`` the replicated plane's election
rides.  The table encoders read these objects duck-typed, so
the JAX package's objects build the same tables.
"""

from __future__ import annotations

import copy
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

    def sub(self, other: "ResourceList") -> None:
        self.milli_cpu -= other.milli_cpu
        self.memory -= other.memory
        self.pods -= other.pods
        self.ephemeral_storage -= other.ephemeral_storage
        for k, v in other.scalar.items():
            self.scalar[k] = self.scalar.get(k, 0) - v

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
    annotations: Dict[str, str] = field(default_factory=dict)
    #: the store's version of the object (0 = never stored)
    resource_version: int = 0
    creation_timestamp: float = 0.0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def clone(self) -> "ObjectMeta":
        return ObjectMeta(self.name, self.namespace, self.uid,
                          dict(self.labels), dict(self.annotations),
                          self.resource_version, self.creation_timestamp)


TAINT_EFFECT_NO_SCHEDULE = "NoSchedule"
TAINT_EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_EFFECT_NO_EXECUTE = "NoExecute"
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

    def clone(self) -> "Node":
        spec = copy.copy(self.spec)
        spec.taints = [Taint(t.key, t.value, t.effect) for t in self.spec.taints]
        return Node(
            metadata=self.metadata.clone(),
            spec=spec,
            status=NodeStatus(self.status.capacity.clone(),
                              self.status.allocatable.clone(),
                              dict(self.status.images)),
        )


@dataclass
class Container:
    name: str = "main"
    image: str = ""
    requests: ResourceList = field(default_factory=ResourceList)
    limits: ResourceList = field(default_factory=ResourceList)
    ports: List[int] = field(default_factory=list)


@dataclass
class LabelSelectorRequirement:
    key: str
    operator: str  # In, NotIn, Exists, DoesNotExist, Gt, Lt
    values: List[str] = field(default_factory=list)


def _match_expression(req: LabelSelectorRequirement,
                      labels: Dict[str, str]) -> bool:
    val = labels.get(req.key)
    if req.operator == "In":
        return val is not None and val in req.values
    if req.operator == "NotIn":
        return val is None or val not in req.values
    if req.operator == "Exists":
        return val is not None
    if req.operator == "DoesNotExist":
        return val is None
    if req.operator in ("Gt", "Lt"):
        # an unparsable operand or label value is no match, never an error
        try:
            lhs = int(val)  # type: ignore[arg-type]
            rhs = int(req.values[0])
        except (TypeError, ValueError, IndexError):
            return False
        return lhs > rhs if req.operator == "Gt" else lhs < rhs
    return False


@dataclass
class NodeSelectorTerm:
    match_expressions: List[LabelSelectorRequirement] = field(
        default_factory=list)

    def matches(self, node_labels: Dict[str, str]) -> bool:
        return all(_match_expression(r, node_labels)
                   for r in self.match_expressions)


@dataclass
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass
class NodeAffinity:
    # required: OR over terms; None means no requirement
    required_terms: Optional[List[NodeSelectorTerm]] = None
    preferred: List[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass
class LabelSelector:
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelSelectorRequirement] = field(
        default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        return (all(labels.get(k) == v for k, v in self.match_labels.items())
                and all(_match_expression(r, labels)
                        for r in self.match_expressions))


@dataclass
class PodAffinityTerm:
    label_selector: LabelSelector = field(default_factory=LabelSelector)
    topology_key: str = "kubernetes.io/hostname"
    namespaces: List[str] = field(default_factory=list)


@dataclass
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class PodAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class PodAntiAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


@dataclass
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = ""
    # DoNotSchedule | ScheduleAnyway
    when_unsatisfiable: str = "DoNotSchedule"
    label_selector: LabelSelector = field(default_factory=LabelSelector)


@dataclass
class GangSpec:
    """All-or-nothing coscheduling group: a gang is identified by (pod
    namespace, name); ``size`` members must all be placed before any binds,
    and ``ttl_s`` bounds how long a partial gang may hold capacity.  The
    port's wave and scan drivers read only the identity (the admission
    belongs to the engine's Permit point)."""

    name: str = ""
    size: int = 1
    ttl_s: float = 30.0


@dataclass
class PodSpec:
    node_name: str = ""  # set by binding
    containers: List[Container] = field(default_factory=list)
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Toleration] = field(default_factory=list)
    affinity: Optional[Affinity] = None
    topology_spread_constraints: List[TopologySpreadConstraint] = field(
        default_factory=list)
    #: names of the PersistentVolumeClaims the pod mounts
    volumes: List[str] = field(default_factory=list)
    gang: Optional["GangSpec"] = None
    priority: int = 0


def _clone_pod_spec(spec: PodSpec) -> PodSpec:
    return PodSpec(
        node_name=spec.node_name,
        containers=[Container(c.name, c.image, c.requests.clone(),
                              c.limits.clone(), list(c.ports))
                    for c in spec.containers],
        node_selector=dict(spec.node_selector),
        tolerations=[Toleration(t.key, t.operator, t.value, t.effect)
                     for t in spec.tolerations],
        affinity=(None if spec.affinity is None
                  else copy.deepcopy(spec.affinity)),
        topology_spread_constraints=(
            copy.deepcopy(spec.topology_spread_constraints)
            if spec.topology_spread_constraints else []),
        volumes=list(spec.volumes),
        gang=None if spec.gang is None else GangSpec(
            spec.gang.name, spec.gang.size, spec.gang.ttl_s),
        priority=spec.priority,
    )


POD_PENDING = "Pending"
POD_RUNNING = "Running"


@dataclass
class PodStatus:
    phase: str = POD_PENDING
    #: set by a successful PostFilter (preemption): the node the pod is
    #: expected to land on once its victims are gone
    nominated_node_name: str = ""


@dataclass
class Pod:
    metadata: ObjectMeta
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    def clone(self) -> "Pod":
        return Pod(self.metadata.clone(), _clone_pod_spec(self.spec),
                   PodStatus(self.status.phase,
                             self.status.nominated_node_name))

    def resource_requests(self) -> ResourceList:
        """Sum of container requests, with ``pods`` floored at 1 (the
        non-zero scorer defaults are applied by the table, not here)."""
        total = ResourceList()
        for c in self.spec.containers:
            total.add(c.requests)
        total.pods = max(total.pods, 1)
        return total


def gang_key(pod: Any) -> Optional[str]:
    """'namespace/gangname' for a gang member, None for singletons and for
    a gang with an empty name."""
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


@dataclass
class PVSpec:
    capacity: int = 0  # bytes
    claim_ref: str = ""  # namespace/name of the bound claim
    #: node labels a consuming pod's node must carry (the PV's required
    #: node affinity, collapsed to match-labels form)
    required_node_labels: Dict[str, str] = field(default_factory=dict)
    #: "ebs" / "gcepd" / "azuredisk" count against their per-cloud attach
    #: limits; anything else is generic
    driver: str = ""


@dataclass
class PersistentVolume:
    metadata: ObjectMeta
    spec: PVSpec = field(default_factory=PVSpec)

    def clone(self) -> "PersistentVolume":
        return PersistentVolume(
            self.metadata.clone(),
            PVSpec(self.spec.capacity, self.spec.claim_ref,
                   dict(self.spec.required_node_labels), self.spec.driver))


@dataclass
class PVCSpec:
    request: int = 0  # bytes
    volume_name: str = ""
    #: read-only mounts of one volume may share a node
    read_only: bool = False
    storage_class_name: str = ""


@dataclass
class PVCStatus:
    phase: str = "Pending"


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta
    spec: PVCSpec = field(default_factory=PVCSpec)
    status: PVCStatus = field(default_factory=PVCStatus)

    def clone(self) -> "PersistentVolumeClaim":
        return PersistentVolumeClaim(
            self.metadata.clone(), copy.copy(self.spec),
            PVCStatus(self.status.phase))


@dataclass
class LeaseSpec:
    """coordination.k8s.io/v1 Lease subset (JAX ``api/objects.py:695``):
    a TTL'd, CAS-renewed claim.  Expiry is evaluated by READERS
    (``renew_time + ttl_s < now``): the store never reaps leases, and
    whoever observes one stale may try a takeover (another
    ``expected_rv`` CAS, 409-arbitrated)."""

    #: identity of the current holder ('' = unheld)
    holder: str = ""
    #: seconds a renewal stays valid (leaseDurationSeconds)
    ttl_s: float = 10.0
    #: wall-clock (time.time) of the holder's acquisition
    acquire_time: float = 0.0
    #: wall-clock (time.time) of the last renewal — the expiry anchor
    renew_time: float = 0.0
    #: number of holder changes (leaseTransitions)
    transitions: int = 0
    #: the holder's published epoch
    epoch: int = 0


@dataclass
class Lease:
    metadata: ObjectMeta
    spec: LeaseSpec = field(default_factory=LeaseSpec)
    kind = "Lease"

    @property
    def name(self) -> str:
        return self.metadata.name

    def expired(self, now: float) -> bool:
        return self.spec.renew_time + self.spec.ttl_s < now

    def clone(self) -> "Lease":
        return Lease(self.metadata.clone(), copy.copy(self.spec))


@dataclass
class Binding:
    """The bind subresource's request.  ``expected_rv``: the pod's
    resource_version the placement was computed against; when set, the
    bind commits only if the pod is still at that version."""

    pod_name: str
    pod_namespace: str
    node_name: str
    expected_rv: Optional[int] = None


@dataclass
class Event:
    """An events.k8s.io/v1 Event the scheduler records (``regarding``:
    the ``namespace/name`` of the object it is about, '' for lifecycle
    events)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    type: str = "Normal"  # Normal | Warning
    reason: str = ""
    message: str = ""
    regarding: str = ""

    def clone(self) -> "Event":
        return Event(self.metadata.clone(), self.type, self.reason,
                     self.message, self.regarding)


def make_gang_pods(
    gang_name: str,
    size: int,
    namespace: str = "default",
    ttl_s: float = 30.0,
    requests: Optional[Dict[str, Any]] = None,
    labels: Optional[Dict[str, str]] = None,
    **spec_kwargs: Any,
) -> List[Pod]:
    """``size`` member pods ``{gang_name}-{i}`` of one gang."""
    return [
        make_pod(
            f"{gang_name}-{i}",
            namespace=namespace,
            requests=requests,
            labels=labels,
            gang=GangSpec(gang_name, size, ttl_s),
            **spec_kwargs,
        )
        for i in range(size)
    ]
