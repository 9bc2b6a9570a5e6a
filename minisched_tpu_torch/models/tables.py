"""Struct-of-arrays cluster state on the device: NodeTable / PodTable.

The counterpart of ``minisched_tpu/models/tables.py``: the same fields,
shapes, dtypes and padding rules (``pad_to``, multiples of 128), built
from the same host encoders, so every column is byte-equal to the JAX
table's.  Two deliberate differences:

* ``seed`` (u32 in the JAX table) is carried as ``torch.int32`` holding the
  same bits, because torch's uint32 support is thin; the kernels read it
  as ``unsigned`` and the plain twins widen it to int64.
* ``batched_device_put`` becomes ``HostTable.to_device``: the host encoder
  writes every column into ONE flat int32 buffer, which goes to the card
  as one pinned, non-blocking copy and is split there into views (bools
  widen to int32 on the wire, uint32 rides as its bit pattern, all-zero
  columns are made on the device and never shipped).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from minisched_tpu_torch import resolve_device
from minisched_tpu_torch.api.objects import (
    DEFAULT_POD_CPU_REQUEST,
    DEFAULT_POD_MEMORY_REQUEST,
    MIB,
    ResourceList,
    gang_key,
)
from minisched_tpu_torch.utils.hashing import (
    fnv1a32,
    name_suffix_batch,
    pod_seed_batch,
)
from minisched_tpu_torch.utils.hashing import name_suffix as _name_suffix

# upstream GetNonzeroRequests defaults in device units (scorers only)
DEFAULT_NONZERO_CPU = DEFAULT_POD_CPU_REQUEST  # milli-CPU
DEFAULT_NONZERO_MEM_MIB = DEFAULT_POD_MEMORY_REQUEST // MIB

# fixed per-object capacities for variable-length fields; overflow raises
# at table-build time
MAX_TAINTS = 8
MAX_TOLERATIONS = 8
MAX_LABELS = 16
MAX_IMAGES = 8  # images cached per node (ImageLocality)
MAX_CONTAINERS = 4  # containers per pod
MAX_PORTS = 8  # host ports per pod / in-use ports tracked per node
MAX_AFF_TERMS = 4  # required node-affinity NodeSelectorTerms per pod
MAX_PREF_TERMS = 4  # preferred node-affinity terms per pod
MAX_AFF_REQS = 4  # match expressions per term
MAX_AFF_VALS = 4  # operand values per In/NotIn expression

EFFECT_NONE = 0
EFFECT_NO_SCHEDULE = 1
EFFECT_PREFER_NO_SCHEDULE = 2
EFFECT_NO_EXECUTE = 3
_EFFECT_CODES = {
    "": EFFECT_NONE,
    "NoSchedule": EFFECT_NO_SCHEDULE,
    "PreferNoSchedule": EFFECT_PREFER_NO_SCHEDULE,
    "NoExecute": EFFECT_NO_EXECUTE,
}

TOLERATION_OP_EQUAL_CODE = 0
TOLERATION_OP_EXISTS_CODE = 1

# node-affinity / label-selector expression operator codes
OP_IN = 0
OP_NOT_IN = 1
OP_EXISTS = 2
OP_DOES_NOT_EXIST = 3
OP_GT = 4
OP_LT = 5
#: an expression that can never match (Gt/Lt with a non-integer operand)
OP_INVALID = 6
_OP_CODES = {
    "In": OP_IN,
    "NotIn": OP_NOT_IN,
    "Exists": OP_EXISTS,
    "DoesNotExist": OP_DOES_NOT_EXIST,
    "Gt": OP_GT,
    "Lt": OP_LT,
}


def pad_to(n: int, multiple: int = 128) -> int:
    if n == 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class NodeTable:
    """All scheduler-relevant node state, shape (N,) or (N, K); the field
    comments of ``minisched_tpu.models.tables.NodeTable`` apply."""

    name_hash: Any  # i32[N]
    alloc_cpu: Any  # i32[N] milli-cpu
    alloc_mem: Any  # i32[N] MiB
    alloc_eph: Any  # i32[N] MiB
    alloc_pods: Any  # i32[N]
    req_cpu: Any  # i32[N] sum of assigned pods
    req_mem: Any  # i32[N]
    req_eph: Any  # i32[N]
    req_pods: Any  # i32[N]
    nzreq_cpu: Any  # i32[N] with the non-zero defaults applied
    nzreq_mem: Any  # i32[N]
    unschedulable: Any  # bool[N]
    suffix: Any  # i32[N] trailing digit of the name, -1 if none
    slice_hash: Any  # i32[N]
    torus_x: Any  # i32[N]
    torus_y: Any  # i32[N]
    torus_z: Any  # i32[N]
    host_index: Any  # i32[N]
    slice_dx: Any  # i32[N]
    slice_dy: Any  # i32[N]
    slice_dz: Any  # i32[N]
    profile_id: Any  # i32[N] node → (labels, taints) profile row
    prof_taint_key: Any  # i32[Dp, MAX_TAINTS]
    prof_taint_value: Any  # i32[Dp, MAX_TAINTS]
    prof_taint_effect: Any  # i32[Dp, MAX_TAINTS]
    prof_num_taints: Any  # i32[Dp]
    prof_label_key: Any  # i32[Dp, MAX_LABELS]
    prof_label_value: Any  # i32[Dp, MAX_LABELS]
    prof_label_numval: Any  # i32[Dp, MAX_LABELS]
    prof_label_num_ok: Any  # bool[Dp, MAX_LABELS]
    prof_num_labels: Any  # i32[Dp]
    image_key: Any  # i32[N, MAX_IMAGES]
    image_size_mb: Any  # i32[N, MAX_IMAGES]
    num_images: Any  # i32[N]
    used_port: Any  # i32[N, MAX_PORTS]
    num_used_ports: Any  # i32[N]
    valid: Any  # bool[N]

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])


@dataclass
class PodTable:
    """All scheduler-relevant pending-pod state, shape (P,) or (P, K)."""

    req_cpu: Any  # i32[P]
    req_mem: Any  # i32[P] MiB
    req_eph: Any  # i32[P] MiB
    req_pods: Any  # i32[P]
    suffix: Any  # i32[P] trailing digit of the name, -1 if none
    spec_node_name: Any  # i32[P] fnv of spec.node_name, 0 = unset
    tol_key: Any  # i32[P, MAX_TOLERATIONS]
    tol_value: Any  # i32[P, MAX_TOLERATIONS]
    tol_effect: Any  # i32[P, MAX_TOLERATIONS]
    tol_op: Any  # i32[P, MAX_TOLERATIONS] 0=Equal 1=Exists
    tol_empty_key: Any  # bool[P, MAX_TOLERATIONS]
    num_tols: Any  # i32[P]
    sel_key: Any  # i32[P, MAX_LABELS]
    sel_value: Any  # i32[P, MAX_LABELS]
    num_sel: Any  # i32[P]
    aff_required: Any  # bool[P]
    aff_key: Any  # i32[P, MAX_AFF_TERMS, MAX_AFF_REQS]
    aff_op: Any  # i32[P, T, R]
    aff_vals: Any  # i32[P, T, R, MAX_AFF_VALS]
    aff_nvals: Any  # i32[P, T, R]
    aff_numval: Any  # i32[P, T, R]
    aff_nreqs: Any  # i32[P, T]
    aff_nterms: Any  # i32[P]
    pref_weight: Any  # i32[P, MAX_PREF_TERMS]
    pref_key: Any  # i32[P, MAX_PREF_TERMS, MAX_AFF_REQS]
    pref_op: Any  # i32[P, T, R]
    pref_vals: Any  # i32[P, T, R, MAX_AFF_VALS]
    pref_nvals: Any  # i32[P, T, R]
    pref_numval: Any  # i32[P, T, R]
    pref_nreqs: Any  # i32[P, T]
    pref_nterms: Any  # i32[P]
    image_key: Any  # i32[P, MAX_CONTAINERS]
    num_containers: Any  # i32[P]
    port: Any  # i32[P, MAX_PORTS]
    num_ports: Any  # i32[P]
    gang_id: Any  # i32[P]
    gang_slice: Any  # i32[P]
    gang_sx: Any  # i32[P]
    gang_sy: Any  # i32[P]
    gang_sz: Any  # i32[P]
    gang_n: Any  # i32[P]
    seed: Any  # i32[P] holding the u32 tie-break seed's bits
    valid: Any  # bool[P]

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])


def table_columns(table) -> Dict[str, torch.Tensor]:
    """{field name: tensor} in declaration order."""
    return {f.name: getattr(table, f.name) for f in fields(table)}


# ---------------------------------------------------------------------------
# Host → device transfer
# ---------------------------------------------------------------------------

Meta = Tuple[str, str, Tuple[int, ...]]  # (column, wire kind, shape)


def _wire_kind(dtype) -> str:
    if dtype == np.bool_:
        return "bool"
    if dtype == np.uint32:
        return "uint32"
    if dtype == np.int32:
        return "int32"
    raise TypeError(f"dtype {dtype} does not ride the int32 wire format")


@dataclass
class HostTable:
    """A table still on the host: every live column packed into one flat
    int32 buffer, plus the all-zero columns the device makes itself."""

    cls: type  # NodeTable or PodTable
    metas: Tuple[Meta, ...]
    zero_metas: Tuple[Meta, ...]
    flat: np.ndarray  # int32[total]

    @staticmethod
    def pack(cls: type, host: Dict[str, np.ndarray],
             zero_metas: Tuple[Meta, ...] = ()) -> "HostTable":
        arrays = {k: np.asarray(v) for k, v in host.items()}
        metas = tuple(
            (k, _wire_kind(v.dtype), tuple(v.shape)) for k, v in arrays.items()
        )
        parts = [
            np.ascontiguousarray(v).ravel().astype(np.int32)
            if v.dtype == np.bool_
            else np.ascontiguousarray(v).ravel().view(np.int32)
            for v in arrays.values()
        ]
        flat = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        return HostTable(cls, metas, tuple(zero_metas), flat)

    def to_device(self, device) -> Any:
        """One host→device copy of the flat buffer (pinned and
        non-blocking on a card), then a split into column views."""
        device = torch.device(device)
        flat = torch.from_numpy(self.flat)
        if device.type == "cuda":
            flat = flat.pin_memory().to(device, non_blocking=True)
        else:
            flat = flat.to(device)
        cols: Dict[str, torch.Tensor] = {}
        off = 0
        for name, kind, shape in self.metas:
            size = math.prod(shape)
            seg = flat[off: off + size].view(shape)
            off += size
            cols[name] = seg != 0 if kind == "bool" else seg
        for name, kind, shape in self.zero_metas:
            dtype = torch.bool if kind == "bool" else torch.int32
            cols[name] = torch.zeros(shape, dtype=dtype, device=device)
        return self.cls(**cols)


def tables_from_numpy(node_cols: Dict[str, Any], pod_cols: Dict[str, Any],
                      device) -> Tuple[NodeTable, PodTable]:
    """The JAX tables' columns (``np.asarray`` per field) as the port's
    tables on ``device`` — u32 ``seed`` keeps its bits as int32."""
    device = resolve_device(device)
    nodes = HostTable.pack(NodeTable, node_cols).to_device(device)
    pods = HostTable.pack(PodTable, pod_cols).to_device(device)
    return nodes, pods


# ---------------------------------------------------------------------------
# NodeTable encoder (host side, numpy)
# ---------------------------------------------------------------------------


def _node_table_skeleton(cap: int, prof_cap: int) -> Dict[str, np.ndarray]:
    def zeros(shape, dtype=np.int32):
        return np.zeros(shape, dtype)

    return dict(
        name_hash=zeros(cap),
        alloc_cpu=zeros(cap), alloc_mem=zeros(cap), alloc_eph=zeros(cap),
        alloc_pods=zeros(cap),
        req_cpu=zeros(cap), req_mem=zeros(cap), req_eph=zeros(cap),
        req_pods=zeros(cap), nzreq_cpu=zeros(cap), nzreq_mem=zeros(cap),
        unschedulable=np.zeros(cap, bool), suffix=np.full(cap, -1, np.int32),
        slice_hash=zeros(cap), torus_x=zeros(cap), torus_y=zeros(cap),
        torus_z=zeros(cap), host_index=np.full(cap, -1, np.int32),
        slice_dx=zeros(cap), slice_dy=zeros(cap), slice_dz=zeros(cap),
        profile_id=zeros(cap),
        prof_taint_key=zeros((prof_cap, MAX_TAINTS)),
        prof_taint_value=zeros((prof_cap, MAX_TAINTS)),
        prof_taint_effect=zeros((prof_cap, MAX_TAINTS)),
        prof_num_taints=zeros(prof_cap),
        prof_label_key=zeros((prof_cap, MAX_LABELS)),
        prof_label_value=zeros((prof_cap, MAX_LABELS)),
        prof_label_numval=zeros((prof_cap, MAX_LABELS)),
        prof_label_num_ok=np.zeros((prof_cap, MAX_LABELS), bool),
        prof_num_labels=zeros(prof_cap),
        image_key=zeros((cap, MAX_IMAGES)),
        image_size_mb=zeros((cap, MAX_IMAGES)),
        num_images=zeros(cap),
        used_port=zeros((cap, MAX_PORTS)), num_used_ports=zeros(cap),
        valid=np.zeros(cap, bool),
    )


class _ProfileRegistry:
    """Dedupes nodes into (labels, taints) profiles: pass 1 assigns ids
    (``pid_for``), pass 2 encodes one row per profile (``encode_rows``)."""

    def __init__(self) -> None:
        self.ids: Dict[Tuple, int] = {}
        self.nodes: List[Any] = []  # representative node per profile

    def pid_for(self, node: Any) -> int:
        labels = node.metadata.labels
        if len(labels) > MAX_LABELS:
            raise ValueError(f"node {node.metadata.name}: >{MAX_LABELS} labels")
        taints = node.spec.taints
        if len(taints) > MAX_TAINTS:
            raise ValueError(f"node {node.metadata.name}: >{MAX_TAINTS} taints")
        sig = (
            tuple(sorted(labels.items())),
            # taint matching is order-independent: [A,B] and [B,A] share
            tuple(sorted((t.key, t.value, t.effect) for t in taints)),
        )
        pid = self.ids.get(sig)
        if pid is None:
            pid = self.ids[sig] = len(self.nodes)
            self.nodes.append(node)
        return pid

    @property
    def capacity(self) -> int:
        # multiples of 64, as the JAX table: Dp is a shape its executables
        # are compiled for, and equal shapes keep the columns comparable
        return pad_to(max(len(self.nodes), 1), 64)

    def encode_rows(self, t: Dict[str, np.ndarray]) -> None:
        for pid, node in enumerate(self.nodes):
            for j, taint in enumerate(node.spec.taints):
                t["prof_taint_key"][pid, j] = fnv1a32(taint.key)
                t["prof_taint_value"][pid, j] = fnv1a32(taint.value)
                t["prof_taint_effect"][pid, j] = _EFFECT_CODES[taint.effect]
            t["prof_num_taints"][pid] = len(node.spec.taints)
            labels = node.metadata.labels
            for j, (k, v) in enumerate(sorted(labels.items())):
                t["prof_label_key"][pid, j] = fnv1a32(k)
                t["prof_label_value"][pid, j] = fnv1a32(v)
                try:
                    t["prof_label_numval"][pid, j] = int(v)
                    t["prof_label_num_ok"][pid, j] = True
                except ValueError:
                    pass
            t["prof_num_labels"][pid] = len(labels)


def _prof_cap(reg: _ProfileRegistry, requested: Optional[int]) -> int:
    if requested is None:
        return reg.capacity
    if len(reg.nodes) > requested:
        raise ValueError(
            f"{len(reg.nodes)} profiles exceed requested capacity {requested}"
        )
    return requested


def _encode_node_static(t: Dict[str, np.ndarray], i: int, node: Any,
                        pid: int) -> None:
    t["name_hash"][i] = fnv1a32(node.metadata.name)
    alloc = node.status.allocatable
    t["alloc_cpu"][i] = alloc.milli_cpu
    t["alloc_mem"][i] = alloc.memory // MIB
    t["alloc_eph"][i] = alloc.ephemeral_storage // MIB
    t["alloc_pods"][i] = alloc.pods
    t["unschedulable"][i] = node.spec.unschedulable
    t["suffix"][i] = _name_suffix(node.metadata.name)
    has_slice = bool(node.spec.slice_id)
    t["slice_hash"][i] = fnv1a32(node.spec.slice_id) if has_slice else 0
    t["torus_x"][i] = node.spec.torus_x if has_slice else 0
    t["torus_y"][i] = node.spec.torus_y if has_slice else 0
    t["torus_z"][i] = node.spec.torus_z if has_slice else 0
    t["host_index"][i] = node.spec.host_index
    t["slice_dx"][i] = node.spec.slice_dx if has_slice else 0
    t["slice_dy"][i] = node.spec.slice_dy if has_slice else 0
    t["slice_dz"][i] = node.spec.slice_dz if has_slice else 0
    t["profile_id"][i] = pid
    images = node.status.images
    if len(images) > MAX_IMAGES:
        raise ValueError(f"node {node.metadata.name}: >{MAX_IMAGES} images")
    for j, (img, size) in enumerate(sorted(images.items())):
        t["image_key"][i, j] = fnv1a32(img)
        t["image_size_mb"][i, j] = size // MIB
    t["num_images"][i] = len(images)
    t["valid"][i] = True


def _encode_node_ports(t: Dict[str, np.ndarray], i: int, node_name: str,
                       pods) -> None:
    used_ports: List[int] = []
    for p in pods:
        for c in p.spec.containers:
            used_ports.extend(c.ports)
    if len(used_ports) > MAX_PORTS:
        raise ValueError(f"node {node_name}: >{MAX_PORTS} used ports")
    for j, port in enumerate(used_ports):
        t["used_port"][i, j] = port
    t["num_used_ports"][i] = len(used_ports)


def pack_node_table(
    nodes: Sequence[Any],
    pods_by_node: Optional[Dict[str, List[Any]]] = None,
    capacity: Optional[int] = None,
    prof_capacity: Optional[int] = None,
) -> Tuple[HostTable, List[str]]:
    """The host half of ``build_node_table``: (HostTable, node names)."""
    pods_by_node = pods_by_node or {}
    n = len(nodes)
    cap = capacity or pad_to(n)
    if n > cap:
        raise ValueError(f"{n} nodes exceed table capacity {cap}")
    reg = _ProfileRegistry()
    pids = [reg.pid_for(node) for node in nodes]
    t = _node_table_skeleton(cap, _prof_cap(reg, prof_capacity))
    reg.encode_rows(t)
    names: List[str] = []
    for i, node in enumerate(nodes):
        names.append(node.metadata.name)
        _encode_node_static(t, i, node, pids[i])
        assigned = pods_by_node.get(node.metadata.name, ())
        for p in assigned:
            req = p.resource_requests()
            t["req_cpu"][i] += req.milli_cpu
            t["req_mem"][i] += req.memory // MIB
            t["req_eph"][i] += req.ephemeral_storage // MIB
            t["req_pods"][i] += 1
            t["nzreq_cpu"][i] += req.milli_cpu or DEFAULT_NONZERO_CPU
            t["nzreq_mem"][i] += (req.memory // MIB) or DEFAULT_NONZERO_MEM_MIB
        _encode_node_ports(t, i, node.metadata.name, assigned)
    return HostTable.pack(NodeTable, t), names


def build_node_table(
    nodes: Sequence[Any],
    pods_by_node: Optional[Dict[str, List[Any]]] = None,
    capacity: Optional[int] = None,
    prof_capacity: Optional[int] = None,
    device=None,
) -> Tuple[NodeTable, List[str]]:
    """NodeTable on ``device`` from Node objects (+ already-assigned pods).
    Returns (table, node_names); row i is ``nodes[i]``."""
    device = resolve_device(device)
    host, names = pack_node_table(nodes, pods_by_node, capacity, prof_capacity)
    return host.to_device(device), names


# ---------------------------------------------------------------------------
# PodTable encoder (host side, numpy)
# ---------------------------------------------------------------------------


def _pod_is_simple(pod: Any) -> bool:
    """Default-shaped spec with at most resource requests: no tolerations,
    selector, affinity, spread constraints, host ports, pinned node or
    gang, and one container at most."""
    spec = pod.spec
    return (
        not spec.tolerations
        and not spec.node_selector
        and spec.affinity is None
        and not spec.topology_spread_constraints
        and not spec.node_name
        and spec.gang is None
        and len(spec.containers) <= 1
        and not (spec.containers and spec.containers[0].ports)
    )


def _zero_pod_metas(cap: int) -> Tuple[Meta, ...]:
    """Every PodTable column that is all-zero for simple pods."""
    TR = (cap, MAX_AFF_TERMS, MAX_AFF_REQS)
    PR = (cap, MAX_PREF_TERMS, MAX_AFF_REQS)
    i32, b = "int32", "bool"
    return (
        ("spec_node_name", i32, (cap,)),
        ("tol_key", i32, (cap, MAX_TOLERATIONS)),
        ("tol_value", i32, (cap, MAX_TOLERATIONS)),
        ("tol_effect", i32, (cap, MAX_TOLERATIONS)),
        ("tol_op", i32, (cap, MAX_TOLERATIONS)),
        ("tol_empty_key", b, (cap, MAX_TOLERATIONS)),
        ("num_tols", i32, (cap,)),
        ("sel_key", i32, (cap, MAX_LABELS)),
        ("sel_value", i32, (cap, MAX_LABELS)),
        ("num_sel", i32, (cap,)),
        ("aff_required", b, (cap,)),
        ("aff_key", i32, TR),
        ("aff_op", i32, TR),
        ("aff_vals", i32, TR + (MAX_AFF_VALS,)),
        ("aff_nvals", i32, TR),
        ("aff_numval", i32, TR),
        ("aff_nreqs", i32, TR[:2]),
        ("aff_nterms", i32, (cap,)),
        ("pref_weight", i32, (cap, MAX_PREF_TERMS)),
        ("pref_key", i32, PR),
        ("pref_op", i32, PR),
        ("pref_vals", i32, PR + (MAX_AFF_VALS,)),
        ("pref_nvals", i32, PR),
        ("pref_numval", i32, PR),
        ("pref_nreqs", i32, PR[:2]),
        ("pref_nterms", i32, (cap,)),
        ("port", i32, (cap, MAX_PORTS)),
        ("num_ports", i32, (cap,)),
        ("gang_id", i32, (cap,)),
        ("gang_slice", i32, (cap,)),
        ("gang_sx", i32, (cap,)),
        ("gang_sy", i32, (cap,)),
        ("gang_sz", i32, (cap,)),
        ("gang_n", i32, (cap,)),
    )


def _image_keys(pods: Sequence[Any]) -> List[int]:
    return [
        fnv1a32(pod.spec.containers[0].image)
        if pod.spec.containers and pod.spec.containers[0].image
        else 0
        for pod in pods
    ]


def _pack_pod_table_fast(pods: Sequence[Any], cap: int) -> HostTable:
    """Columnar fast path for simple pods: only the live columns are
    packed; the constraint columns are made all-zero on the device."""
    p = len(pods)
    names = [pod.metadata.name for pod in pods]
    # a simple pod has at most one container, so its request sum is that
    # container's requests (pods floored at 1 below, as resource_requests)
    zero = ResourceList()
    reqs = [pod.spec.containers[0].requests if pod.spec.containers else zero
            for pod in pods]

    def col(values, dtype=np.int32, fill=0):
        arr = np.full(cap, fill, dtype)
        arr[:p] = values
        return arr

    host = dict(
        req_cpu=col([r.milli_cpu for r in reqs]),
        req_mem=col([r.memory // MIB for r in reqs]),
        req_eph=col([r.ephemeral_storage // MIB for r in reqs]),
        req_pods=col(1),
        suffix=col(name_suffix_batch(names), fill=-1),
        num_containers=col([len(pod.spec.containers) for pod in pods]),
        seed=col(
            pod_seed_batch([pod.metadata.uid or pod.metadata.name
                            for pod in pods]),
            np.uint32,
        ),
        valid=col(True, bool),
    )
    img = np.zeros((cap, MAX_CONTAINERS), np.int32)
    img[:p, 0] = _image_keys(pods)
    host["image_key"] = img
    return HostTable.pack(PodTable, host, _zero_pod_metas(cap))


def _encode_terms(t: Dict[str, np.ndarray], prefix: str, i: int, terms,
                  max_terms: int, what: str) -> None:
    """NodeSelectorTerms (or preferred-term preferences) into the
    ``{prefix}_*`` expression arrays of row ``i``."""
    if len(terms) > max_terms:
        raise ValueError(f"{what}: >{max_terms} node-affinity terms")
    for j, term in enumerate(terms):
        reqs = term.match_expressions
        if len(reqs) > MAX_AFF_REQS:
            raise ValueError(f"{what}: >{MAX_AFF_REQS} requirements per term")
        for r, req in enumerate(reqs):
            t[f"{prefix}_key"][i, j, r] = fnv1a32(req.key)
            t[f"{prefix}_op"][i, j, r] = _OP_CODES[req.operator]
            if req.operator in ("In", "NotIn"):
                if len(req.values) > MAX_AFF_VALS:
                    raise ValueError(
                        f"{what}: >{MAX_AFF_VALS} values per expression"
                    )
                for v, val in enumerate(req.values):
                    t[f"{prefix}_vals"][i, j, r, v] = fnv1a32(val)
                t[f"{prefix}_nvals"][i, j, r] = len(req.values)
            elif req.operator in ("Gt", "Lt"):
                try:
                    t[f"{prefix}_numval"][i, j, r] = int(req.values[0])
                except (ValueError, IndexError, OverflowError):
                    t[f"{prefix}_op"][i, j, r] = OP_INVALID
        t[f"{prefix}_nreqs"][i, j] = len(reqs)
    t[f"{prefix}_nterms"][i] = len(terms)


_AFF_FIELDS = (
    "aff_required", "aff_key", "aff_op", "aff_vals", "aff_nvals",
    "aff_numval", "aff_nreqs", "aff_nterms", "pref_weight", "pref_key",
    "pref_op", "pref_vals", "pref_nvals", "pref_numval", "pref_nreqs",
    "pref_nterms",
)


def _terms_sig(terms):
    return tuple(
        tuple((r.key, r.operator, tuple(r.values))
              for r in term.match_expressions)
        for term in terms
    )


def _pack_pod_table_full(pods: Sequence[Any], cap: int) -> HostTable:
    """The general encoder: every column, with the per-pod loop touching
    only the optional fields a pod carries."""
    p = len(pods)

    def zeros(shape, dtype=np.int32):
        return np.zeros(shape, dtype)

    TR = (cap, MAX_AFF_TERMS, MAX_AFF_REQS)
    PR = (cap, MAX_PREF_TERMS, MAX_AFF_REQS)
    t = dict(
        req_cpu=zeros(cap), req_mem=zeros(cap), req_eph=zeros(cap),
        req_pods=zeros(cap),
        suffix=np.full(cap, -1, np.int32), spec_node_name=zeros(cap),
        tol_key=zeros((cap, MAX_TOLERATIONS)),
        tol_value=zeros((cap, MAX_TOLERATIONS)),
        tol_effect=zeros((cap, MAX_TOLERATIONS)),
        tol_op=zeros((cap, MAX_TOLERATIONS)),
        tol_empty_key=np.zeros((cap, MAX_TOLERATIONS), bool),
        num_tols=zeros(cap),
        sel_key=zeros((cap, MAX_LABELS)), sel_value=zeros((cap, MAX_LABELS)),
        num_sel=zeros(cap),
        aff_required=np.zeros(cap, bool),
        aff_key=zeros(TR), aff_op=zeros(TR),
        aff_vals=zeros(TR + (MAX_AFF_VALS,)),
        aff_nvals=zeros(TR), aff_numval=zeros(TR),
        aff_nreqs=zeros(TR[:2]), aff_nterms=zeros(cap),
        pref_weight=zeros((cap, MAX_PREF_TERMS)),
        pref_key=zeros(PR), pref_op=zeros(PR),
        pref_vals=zeros(PR + (MAX_AFF_VALS,)),
        pref_nvals=zeros(PR), pref_numval=zeros(PR),
        pref_nreqs=zeros(PR[:2]), pref_nterms=zeros(cap),
        image_key=zeros((cap, MAX_CONTAINERS)), num_containers=zeros(cap),
        port=zeros((cap, MAX_PORTS)), num_ports=zeros(cap),
        gang_id=zeros(cap), gang_slice=zeros(cap),
        gang_sx=zeros(cap), gang_sy=zeros(cap), gang_sz=zeros(cap),
        gang_n=zeros(cap),
        seed=np.zeros(cap, np.uint32), valid=np.zeros(cap, bool),
    )
    names = [pod.metadata.name for pod in pods]
    reqs = [pod.resource_requests() for pod in pods]
    t["req_cpu"][:p] = [r.milli_cpu for r in reqs]
    t["req_mem"][:p] = [r.memory // MIB for r in reqs]
    t["req_eph"][:p] = [r.ephemeral_storage // MIB for r in reqs]
    t["req_pods"][:p] = 1
    t["suffix"][:p] = name_suffix_batch(names)
    t["num_containers"][:p] = [len(pod.spec.containers) for pod in pods]
    t["seed"][:p] = pod_seed_batch(
        [pod.metadata.uid or pod.metadata.name for pod in pods]
    )
    t["valid"][:p] = True
    t["image_key"][:p, 0] = _image_keys(pods)

    # replicas of one deployment share one affinity structure: encode once
    aff_cache: Dict[Any, Dict[str, Any]] = {}
    for i, pod in enumerate(pods):
        if pod.spec.node_name:
            t["spec_node_name"][i] = fnv1a32(pod.spec.node_name)
        tols = pod.spec.tolerations
        if tols:
            if len(tols) > MAX_TOLERATIONS:
                raise ValueError(
                    f"pod {pod.metadata.name}: >{MAX_TOLERATIONS} tolerations"
                )
            for j, tol in enumerate(tols):
                t["tol_key"][i, j] = fnv1a32(tol.key)
                t["tol_value"][i, j] = fnv1a32(tol.value)
                t["tol_effect"][i, j] = _EFFECT_CODES[tol.effect]
                t["tol_op"][i, j] = (
                    TOLERATION_OP_EXISTS_CODE if tol.operator == "Exists"
                    else TOLERATION_OP_EQUAL_CODE
                )
                t["tol_empty_key"][i, j] = tol.key == ""
            t["num_tols"][i] = len(tols)
        sel = pod.spec.node_selector
        if sel:
            if len(sel) > MAX_LABELS:
                raise ValueError(
                    f"pod {pod.metadata.name}: >{MAX_LABELS} selector terms"
                )
            for j, (k, v) in enumerate(sorted(sel.items())):
                t["sel_key"][i, j] = fnv1a32(k)
                t["sel_value"][i, j] = fnv1a32(v)
            t["num_sel"][i] = len(sel)
        aff = pod.spec.affinity
        na = aff.node_affinity if aff is not None else None
        if na is not None:
            sig = (
                None if na.required_terms is None
                else _terms_sig(na.required_terms),
                tuple((pt.weight, *_terms_sig([pt.preference]))
                      for pt in na.preferred),
            )
            cached = aff_cache.get(sig)
            if cached is None:
                what = f"pod {pod.metadata.name}"
                if na.required_terms is not None:
                    t["aff_required"][i] = True
                    _encode_terms(t, "aff", i, na.required_terms,
                                  MAX_AFF_TERMS, what)
                _encode_terms(t, "pref", i,
                              [pt.preference for pt in na.preferred],
                              MAX_PREF_TERMS, what)
                for j, pref in enumerate(na.preferred):
                    t["pref_weight"][i, j] = pref.weight
                aff_cache[sig] = {f: t[f][i].copy() for f in _AFF_FIELDS}
            else:
                for f, val in cached.items():
                    t[f][i] = val
        containers = pod.spec.containers
        if len(containers) > MAX_CONTAINERS:
            raise ValueError(
                f"pod {pod.metadata.name}: >{MAX_CONTAINERS} containers"
            )
        if len(containers) > 1 or (containers and containers[0].ports):
            ports: List[int] = []
            for j, c in enumerate(containers):
                t["image_key"][i, j] = fnv1a32(c.image) if c.image else 0
                ports.extend(c.ports)
            if len(ports) > MAX_PORTS:
                raise ValueError(f"pod {pod.metadata.name}: >{MAX_PORTS} ports")
            for j, port in enumerate(ports):
                t["port"][i, j] = port
            t["num_ports"][i] = len(ports)
        key = gang_key(pod)
        if key is not None:
            # the placed-member aggregates (gang_slice .. gang_n) stay zero:
            # they come with the gang slice of the port
            t["gang_id"][i] = fnv1a32(key)
    return HostTable.pack(PodTable, t)


def pack_pod_table(pods: Sequence[Any],
                   capacity: Optional[int] = None
                   ) -> Tuple[HostTable, List[str]]:
    """The host half of ``build_pod_table``: (HostTable, pod names)."""
    p = len(pods)
    cap = capacity or pad_to(p)
    if p > cap:
        raise ValueError(f"{p} pods exceed table capacity {cap}")
    names = [pod.metadata.name for pod in pods]
    if all(_pod_is_simple(pod) for pod in pods):
        return _pack_pod_table_fast(pods, cap), names
    return _pack_pod_table_full(pods, cap), names


def build_pod_table(pods: Sequence[Any], capacity: Optional[int] = None,
                    device=None) -> Tuple[PodTable, List[str]]:
    """PodTable on ``device`` from Pod objects: (table, pod names)."""
    device = resolve_device(device)
    host, names = pack_pod_table(pods, capacity)
    return host.to_device(device), names
