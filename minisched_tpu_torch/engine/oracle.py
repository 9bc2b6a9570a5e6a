"""Vectorized host oracles, in plain NumPy.

A copy of ``minisched_tpu/engine/oracle.py``: ``headline_oracle``
re-derives the decision rule of the NodeUnschedulable filter + NodeNumber
score with the seeded tie-break straight from the API objects, and
``FullRosterScanOracle`` the sequential-bind placements of the full
default roster (or of config 3's Fit + LeastAllocated chain) on
workloads whose only node-varying scores are the resource scorers: no
tables, no torch, no kernels, fast enough to check every placement of a
100k-pod run.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np

from minisched_tpu_torch.models.tables import (
    DEFAULT_NONZERO_CPU,
    DEFAULT_NONZERO_MEM_MIB,
)
from minisched_tpu_torch.utils.hashing import pod_seed_batch

MAX_NODE_SCORE = 100
FRAC_SCALE = 10_000  # plugins/noderesources.py quantization


class OracleUnsupported(Exception):
    """The workload uses features outside this oracle's modeled chain."""


def mix32_np(seed, idx: np.ndarray) -> np.ndarray:
    """``engine.tiebreak.mix32`` vectorized (uint32 wraparound)."""
    x = np.asarray(seed, np.uint32) ^ (
        np.asarray(idx, np.uint32) * np.uint32(0x9E3779B9)
    )
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def _suffix(name: str) -> int:
    return int(name[-1]) if name and name[-1].isdigit() else -1


def headline_oracle(pods: Sequence[Any], nodes: Sequence[Any]) -> np.ndarray:
    """Choices (node row index, -1 = unschedulable) for the chain
    [NodeUnschedulable] / [NodeNumber], for every pod: among schedulable
    nodes prefer those whose trailing digit matches the pod's, then the
    minimal mix32(pod_seed, node_index), then the lowest index.  Pods
    without a digit suffix error in the scalar Score, so they raise."""
    n = len(nodes)
    unsched = np.fromiter(
        (node.spec.unschedulable for node in nodes), bool, count=n
    )
    node_suf = np.fromiter(
        (_suffix(node.metadata.name) for node in nodes), np.int64, count=n
    )
    feasible = np.flatnonzero(~unsched)
    pod_suf = np.fromiter(
        (_suffix(p.metadata.name) for p in pods), np.int64, count=len(pods)
    )
    if (pod_suf < 0).any():
        raise OracleUnsupported("pod without digit suffix (Score errors)")
    seeds = pod_seed_batch([p.metadata.uid or p.metadata.name for p in pods])

    choices = np.full(len(pods), -1, np.int64)
    if feasible.size == 0:
        return choices
    for d in range(10):
        rows = np.flatnonzero(pod_suf == d)
        if rows.size == 0:
            continue
        cand = feasible[node_suf[feasible] == d]
        if cand.size == 0:
            cand = feasible
        # argmin is the first minimum: lowest index wins hash ties
        hm = mix32_np(seeds[rows, None], cand[None, :])
        choices[rows] = cand[np.argmin(hm, axis=1)]
    return choices


# ---------------------------------------------------------------------------
# full-roster sequential-scan oracle (config5-shaped workloads)
# ---------------------------------------------------------------------------

def _require(cond: bool, what: str) -> None:
    if not cond:
        raise OracleUnsupported(what)


class FullRosterScanOracle:
    """Sequential-bind placements for the default full roster on workloads
    where the node-VARYING score terms are exactly NodeResourcesFit
    (LeastAllocated strategy) + NodeResourcesBalancedAllocation, and the
    active filters are NodeUnschedulable + NodeResourcesFit + NodeAffinity
    (match-labels node selectors only).

    Preconditions (validated; violations raise OracleUnsupported):
    no taints, no node images, no host ports, no volumes/claims, no
    pod/anti-affinity, no topology spread, no preferred node affinity,
    single container.  Under them every other roster plugin scores a
    constant across nodes (TaintToleration's reverse-normalize of all-
    zero counts, ImageLocality with no images, spread/IPA with no
    constraints), so the argmax set — and the scalar engine's decision —
    is fully determined by w·(LeastAllocated + BalancedAllocation) over
    the feasible set, tie-broken by mix32 exactly like
    engine/tiebreak.select_host.

    Placements are sequential-bind exact: pod i scores against node state
    that includes pods < i (the scan/bind-exact semantics of
    minisched.go:32-113's one-at-a-time loop).

    Incremental evaluation: per placement only ONE node's sums change, so
    per-(request-shape) score/fit caches refresh just the dirty rows —
    ~O(candidates) per pod instead of O(N × plugins).
    """

    def __init__(self, nodes: Sequence[Any], default_nz_cpu: int,
                 default_nz_mem_mib: int, with_balanced: bool = True):
        #: with_balanced: include BalancedAllocation in the score (the
        #: full default roster).  False models the config-3 chain
        #: (Fit + LeastAllocated only, scheduler_test.go config shapes).
        self._with_balanced = with_balanced
        n = len(nodes)
        self.n = n
        MIB = 1 << 20
        for node in nodes:
            _require(not node.spec.taints, "node taints")
            _require(not node.status.images, "node images")
        self.unsched = np.fromiter(
            (node.spec.unschedulable for node in nodes), bool, count=n
        )
        self.alloc_cpu = np.fromiter(
            (node.status.allocatable.milli_cpu for node in nodes),
            np.int64, count=n,
        )
        self.alloc_mem = np.fromiter(
            (node.status.allocatable.memory // MIB for node in nodes),
            np.int64, count=n,
        )
        self.alloc_eph = np.fromiter(
            (
                node.status.allocatable.ephemeral_storage // MIB
                for node in nodes
            ),
            np.int64, count=n,
        )
        self.alloc_pods = np.fromiter(
            (node.status.allocatable.pods for node in nodes), np.int64, count=n
        )
        self.labels = [node.metadata.labels for node in nodes]
        # committed state (plain requests for Fit, non-zero for scores)
        self.req_cpu = np.zeros(n, np.int64)
        self.req_mem = np.zeros(n, np.int64)
        self.req_eph = np.zeros(n, np.int64)
        self.req_cnt = np.zeros(n, np.int64)
        self.nzreq_cpu = np.zeros(n, np.int64)
        self.nzreq_mem = np.zeros(n, np.int64)
        self._default_nz_cpu = default_nz_cpu
        self._default_nz_mem = default_nz_mem_mib
        # per-(request shape, selector) groups: cached score/feas arrays
        # refreshed lazily for nodes dirtied since the group's last use
        self._groups: Dict[Tuple, Dict[str, Any]] = {}
        self._version = 0
        self._node_version = np.zeros(n, np.int64)

    # -- per-pod encode -----------------------------------------------------
    def _pod_key(self, pod: Any) -> Tuple:
        MIB = 1 << 20
        spec = pod.spec
        _require(len(spec.containers) <= 1, ">1 container")
        _require(not spec.tolerations, "tolerations")
        _require(not (spec.containers and spec.containers[0].ports), "ports")
        _require(not spec.volumes, "volumes")
        _require(spec.affinity is None, "affinity")
        _require(not spec.topology_spread_constraints, "topology spread")
        _require(not spec.node_name, "pre-bound pod")
        req = pod.resource_requests()
        sel = tuple(sorted((spec.node_selector or {}).items()))
        return (
            req.milli_cpu, req.memory // MIB,
            req.ephemeral_storage // MIB, sel,
        )

    def _group(self, key: Tuple) -> Dict[str, Any]:
        g = self._groups.get(key)
        if g is None:
            cpu, mem, eph, sel = key
            sel_ok = np.fromiter(
                (
                    all(lbl.get(k) == v for k, v in sel)
                    for lbl in self.labels
                ),
                bool, count=self.n,
            )
            g = self._groups[key] = {
                "static_ok": sel_ok & ~self.unsched,
                "score": np.zeros(self.n, np.int64),
                "feas": np.zeros(self.n, bool),
                "seen": np.full(self.n, -1, np.int64),
            }
        return g

    def _refresh(self, g: Dict[str, Any], key: Tuple, rows: np.ndarray) -> None:
        """Recompute score+feasibility for ``rows`` against current sums."""
        cpu, mem, eph, _sel = key
        nz_cpu = cpu or self._default_nz_cpu
        nz_mem = mem or self._default_nz_mem
        a_cpu, a_mem = self.alloc_cpu[rows], self.alloc_mem[rows]
        # NodeResourcesFit filter: plain requests vs allocatable
        fits = (
            (self.req_cpu[rows] + cpu <= a_cpu)
            & (self.req_mem[rows] + mem <= a_mem)
            & (self.req_eph[rows] + eph <= self.alloc_eph[rows])
            & (self.req_cnt[rows] + 1 <= self.alloc_pods[rows])
        )
        g["feas"][rows] = g["static_ok"][rows] & fits
        # LeastAllocated (plugins/noderesources.py:146-163)
        r_cpu = self.nzreq_cpu[rows] + nz_cpu
        r_mem = self.nzreq_mem[rows] + nz_mem

        def least(requested, alloc):
            s = (alloc - requested) * MAX_NODE_SCORE // np.maximum(alloc, 1)
            return np.where((alloc <= 0) | (requested > alloc), 0, s)

        la = (least(r_cpu, a_cpu) + least(r_mem, a_mem)) // 2

        if self._with_balanced:
            # BalancedAllocation (plugins/noderesources.py:196-221)
            def frac(requested, alloc):
                clamped = np.minimum(requested, 2 * alloc)
                return np.where(
                    alloc > 0,
                    clamped * FRAC_SCALE // np.maximum(alloc, 1),
                    FRAC_SCALE,
                )

            cpu_f, mem_f = frac(r_cpu, a_cpu), frac(r_mem, a_mem)
            ba = (
                (FRAC_SCALE - np.abs(cpu_f - mem_f))
                * MAX_NODE_SCORE // FRAC_SCALE
            )
            ba = np.where(
                (cpu_f >= FRAC_SCALE) | (mem_f >= FRAC_SCALE), 0, ba
            )
            la = la + ba  # both weight 1 in the default roster
        g["score"][rows] = la
        g["seen"][rows] = self._node_version[rows]

    def place(self, pod: Any) -> int:
        """Choice for one pod (node index or -1), committing the placement."""
        key = self._pod_key(pod)
        g = self._group(key)
        dirty = np.flatnonzero(g["seen"] != self._node_version)
        if dirty.size:
            self._refresh(g, key, dirty)
        feas = g["feas"]
        if not feas.any():
            return -1
        score = g["score"]
        best = score[feas].max()
        cand = np.flatnonzero(feas & (score == best))
        seed = pod_seed_batch([pod.metadata.uid or pod.metadata.name])[0]
        j = int(cand[np.argmin(mix32_np(seed, cand))])
        # commit
        cpu, mem, eph = key[0], key[1], key[2]
        self.req_cpu[j] += cpu
        self.req_mem[j] += mem
        self.req_eph[j] += eph
        self.req_cnt[j] += 1
        self.nzreq_cpu[j] += cpu or self._default_nz_cpu
        self.nzreq_mem[j] += mem or self._default_nz_mem
        self._version += 1
        self._node_version[j] = self._version
        return j

    def place_all(self, pods: Sequence[Any]) -> np.ndarray:
        return np.fromiter(
            (self.place(p) for p in pods), np.int64, count=len(pods)
        )


def fullchain_scan_oracle(
    pods: Sequence[Any], nodes: Sequence[Any]
) -> np.ndarray:
    """Sequential full-roster placements for every pod (see
    FullRosterScanOracle for the modeled chain + preconditions)."""
    oracle = FullRosterScanOracle(
        nodes, DEFAULT_NONZERO_CPU, DEFAULT_NONZERO_MEM_MIB
    )
    return oracle.place_all(pods)
