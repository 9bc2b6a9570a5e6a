"""The plain reference: which node the scheduler must pick for a pod.

Plain NumPy over the plain data of ``cluster.py``; it imports nothing of
the program and takes nothing the program made.  It holds the cluster's
state (what each node has bound, and the labels of the pods bound there)
and answers, for a pod of any template (``cluster.PodTemplate``: CPU and
memory requests, labels, topology-spread constraints), the choice of the
full default roster (15 filters, 7 scores, the upstream weights) over
nodes that carry labels and allocatable CPU, memory and pods:

* Filters that can reject: NodeResourcesFit (CPU, memory and the pod
  count against allocatable) and PodTopologySpread (each DoNotSchedule
  constraint: a node without the constraint's key is rejected; placing on
  node ``n`` must keep ``count(domain(n)) + self - min over domains <=
  max_skew``, counting the bound pods that the constraint's selector
  matches in each domain, the key's value, over every node that carries
  the key; ``self`` is 1 when the selector matches the pod itself, as
  upstream has it).  The other thirteen pass every node: no node is
  cordoned or tainted, no port, image, volume or affinity is in use, and
  no pod has a node selector.
* Scores that vary over nodes: NodeResourcesFit (LeastAllocated) and
  NodeResourcesBalancedAllocation, weight 1 each, in integer arithmetic
  (balanced fractions in units of 1/10,000).  The rest give every node
  the same score (PodTopologySpread scores only ScheduleAnyway
  constraints, which a template may not carry here; the others have
  nothing to read), so they do not move the choice.
* The seeded argmax: the highest total among the feasible nodes, ties
  broken by the least ``mix32(seed(pod uid), node row)``, then the lowest
  row, where a node's row is its place in name order and the pod's seed
  is the FNV-1a hash of its uid.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from schedbench.cluster import PodTemplate

MAX_NODE_SCORE = 100
FRAC_SCALE = 10_000

_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193
_M32 = 0xFFFFFFFF


def pod_seed(uid: str) -> int:
    """32-bit FNV-1a of the uid's UTF-8 bytes."""
    h = _FNV_OFFSET
    for b in uid.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _M32
    return h


def mix32(seed: int, idx: np.ndarray) -> np.ndarray:
    """The tie-break hash of (pod seed, node row), in uint32 arithmetic."""
    x = np.uint32(seed) ^ (idx.astype(np.uint32) * np.uint32(0x9E3779B9))
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def least_allocated(requested: np.ndarray, alloc: np.ndarray) -> np.ndarray:
    s = (alloc - requested) * MAX_NODE_SCORE // np.maximum(alloc, 1)
    return np.where((alloc <= 0) | (requested > alloc), 0, s)


def balanced_fraction(requested: np.ndarray, alloc: np.ndarray
                      ) -> np.ndarray:
    clamped = np.minimum(requested, 2 * alloc)
    return np.where(alloc > 0, clamped * FRAC_SCALE // np.maximum(alloc, 1),
                    FRAC_SCALE)


class Reference:
    """The cluster's state and the reference's choice for a pod.

    ``check_spread=False`` is the control, a scheduler that leaves the
    spread filter out."""

    def __init__(self, cluster, check_spread: bool = True):
        self.c = cluster
        n = len(cluster.names)
        self.node_row = {name: i for i, name in enumerate(cluster.names)}
        self.req_cpu = np.zeros(n, np.int64)
        self.req_mem = np.zeros(n, np.int64)
        self.count = np.zeros(n, np.int64)
        self.check_spread = check_spread
        #: pod name → (node row, its template)
        self.bound: Dict[str, tuple] = {}
        #: a selector's matchLabels → bound pods it matches, per node
        self._matched: Dict[tuple, np.ndarray] = {}
        #: a label key → ``_domain``'s answer
        self._domains: Dict[str, tuple] = {}
        for name, row in cluster.initial:
            self.add(name, row, cluster.initial_pod)

    # -- state --------------------------------------------------------------
    def add(self, name: str, row: int, pod: PodTemplate) -> None:
        self.req_cpu[row] += pod.cpu_m
        self.req_mem[row] += pod.memory_mib
        self.count[row] += 1
        for sel, counts in self._matched.items():
            if set(sel) <= set(pod.labels):
                counts[row] += 1
        self.bound[name] = (row, pod)

    def remove(self, name: str) -> None:
        """A deleted pod frees its node (an unbound pod frees nothing)."""
        entry = self.bound.pop(name, None)
        if entry is None:
            return
        row, pod = entry
        self.req_cpu[row] -= pod.cpu_m
        self.req_mem[row] -= pod.memory_mib
        self.count[row] -= 1
        for sel, counts in self._matched.items():
            if set(sel) <= set(pod.labels):
                counts[row] -= 1

    def _matching(self, sel: tuple) -> np.ndarray:
        counts = self._matched.get(sel)
        if counts is None:
            counts = np.zeros(len(self.c.names), np.int64)
            want = set(sel)
            for row, pod in self.bound.values():
                if want <= set(pod.labels):
                    counts[row] += 1
            self._matched[sel] = counts
        return counts

    def _domain(self, key: str) -> tuple:
        """(each node's domain index, -1 without the key; the number of
        domains; whether a domain holds a keyed node; whether every node
        is a domain of its own, as with ``kubernetes.io/hostname``)."""
        out = self._domains.get(key)
        if out is None:
            index: Dict[str, int] = {}
            values = self.c.labels.get(key)
            if values is None:
                dom = np.full(len(self.c.names), -1, np.int64)
            else:
                dom = np.array([index.setdefault(v, len(index))
                                for v in values], np.int64)
            n_dom = len(index)
            present = np.bincount(dom[dom >= 0], minlength=n_dom) > 0
            own = bool(np.array_equal(dom, np.arange(len(dom))))
            out = self._domains[key] = (dom, n_dom, present, own)
        return out

    # -- the rules ----------------------------------------------------------
    def fits(self, pod: PodTemplate) -> np.ndarray:
        """NodeResourcesFit for one more pod of ``pod``'s shape."""
        c = self.c
        return ((self.req_cpu + pod.cpu_m <= c.cpu_m)
                & (self.req_mem + pod.memory_mib <= c.memory_mib)
                & (self.count + 1 <= c.pods))

    def spread_ok(self, pod: PodTemplate) -> np.ndarray:
        """PodTopologySpread's filter per node for ``pod``."""
        ok = np.ones(len(self.c.names), bool)
        if not self.check_spread:
            return ok
        for con in pod.spread:
            if not con.hard:
                raise NotImplementedError(
                    "the reference has no ScheduleAnyway score")
            dom, n_dom, present, own = self._domain(con.topology_key)
            if not present.any():
                return np.zeros(len(self.c.names), bool)
            matched = self._matching(con.match_labels)
            if own:  # each node its own domain: the counts are the nodes'
                here, low = matched, matched.min()
            else:
                keyed = dom >= 0
                per_dom = np.bincount(dom[keyed], weights=matched[keyed],
                                      minlength=n_dom).astype(np.int64)
                here = np.where(keyed, per_dom[np.maximum(dom, 0)], 0)
                low = per_dom[present].min()
            me = int(con.selects(pod.labels))
            ok &= (dom >= 0) & (here + me - low <= con.max_skew)
        return ok

    def feasible(self, pod: PodTemplate) -> np.ndarray:
        return self.fits(pod) & self.spread_ok(pod)

    def scores(self, pod: PodTemplate) -> np.ndarray:
        """LeastAllocated + BalancedAllocation of one more pod per node."""
        c = self.c
        r_cpu = self.req_cpu + pod.cpu_m
        r_mem = self.req_mem + pod.memory_mib
        la = (least_allocated(r_cpu, c.cpu_m)
              + least_allocated(r_mem, c.memory_mib)) // 2
        cpu_f = balanced_fraction(r_cpu, c.cpu_m)
        mem_f = balanced_fraction(r_mem, c.memory_mib)
        ba = ((FRAC_SCALE - np.abs(cpu_f - mem_f)) * MAX_NODE_SCORE
              // FRAC_SCALE)
        ba = np.where((cpu_f >= FRAC_SCALE) | (mem_f >= FRAC_SCALE), 0, ba)
        return la + ba

    def choose(self, uid: str, pod: PodTemplate) -> int:
        """The node row the pod must go to, or -1 when none is feasible."""
        return self.pick(uid, pod, self.feasible(pod))

    def pick(self, uid: str, pod: PodTemplate, feas: np.ndarray) -> int:
        """``choose`` over the feasible nodes ``feas``."""
        if not feas.any():
            return -1
        score = self.scores(pod)
        best = score[feas].max()
        cand = np.flatnonzero(feas & (score == best))
        # argmin takes the first least hash: the lowest row on hash ties
        return int(cand[np.argmin(mix32(pod_seed(uid), cand))])
