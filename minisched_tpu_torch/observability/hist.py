"""Live latency histograms: fixed log2 buckets, mergeable across labels.

The part of ``minisched_tpu/observability/hist.py`` the engine calls: the
bucket ladder, ``Histogram`` and the ``Histograms`` registry with its
module-level ``observe``, ``quantile_bounds``, ``snapshot`` and ``reset``.
The queue feeds ``sched.time_to_bind_s`` (arrival to bind, per priority
class) and ``CycleMetrics`` the wave phases.  The JAX module's
Prometheus exposition and parser are not ported.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

#: first bucket upper bound: 100µs (below the cheapest observed seam)
BUCKET_BASE_S = 1e-4
#: finite buckets: 1e-4 · 2^k, k ∈ [0, 26); last finite bound ≈ 3355s
NBUCKETS = 26

#: the shared ladder of finite upper bounds, low→high
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    BUCKET_BASE_S * (1 << k) for k in range(NBUCKETS)
)


def bucket_index(v: float) -> int:
    """Index of the finite bucket whose upper bound first covers ``v``,
    or ``NBUCKETS`` for overflow (+Inf only).  Exact at power-of-two
    boundaries (frexp, not float log2): a value equal to a bound lands
    IN that bucket, matching Prometheus ``le`` semantics."""
    if v <= BUCKET_BASE_S:
        return 0
    m, e = math.frexp(v / BUCKET_BASE_S)  # v/base = m·2^e, m ∈ [0.5, 1)
    idx = e - 1 if m == 0.5 else e
    return idx if idx < NBUCKETS else NBUCKETS


class Histogram:
    """One label-child: fixed log2 buckets + sum + count.

    Lock-cheap: one uncontended Lock per child, three integer bumps and
    a float add inside it — no allocation, no sorting, no sample list."""

    __slots__ = ("_mu", "counts", "overflow", "sum", "count", "exemplars")

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.counts = [0] * NBUCKETS
        self.overflow = 0
        self.sum = 0.0
        self.count = 0
        #: bucket index (NBUCKETS = +Inf) → (exemplar string, value);
        #: last writer wins, so state stays O(buckets) forever
        self.exemplars: Dict[int, Tuple[str, float]] = {}

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        i = bucket_index(v)
        with self._mu:
            if i < NBUCKETS:
                self.counts[i] += 1
            else:
                self.overflow += 1
            self.sum += v
            self.count += 1
            if exemplar is not None:
                self.exemplars[i] = (str(exemplar), v)

    def merge_into(self, counts: List[int]) -> Tuple[int, float, int]:
        """Add this child's buckets into ``counts`` (len NBUCKETS);
        returns (overflow, sum, count) deltas — the registry's
        cross-label aggregation primitive."""
        with self._mu:
            for i, c in enumerate(self.counts):
                counts[i] += c
            return self.overflow, self.sum, self.count

    def snapshot(self) -> Dict[str, object]:
        with self._mu:
            return {
                "counts": list(self.counts),
                "overflow": self.overflow,
                "sum": self.sum,
                "count": self.count,
                "exemplars": dict(self.exemplars),
            }


LabelsKey = Tuple[Tuple[str, str], ...]


class Histograms:
    """The registry: (name, sorted label items) → Histogram child."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._hists: Dict[Tuple[str, LabelsKey], Histogram] = {}

    def _child(self, name: str, labels: Dict[str, str]) -> Histogram:
        key = (name, tuple(sorted(labels.items())))
        with self._mu:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram()
        return h

    def observe(
        self,
        name: str,
        v: float,
        exemplar: Optional[str] = None,
        **labels: str,
    ) -> None:
        self._child(name, labels).observe(v, exemplar=exemplar)

    def get(self, name: str, **labels: str) -> Optional[Histogram]:
        key = (name, tuple(sorted(labels.items())))
        with self._mu:
            return self._hists.get(key)

    def children(self, name: str) -> List[Tuple[LabelsKey, Histogram]]:
        with self._mu:
            return [
                (k[1], h) for k, h in self._hists.items() if k[0] == name
            ]

    def names(self) -> List[str]:
        with self._mu:
            return sorted({k[0] for k in self._hists})

    def merged(self, name: str) -> Tuple[List[int], int, float, int]:
        """(bucket counts, overflow, sum, count) aggregated across every
        label child of ``name`` — mergeable because buckets are fixed."""
        counts = [0] * NBUCKETS
        overflow, total, n = 0, 0.0, 0
        for _labels, h in self.children(name):
            o, s, c = h.merge_into(counts)
            overflow += o
            total += s
            n += c
        return counts, overflow, total, n

    def quantile_bounds(
        self, name: str, q: float
    ) -> Optional[Tuple[float, float]]:
        """[lower, upper) bounds of the bucket holding the q-quantile
        across all label children, or None when empty.  The upper bound
        is the conservative point estimate; "agrees within bucket
        resolution" means a sampled quantile falls inside (or within one
        bucket of) these bounds."""
        counts, overflow, _s, n = self.merged(name)
        if n == 0:
            return None
        rank = max(1, math.ceil(q * n))  # nearest-rank, 1-based
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank:
                lo = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
                return lo, BUCKET_BOUNDS[i]
        return BUCKET_BOUNDS[-1], math.inf

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """name → {count, sum, p50, p99} (bucket-upper estimates) —
        the compact block bench records embed as ``metrics_snapshot``."""
        out: Dict[str, Dict[str, object]] = {}
        for name in self.names():
            _counts, _ovf, total, n = self.merged(name)
            p50 = self.quantile_bounds(name, 0.50)
            p99 = self.quantile_bounds(name, 0.99)
            out[name] = {
                "count": n,
                "sum_s": total,
                "p50_le_s": p50[1] if p50 else None,
                "p99_le_s": p99[1] if p99 else None,
            }
        return out

    def reset(self) -> None:
        with self._mu:
            self._hists.clear()


GLOBAL = Histograms()


def observe(
    name: str, v: float, exemplar: Optional[str] = None, **labels: str
) -> None:
    GLOBAL.observe(name, v, exemplar=exemplar, **labels)


def quantile_bounds(name: str, q: float) -> Optional[Tuple[float, float]]:
    return GLOBAL.quantile_bounds(name, q)


def snapshot() -> Dict[str, Dict[str, object]]:
    return GLOBAL.snapshot()


def reset() -> None:
    GLOBAL.reset()


# -- Prometheus text exposition ---------------------------------------------
