"""Live latency histograms: fixed log2 buckets, mergeable across labels.

A copy of ``minisched_tpu/observability/hist.py``: the bucket ladder,
``Histogram`` and the ``Histograms`` registry with its module-level
``observe``, ``quantile_bounds``, ``snapshot`` and ``reset``, and the
Prometheus text exposition of the process-global registries (counters,
gauges, histograms: ``render_prometheus``, which the REST façade's and
``metricsd``'s ``/metrics`` serve) with its parser (``parse_prometheus``,
``parse_exemplars``, ``parsed_histogram_quantile``).  The text is JAX's
for the same registry contents.  The queue feeds
``sched.time_to_bind_s`` (arrival to bind, per priority class; exposed
as ``sched_time_to_bind_seconds``) and ``CycleMetrics`` the wave
phases; the REST façade ``http.request_s`` (by verb and route shape) and
``http.list_s`` (LIST latency by kind, in both read modes), and the
watch streams ``watch.delivery_lag_s`` (fanout to socket write, on both
delivery paths), as JAX's ``hist.py:40-44``.

The sharded write plane's (JAX ``hist.py:79-100``): ``shard.route_s``
(the router's topology refresh, probing ``/shards/status`` and adopting
the highest epoch: the time a 421 chase pays before its re-dispatch;
what is elsewhere called the topology-refresh histogram),
``shard.crossbind_s`` (a bind batch spanning groups, end to end),
``shard.freeze_s`` (a split's write freeze, coordinator side) and
``shard.autosplit.window_p99_s`` (the load watcher's windowed
``storage.group_wait_s`` p99).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

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

def _metric_name(name: str) -> str:
    """``sched.time_to_bind_s`` → ``sched_time_to_bind_seconds``: dots
    (and any other illegal rune) become underscores, a trailing ``_s``
    unit spells out per Prometheus naming convention."""
    out = "".join(
        ch if (ch.isascii() and (ch.isalnum() or ch in "_:")) else "_"
        for ch in name
    )
    if out.endswith("_s"):
        out = out[:-2] + "_seconds"
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(items: Iterable[Tuple[str, str]], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(str(v))}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_float(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    return repr(float(v))


def _fmt_exemplar(ex: Optional[Tuple[str, float]]) -> str:
    """OpenMetrics exemplar suffix for a ``_bucket`` line, or "" when
    the bucket never saw an exemplar-carrying observation — keeping
    exemplar-free expositions byte-identical to the pre-exemplar
    format (the golden file relies on this)."""
    if ex is None:
        return ""
    key, v = ex
    return f' # {{key="{_escape_label(key)}"}} {_fmt_float(v)}'


def render_prometheus(
    counters_obj=None, hists: Optional[Histograms] = None
) -> str:
    """The whole registry — counters, gauges, histograms — as Prometheus
    text exposition (version 0.0.4).  Deterministic ordering so the
    golden-file test is byte-stable."""
    from minisched_tpu_torch.observability import counters as counters_mod

    c = counters_obj if counters_obj is not None else counters_mod.GLOBAL
    h = hists if hists is not None else GLOBAL
    gauges = c.gauge_names()
    lines: List[str] = []
    for name, val in sorted(c.snapshot().items()):
        mname = _metric_name(name)
        kind = "gauge" if name in gauges else "counter"
        lines.append(f"# TYPE {mname} {kind}")
        lines.append(f"{mname} {val}")
    with h._mu:
        keys = sorted(h._hists.keys())
        children = [(k, h._hists[k]) for k in keys]
    seen_type = set()
    for (name, labels), child in children:
        mname = _metric_name(name)
        if mname not in seen_type:
            seen_type.add(mname)
            lines.append(f"# TYPE {mname} histogram")
        snap = child.snapshot()
        exemplars = snap["exemplars"]
        cum = 0
        for i, n in enumerate(snap["counts"]):
            cum += n
            le = 'le="%s"' % _fmt_float(BUCKET_BOUNDS[i])
            lines.append(
                f"{mname}_bucket{_fmt_labels(labels, extra=le)} {cum}"
                + _fmt_exemplar(exemplars.get(i))
            )
        cum += snap["overflow"]
        inf_le = 'le="+Inf"'
        lines.append(
            f"{mname}_bucket{_fmt_labels(labels, extra=inf_le)} {cum}"
            + _fmt_exemplar(exemplars.get(NBUCKETS))
        )
        lines.append(
            f"{mname}_sum{_fmt_labels(labels)} {_fmt_float(snap['sum'])}"
        )
        lines.append(f"{mname}_count{_fmt_labels(labels)} {snap['count']}")
    return "\n".join(lines) + "\n"


# -- minimal parser (the scrape consumer's half) ----------------------------

def _label_block_end(s: str) -> int:
    """Index of the ``}`` closing a label block that starts at ``s[0]``'s
    level — quote-aware, so escaped quotes and braces inside label
    values don't end the block early."""
    i, in_quote = 0, False
    while i < len(s):
        ch = s[i]
        if in_quote:
            if ch == "\\":
                i += 1
            elif ch == '"':
                in_quote = False
        elif ch == '"':
            in_quote = True
        elif ch == "}":
            return i
        i += 1
    return len(s)


def _parse_labels(s: str) -> Dict[str, str]:
    """Parse ``k="v",k2="v2"`` honoring \\\\, \\" and \\n escapes."""
    out: Dict[str, str] = {}
    i, n = 0, len(s)
    while i < n:
        j = s.index("=", i)
        key = s[i:j].strip().lstrip(",").strip()
        if s[j + 1] != '"':
            raise ValueError(f"unquoted label value at {s[j:]}")
        i = j + 2
        buf: List[str] = []
        while s[i] != '"':
            if s[i] == "\\":
                nxt = s[i + 1]
                buf.append({"\\": "\\", '"': '"', "n": "\n"}[nxt])
                i += 2
            else:
                buf.append(s[i])
                i += 1
        out[key] = "".join(buf)
        i += 1  # closing quote
        while i < n and s[i] in ", ":
            i += 1
    return out


def parse_prometheus(
    text: str,
) -> Tuple[Dict[str, str], List[Tuple[str, Dict[str, str], float]]]:
    """Minimal exposition parser: returns ``(types, samples)`` where
    types maps metric name → counter|gauge|histogram and samples is
    ``[(name, labels, value)]`` in document order.  Enough to validate
    a scrape, pretty-print a snapshot, and round-trip the golden file —
    deliberately not a full OpenMetrics implementation."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        if "{" in line:
            name = line[: line.index("{")]
            rest = line[line.index("{") + 1 :]
            i = _label_block_end(rest)
            labels = _parse_labels(rest[:i])
            val = rest[i + 1 :].strip()
        else:
            name, val = line.split(None, 1)
            labels = {}
        # an OpenMetrics exemplar (`` # {…} v``) may trail a _bucket
        # sample; it is annotation, not part of the sample value
        if " # " in val:
            val = val.split(" # ", 1)[0].strip()
        samples.append((name, labels, float(val)))
    return types, samples


def parse_exemplars(
    text: str,
) -> List[Tuple[str, Dict[str, str], Dict[str, str], float]]:
    """OpenMetrics exemplars from an exposition, in document order:
    ``[(sample name, sample labels, exemplar labels, exemplar value)]``.
    Kept separate from :func:`parse_prometheus` so its (types, samples)
    contract — and every existing consumer — stays untouched."""
    out: List[Tuple[str, Dict[str, str], Dict[str, str], float]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or " # {" not in line:
            continue
        sample, ex = line.split(" # {", 1)
        j = _label_block_end(ex)
        ex_labels = _parse_labels(ex[:j])
        ex_val = float(ex[j + 1 :].strip().split()[0])
        if "{" in sample:
            name = sample[: sample.index("{")]
            rest = sample[sample.index("{") + 1 :]
            k = _label_block_end(rest)
            labels = _parse_labels(rest[:k])
        else:
            name = sample.split()[0]
            labels = {}
        out.append((name, labels, ex_labels, ex_val))
    return out


def parsed_histogram_quantile(
    samples: List[Tuple[str, Dict[str, str], float]],
    metric: str,
    q: float,
) -> Optional[Tuple[float, float]]:
    """Quantile bounds recomputed from PARSED ``_bucket`` samples —
    the scrape-side mirror of :meth:`Histograms.quantile_bounds`, used
    by the smoke tool and the CLI pretty-printer."""
    # merge cumulative buckets across label children: le → summed count
    by_le: Dict[float, float] = {}
    for name, labels, val in samples:
        if name != metric + "_bucket":
            continue
        le = labels.get("le", "")
        by_le[math.inf if le == "+Inf" else float(le)] = (
            by_le.get(math.inf if le == "+Inf" else float(le), 0.0) + val
        )
    if not by_le:
        return None
    bounds = sorted(by_le)
    total = by_le[bounds[-1]]
    if total <= 0:
        return None
    rank = max(1.0, math.ceil(q * total))
    lo = 0.0
    for b in bounds:
        if by_le[b] >= rank:
            return lo, b
        lo = b
    return lo, math.inf
