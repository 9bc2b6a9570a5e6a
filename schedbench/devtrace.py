"""The device trace of a traced run, read from ``torch.profiler``.

``DeviceTrace.start()`` opens a profiler (CPU and CUDA activities) and
records an anchor span whose profiler time is paired with the host's
monotonic clock, so the host spans of ``spans.py`` can be laid over the
device timeline.  ``stop()`` waits for the card and closes the profiler;
``reduce()``, which a run calls once its drain is over (reading the
events holds the interpreter for seconds), keeps, per device operation
(kernels, copies, sets), its name, start and duration.  From those:

* ``busy_s``: the union of the operations' intervals within the traced
  window; ``window_s`` its length;
* ``by_name``: device seconds and counts per operation name;
* ``gaps`` and ``idle_by_span``: the gaps between operations, each
  named by the innermost engine span open on the host at its middle.
"""

from __future__ import annotations

import time
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ANCHOR = "schedbench.anchor"


@dataclass
class TraceData:
    window_s: float
    busy_s: float
    #: operation name → (count, device seconds)
    by_name: Dict[str, Tuple[int, float]]
    #: device seconds of each launch whose name has ``select_hosts`` in it
    select_hosts: List[float]
    #: the idle gaps within the window, (k, 2) host monotonic seconds
    gaps: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))

    def idle_by_span(self, pieces: Sequence[Tuple[float, float, str]]
                     ) -> Dict[str, float]:
        """Idle seconds of the card by the innermost engine span open on
        the host at each gap's middle (``pieces``:
        ``spans.flat_timeline``)."""
        out: Dict[str, float] = defaultdict(float)
        starts = [p[0] for p in pieces]
        for a, b in self.gaps.tolist():
            t = (a + b) / 2
            i = bisect_right(starts, t) - 1
            name = (pieces[i][2] if i >= 0 and pieces[i][1] > t
                    else "no engine span")
            out[name] += b - a
        return dict(out)


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self._prof = None
        self.t0 = self.t1 = 0.0
        self._anchor_mono = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        with record_function(ANCHOR):
            self._anchor_mono = time.monotonic()
        self.t0 = self._anchor_mono

    def stop(self) -> "DeviceTrace":
        """Wait for the card and close the trace."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.monotonic()
        self._prof.stop()
        return self

    def reduce(self) -> TraceData:
        """The closed trace's device operations, reduced."""
        import torch

        events = self._prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        anchor_ns: Optional[int] = None
        starts: List[int] = []
        ends: List[int] = []
        by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
        sel: List[float] = []
        for e in events:
            if e.device_type() != cuda:
                if anchor_ns is None and e.name() == ANCHOR:
                    anchor_ns = e.start_ns()
                continue
            name = e.name()
            s, d = e.start_ns(), e.duration_ns()
            starts.append(s)
            ends.append(s + d)
            acc = by_name[name]
            acc[0] += 1
            acc[1] += d * 1e-9
            if "select_hosts" in name:
                sel.append(d * 1e-9)
        self._prof = None
        window_s = self.t1 - self.t0
        if anchor_ns is None:
            raise RuntimeError("the profiler lost the anchor span")
        lo, hi = anchor_ns, anchor_ns + int(window_s * 1e9)
        busy, gaps = _busy_and_gaps(np.asarray(starts, np.int64),
                                    np.asarray(ends, np.int64), lo, hi)
        mono_gaps = self._anchor_mono + (gaps - anchor_ns) * 1e-9
        return TraceData(window_s, busy * 1e-9,
                         {k: (int(v[0]), v[1]) for k, v in by_name.items()},
                         sel, mono_gaps)


def _busy_and_gaps(starts: np.ndarray, ends: np.ndarray, lo: int, hi: int
                   ) -> Tuple[int, np.ndarray]:
    """(ns busy within [lo, hi), (k, 2) array of the idle gaps)."""
    keep = (ends > lo) & (starts < hi)
    s = np.clip(starts[keep], lo, hi)
    e = np.clip(ends[keep], lo, hi)
    if s.size == 0:
        return 0, np.array([[lo, hi]], np.int64)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    # a new busy stretch starts where an operation begins past all before
    new = np.empty(s.size, bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:], s.size) - 1
    b_start, b_end = s[first], reach[last]
    busy = int((b_end - b_start).sum())
    g_start = np.concatenate(([lo], b_end))
    g_end = np.concatenate((b_start, [hi]))
    open_ = g_end > g_start
    return busy, np.stack([g_start[open_], g_end[open_]], axis=1)
