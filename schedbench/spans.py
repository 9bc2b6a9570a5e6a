"""Host spans of the engine, recorded from the benchmark's side.

The engine times its phases through the ``metrics`` object the service
installs (``CycleMetrics``: ``scan_flush``, ``scan_grouping``,
``scan_build``, ``scan_evaluate``, ``commit``, ``bind``, ``wave_*``,
``loop_pop``, ...).  ``SpanRecorder`` is a ``CycleMetrics`` that also
keeps each timed phase as a span (name, start, end, thread), so a traced
run can take self times (a span less the spans nested in it on its
thread) and name what the host was doing while the card was idle.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Sequence, Tuple

from minisched_tpu_torch.observability.profiling import CycleMetrics

#: phases the engine observes after the fact with a duration (the rest it
#: observes so are counts: ``wave_size``, ``wave_losers``, ...)
DIRECT_DURATIONS = frozenset({"loop_pop", "wave", "wave_pipeline_stall"})

Span = Tuple[str, float, float, int]


class SpanRecorder(CycleMetrics):
    def __init__(self):
        super().__init__()
        self.spans: List[Span] = []

    def observe(self, phase: str, dt: float) -> None:
        super().observe(phase, dt)
        if phase in DIRECT_DURATIONS:
            t1 = time.monotonic()
            self.spans.append((phase, t1 - dt, t1, threading.get_ident()))

    @contextlib.contextmanager
    def timed(self, phase: str) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            t1 = time.monotonic()
            CycleMetrics.observe(self, phase, t1 - t0)
            self.spans.append((phase, t0, t1, threading.get_ident()))


#: a child may start this much before its parent's reconstructed start
#: (a parent observed after the fact is placed from its end)
_SLACK_S = 2e-4


def _contains(outer: Span, inner: Span) -> bool:
    return (outer[1] - _SLACK_S <= inner[1]
            and inner[2] <= outer[2] + _SLACK_S)


def self_times(spans: Sequence[Span], within: Sequence[Tuple[float, float]]
               ) -> Dict[str, float]:
    """Seconds of each phase less its nested spans, summed over the spans
    that end inside one of the intervals ``within``.  Spans on one thread
    nest (a phase's timer runs inside its caller's)."""
    out: Dict[str, float] = defaultdict(float)
    by_thread: Dict[int, List[Span]] = defaultdict(list)
    for s in spans:
        by_thread[s[3]].append(s)
    for items in by_thread.values():
        items.sort(key=lambda s: (s[1], -s[2]))
        # stack of [span, seconds of its direct children]
        stack: List[list] = []
        done: List[Tuple[Span, float]] = []
        for s in items:
            while stack and not _contains(stack[-1][0], s):
                done.append(tuple(stack.pop()))
            if stack:
                stack[-1][1] += s[2] - s[1]
            stack.append([s, 0.0])
        done.extend(tuple(e) for e in stack)
        for s, children in done:
            if any(a <= s[2] < b for a, b in within):
                out[s[0]] += max(s[2] - s[1] - children, 0.0)
    return dict(out)


def flat_timeline(spans: Sequence[Span], thread: int
                  ) -> List[Tuple[float, float, str]]:
    """The innermost span open on ``thread`` over time, as
    (start, end, phase) pieces in order."""
    items = sorted((s for s in spans if s[3] == thread),
                   key=lambda s: (s[1], -s[2]))
    pieces: List[Tuple[float, float, str]] = []
    stack: List[Span] = []
    cursor = None

    def emit(until: float) -> None:
        nonlocal cursor
        if stack and cursor is not None and until > cursor:
            pieces.append((cursor, until, stack[-1][0]))
        cursor = until

    for s in items:
        while stack and stack[-1][2] <= s[1]:
            emit(stack[-1][2])
            stack.pop()
        emit(s[1])
        stack.append(s)
    while stack:
        emit(stack[-1][2])
        stack.pop()
    return pieces


def engine_thread(spans: Sequence[Span]) -> int:
    """The thread that ran the engine's loop (the one that waited in
    ``loop_pop``), 0 when none did."""
    counts: Dict[int, int] = defaultdict(int)
    for s in spans:
        if s[0] == "loop_pop":
            counts[s[3]] += 1
    return max(counts, key=counts.get) if counts else 0
