"""Profiling: per-cycle phase timings.

A copy of ``minisched_tpu/observability/profiling.py`` without its JAX
profiler wrapper (``device_trace``; on the card the torch profiler takes
its place, ``profile_repair.py``): a lock-protected per-phase timing
aggregator the engine feeds, whose wave phases also feed the live
histograms of ``observability/hist.py``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator


class PhaseStats:
    __slots__ = ("count", "total_s", "max_s")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0

    def observe(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


#: CycleMetrics phases forwarded into the live histogram plane
#: (observability/hist): any engine with metrics attached — and the
#: engine now defaults to a real CycleMetrics — feeds /metrics without
#: a bench in the loop.  Names are documented in hist.py's registry.
_PHASE_HISTS: Dict[str, str] = {
    "wave_pipeline_build": "sched.wave_build_s",
    "wave_device": "sched.wave_device_s",
    "commit": "sched.wave_commit_s",
    "wave_pipeline_stall": "sched.wave_stall_s",
}


class CycleMetrics:
    """Per-phase wall-clock aggregates for the scheduling loop.

    Attach to an engine: ``sched.metrics = CycleMetrics()`` — schedule_one
    then times snapshot / schedule / permit (and binds report themselves).
    """

    def __init__(self):
        self._mu = threading.Lock()
        self._phases: Dict[str, PhaseStats] = {}

    def observe(self, phase: str, dt: float) -> None:
        with self._mu:
            self._phases.setdefault(phase, PhaseStats()).observe(dt)
        hname = _PHASE_HISTS.get(phase)
        if hname is not None:
            from minisched_tpu_torch.observability import hist

            hist.observe(hname, dt)

    @contextlib.contextmanager
    def timed(self, phase: str) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.observe(phase, time.monotonic() - t0)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._mu:
            return {
                name: {
                    "count": s.count,
                    "total_s": s.total_s,
                    "mean_s": s.mean_s,
                    "max_s": s.max_s,
                }
                for name, s in self._phases.items()
            }

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.snapshot().items()):
            lines.append(
                f"{name}: n={s['count']} mean={s['mean_s']*1e3:.2f}ms "
                f"max={s['max_s']*1e3:.2f}ms total={s['total_s']:.3f}s"
            )
        return "\n".join(lines)

