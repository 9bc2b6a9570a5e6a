"""Process-wide event counters.

A copy of ``minisched_tpu/observability/counters.py``: named integer
counters bumped on rare control paths (assume-lease expiry, gang
admission and TTL release, bind-batch failures), read by tests and bench
audits, and last-write-wins gauges (``set_gauge``), which the Prometheus
exposition (``hist.render_prometheus``) types as ``gauge``.
"""

from __future__ import annotations

import threading
from typing import Dict, Set


class Counters:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._gauge_names: Set[str] = set()

    def inc(self, name: str, n: int = 1) -> None:
        with self._mu:
            self._counts[name] = self._counts.get(name, 0) + n

    def set_gauge(self, name: str, n: int) -> None:
        """Last-write-wins value for a state-shaped entry; the name is
        remembered as gauge-typed for the exposition's ``# TYPE``."""
        with self._mu:
            self._counts[name] = n
            self._gauge_names.add(name)

    def gauge_names(self) -> Set[str]:
        with self._mu:
            return set(self._gauge_names)

    def get(self, name: str) -> int:
        with self._mu:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._mu:
            return dict(self._counts)

    def reset(self) -> None:
        with self._mu:
            self._counts.clear()
            self._gauge_names.clear()


GLOBAL = Counters()


def inc(name: str, n: int = 1) -> None:
    GLOBAL.inc(name, n)


def set_gauge(name: str, n: int) -> None:
    GLOBAL.set_gauge(name, n)


def get(name: str) -> int:
    return GLOBAL.get(name)


def snapshot() -> Dict[str, int]:
    return GLOBAL.snapshot()


def reset() -> None:
    GLOBAL.reset()
