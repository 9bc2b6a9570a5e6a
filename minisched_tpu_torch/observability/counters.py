"""Process-wide event counters.

The part of ``minisched_tpu/observability/counters.py`` the engine calls:
named integer counters bumped on rare control paths (assume-lease expiry,
gang admission and TTL release, bind-batch failures), read by tests and
bench audits.  The JAX module's Prometheus exposition and gauges are not
ported.
"""

from __future__ import annotations

import threading
from typing import Dict


class Counters:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._counts: Dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._mu:
            self._counts[name] = self._counts.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._mu:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._mu:
            return dict(self._counts)

    def reset(self) -> None:
        with self._mu:
            self._counts.clear()


GLOBAL = Counters()


def inc(name: str, n: int = 1) -> None:
    GLOBAL.inc(name, n)


def get(name: str) -> int:
    return GLOBAL.get(name)


def snapshot() -> Dict[str, int]:
    return GLOBAL.snapshot()


def reset() -> None:
    GLOBAL.reset()
