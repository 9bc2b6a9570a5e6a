"""Retry with exponential backoff.

A copy of ``minisched_tpu/utils/retry.py``, which re-creates
``util/retry.go:18-26`` (RetryWithExponentialBackOff wrapping
wait.ExponentialBackoff): 100ms initial delay, factor 3, 6 steps — the
policy the result store uses to flush annotations (store.go:120-128).

``jitter`` (upstream wait.Backoff.Jitter, 0.1 in retry.go:13) is exposed
behind a parameter defaulting to 0 so the call sites stay byte-exact.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterator, Optional

INITIAL_DURATION_S = 0.1  # util/retry.go:11
FACTOR = 3.0  # util/retry.go:12
JITTER = 0.0  # util/retry.go:13 (jitter 0.1 upstream; 0 keeps tests exact)
STEPS = 6  # util/retry.go:14


class RetryTimeoutError(Exception):
    """All backoff steps exhausted without the fn reporting success."""


def backoff_delays(
    initial_duration_s: float = INITIAL_DURATION_S,
    factor: float = FACTOR,
    steps: int = STEPS,
    jitter: float = JITTER,
    rng: Optional[random.Random] = None,
) -> Iterator[float]:
    """The sleep schedule between ``steps`` attempts (``steps - 1``
    delays): initial * factor^i, each stretched by up to ``jitter``
    fraction (wait.Jitter semantics: delay * (1 + jitter*rand)).  A
    seeded ``rng`` makes the jittered schedule reproducible."""
    if jitter and rng is None:
        rng = random.Random()
    delay = initial_duration_s
    for _ in range(max(steps - 1, 0)):
        d = delay
        if jitter:
            d *= 1.0 + jitter * rng.random()
        yield d
        delay *= factor


def retry_with_exponential_backoff(
    fn: Callable[[], bool],
    initial_duration_s: float = INITIAL_DURATION_S,
    factor: float = FACTOR,
    steps: int = STEPS,
    sleep: Callable[[float], None] = time.sleep,
    jitter: float = JITTER,
    rng: Optional[random.Random] = None,
) -> None:
    """Call ``fn`` until it returns True; sleep initial*factor^i (jittered
    when ``jitter`` > 0) between attempts; raise RetryTimeoutError after
    ``steps`` attempts.  ``fn`` raising propagates immediately (matches
    wait.ExponentialBackoff's error passthrough)."""
    delays = backoff_delays(initial_duration_s, factor, steps, jitter, rng)
    for step in range(steps):
        if fn():
            return
        if step < steps - 1:
            sleep(next(delays))
    raise RetryTimeoutError(f"retry exhausted after {steps} steps")
