"""Flight-recorder scheduling traces: a bounded ring of per-pod spans.

The bench roles can tell you p99 time-to-bind; they cannot tell you what
ONE pod's scheduling life looked like — which wave popped it, whether the
build was skipped by the idle gate, whether commit-time re-arbitration
bounced it, what finally bound it.  This module records that story as
structured spans written through the queue and the engine:

    enqueue → pop → build/skip → evaluate → permit/gang-wait → re-arb
            → bind → ack

Each span is one flat dict: ``ts`` (wall clock), ``stage``, and —
when pod-scoped — ``pod`` (namespace/name key) + ``uid``; wave-scoped
spans carry ``wave`` (a per-engine monotonic wave id also stamped on the
pod spans of that wave) plus whatever the seam knows (mesh shards,
fallback/retry causes, node, status).  The ring is bounded (default 8192
spans, ``MINISCHED_TRACE_CAP``), so it is a flight recorder, not a log:
always on, O(1) per span, the last N things the scheduler did.

Consumers:

* ``/debug/trace`` on the REST façade (and the supervisors' child
  metrics listeners) dumps the ring as JSONL — the offline training feed
  the ROADMAP's learned-scoring item needs.
* ``flight_dump(reason)`` writes the ring to
  ``$MINISCHED_TRACE_DIR/trace-<reason>-<pid>-<n>.jsonl`` when that env
  var is set — called at wave park/error so a chaos soak's post-mortem
  artifact survives the process.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional


def _default_cap() -> int:
    try:
        return max(64, int(os.environ.get("MINISCHED_TRACE_CAP", "8192")))
    except ValueError:
        return 8192


def pod_key(pod: Any) -> str:
    """namespace/name — the join key across a pod's spans (uid rides
    alongside for identity across delete/re-create)."""
    try:
        return pod.metadata.key
    except AttributeError:
        return str(pod)


class TraceRing:
    """Bounded ring of span dicts.  One lock, append-only; the deque's
    maxlen does the eviction."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self._mu = threading.Lock()
        self._ring: Deque[Dict[str, Any]] = deque(
            maxlen=capacity or _default_cap()
        )
        self._dump_seq = 0

    def span(self, stage: str, **fields: Any) -> None:
        rec = {"ts": time.time(), "stage": stage}
        rec.update({k: v for k, v in fields.items() if v is not None})
        with self._mu:
            self._ring.append(rec)

    def span_pod(self, stage: str, pod: Any, **fields: Any) -> None:
        uid = None
        try:
            uid = pod.metadata.uid
        except AttributeError:
            pass
        self.span(stage, pod=pod_key(pod), uid=uid, **fields)

    def spans(
        self, pod: Optional[str] = None, stage: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        with self._mu:
            out = list(self._ring)
        if pod is not None:
            out = [s for s in out if s.get("pod") == pod]
        if stage is not None:
            out = [s for s in out if s.get("stage") == stage]
        return out

    def dump_jsonl(self) -> str:
        with self._mu:
            out = list(self._ring)
        return "".join(json.dumps(s, default=str) + "\n" for s in out)

    def flight_dump(self, reason: str) -> Optional[str]:
        """Write the ring to $MINISCHED_TRACE_DIR (no-op when unset —
        the ring stays scrapeable via /debug/trace either way).  Never
        raises: the flight recorder must not add a failure mode to the
        error path that triggered it."""
        d = os.environ.get("MINISCHED_TRACE_DIR")
        if not d:
            return None
        try:
            os.makedirs(d, exist_ok=True)
            with self._mu:
                self._dump_seq += 1
                seq = self._dump_seq
            safe = "".join(
                ch if ch.isalnum() or ch in "-_" else "_" for ch in reason
            )
            path = os.path.join(
                d, f"trace-{safe}-{os.getpid()}-{seq}.jsonl"
            )
            with open(path, "w") as f:
                f.write(self.dump_jsonl())
            return path
        except OSError:
            return None

    def __len__(self) -> int:
        with self._mu:
            return len(self._ring)

    def reset(self) -> None:
        with self._mu:
            self._ring.clear()


GLOBAL = TraceRing()


def span(stage: str, **fields: Any) -> None:
    GLOBAL.span(stage, **fields)


def span_pod(stage: str, pod: Any, **fields: Any) -> None:
    GLOBAL.span_pod(stage, pod, **fields)


def spans(pod: Optional[str] = None, stage: Optional[str] = None):
    return GLOBAL.spans(pod=pod, stage=stage)


def dump_jsonl() -> str:
    return GLOBAL.dump_jsonl()


def flight_dump(reason: str) -> Optional[str]:
    return GLOBAL.flight_dump(reason)


def reset() -> None:
    GLOBAL.reset()
