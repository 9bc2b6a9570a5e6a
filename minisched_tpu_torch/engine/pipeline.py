"""Two-stage wave pipeline: the host build of wave N+1 overlapped with the
device evaluation of wave N.

A copy of ``minisched_tpu/engine/pipeline.py`` (``:44-292``).  A build
worker thread pops wave N+1 from the scheduling queue, snapshots the
NodeInfo cache and packs its tables while the engine thread waits on wave
N's device call; a handoff queue of depth 1 is the backpressure between
the two.  Wave N+1's snapshot predates wave N's commits, so the engine
thread re-arbitrates its winners against the current capacity view
before assuming them (``DeviceScheduler._rearbitrate_winners``); the
bind transaction's preconditions stay the store-side backstop.  Whatever
the build stage does not handle (an encode overflow, an empty roster, an
all-constrained batch, the cross-pod priority bypass, any build error)
is handed back ``raw`` and takes the serial wave path.

The worker touches no CUDA: a ``PreparedWave`` carries host tables (the
node table as ``models/tables.NodeTableHost``, the pod and constraint
tables packed into flat buffers), and the engine thread copies them to
the card.  ``MINISCHED_PIPELINE=0`` or ``new_device_scheduler(
pipeline=False)`` keeps the serial loop.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Any, List, Optional

from minisched_tpu_torch.observability import counters


class PreparedWave:
    """One wave's build-stage output, handed to the engine thread."""

    __slots__ = ("qpis", "constrained", "partial", "node_infos", "tables",
                 "build_s")

    def __init__(self) -> None:
        self.qpis: List[Any] = []
        self.constrained: List[Any] = []
        self.partial = True
        self.node_infos: List[Any] = []
        #: (models/tables.NodeTableHost, node names, the packed pod table,
        #: the packed constraint tables or None):
        #: ``DeviceScheduler._build_host_tables``
        self.tables: Any = None
        #: the build stage's host seconds (the ``wave_build`` trace span)
        self.build_s = 0.0


class _BuildFallback(Exception):
    """Internal: this batch takes the serial wave path."""


class WavePipeline:
    """The build worker and the handoff of one DeviceScheduler.

    Items on the handoff queue:

    * ``("wave", PreparedWave)``: tables built, ready for the device;
    * ``("raw", qpis, partial)``: the engine thread runs the serial
      ``schedule_wave`` over the batch;
    * ``("empty",)``: a pop window passed with nothing popped; the engine
      thread takes its idle path (lease expiry, backlog flush, gc).

    The worker is the only queue popper while the pipeline runs, so pop
    order is kept; at most two waves' pods are out of the queue (one on
    the device, one built), and ``drain`` hands what is stranded at stop
    back to the engine thread, which parks it.
    """

    def __init__(self, sched: Any, depth: int = 1, pop_timeout: float = 0.5):
        self._sched = sched
        self._handoff: _queue.Queue = _queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._pop_timeout = pop_timeout
        self._thread: Optional[threading.Thread] = None
        #: popped but never handed over (stop raced the put)
        self._leftover: List[Any] = []

    # -- engine-thread surface ---------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._run, name="wave-build",
                                        daemon=True)
        self._thread.start()

    def get(self, timeout: float, stop: Optional[threading.Event] = None):
        """The next item, or None after ``timeout`` seconds or once
        ``stop`` is set (polled every 0.1 s, so a stopping engine does not
        sit out the whole timeout)."""
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0 or (stop is not None and stop.is_set()):
                return None
            try:
                return self._handoff.get(timeout=min(left, 0.1))
            except _queue.Empty:
                continue

    def stop(self, join_timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=join_timeout)

    def drain(self) -> List[Any]:
        """Popped-but-unscheduled qpis after ``stop``, cross-pod
        deferrals included; the caller parks them."""
        out = list(self._leftover)
        self._leftover = []
        while True:
            try:
                item = self._handoff.get_nowait()
            except _queue.Empty:
                return out
            out.extend(self._qpis_of(item))

    # -- worker --------------------------------------------------------------
    @staticmethod
    def _qpis_of(item) -> List[Any]:
        if item[0] == "wave":
            return item[1].qpis + item[1].constrained
        if item[0] == "raw":
            return list(item[1])
        return []

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._handoff.put(item, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def _run(self) -> None:
        sched = self._sched
        while not self._stop.is_set():
            qpis = None
            try:
                with sched.metrics.timed("pipeline_pop"):
                    qpis = sched.queue.pop_batch(sched.max_wave,
                                                 timeout=self._pop_timeout)
                if self._stop.is_set():
                    self._leftover.extend(qpis or ())
                    return
                item = (("empty",) if not qpis else
                        self._build_item(qpis, len(qpis) < sched.max_wave))
            except Exception as err:
                if self._stop.is_set():
                    self._leftover.extend(qpis or ())
                    return
                # outside a build (the pop, the fallback's bookkeeping):
                # counted as the loop counts its own, never swallowed; a
                # popped batch goes back to the engine thread raw
                sched.note_loop_error(err)
                item = ("raw", qpis, True) if qpis else ("empty",)
            if not self._put(item):
                self._leftover.extend(self._qpis_of(item))
                return

    def _build_item(self, qpis: List[Any], partial: bool):
        try:
            t0 = time.monotonic()
            with self._sched.metrics.timed("wave_pipeline_build"):
                prepared = self._build(qpis)
            prepared.build_s = time.monotonic() - t0
            prepared.partial = partial
            return ("wave", prepared)
        except _BuildFallback:
            return ("raw", qpis, partial)
        except Exception:
            # an encode overflow (ValueError) or any other build error:
            # the serial path owns the retry and park machinery
            counters.inc("wave_pipeline.build_fallback")
            return ("raw", qpis, partial)

    def _build(self, qpis: List[Any]) -> PreparedWave:
        from minisched_tpu_torch.engine.device_scheduler import _is_cross_pod

        sched = self._sched
        prepared = PreparedWave()
        prepared.qpis = qpis
        if sched._has_cross_pod:
            constrained = [q for q in qpis if _is_cross_pod(q.pod)]
            if constrained:
                prepared.constrained = constrained
                prepared.qpis = [q for q in qpis if not _is_cross_pod(q.pod)]
            # the priority bypass: flushing is engine-thread work, so a
            # batch a deferred pod outranks goes back raw.  The backlog
            # read is a peek across threads; the engine thread checks
            # again before it runs the wave
            pool = list(sched._scan_backlog) + prepared.constrained
            if pool and prepared.qpis:
                hi = max(q.pod.spec.priority for q in pool)
                if hi > min(q.pod.spec.priority for q in prepared.qpis):
                    raise _BuildFallback()
        if not prepared.qpis:
            raise _BuildFallback()  # all constrained: the serial path
        pods_ = [q.pod for q in prepared.qpis]
        # leases expire on the engine thread; the dirty-set drain is
        # atomic with the snapshot and this worker is its one consumer
        with sched.metrics.timed("wave_snapshot"):
            node_infos, agg_delta, _, dirty, epoch = (
                sched._snapshot_for_tables(expire_leases=False))
        if not node_infos:
            raise _BuildFallback()  # empty roster: the serial error path
        prepared.node_infos = node_infos
        prepared.tables = sched._build_host_tables(pods_, node_infos,
                                                   agg_delta, dirty, epoch)
        return prepared
