"""The scheduling engine's host loop: plugin wiring, Permit, bind, requeue.

A copy of the ``Scheduler`` base of ``minisched_tpu/engine/scheduler.py``
(``:255-828``) that the device engine (``engine/device_scheduler.py``)
stands on: the event map built from the plugins' ``events_to_register``,
the scheduling queue, the NodeInfo cache and the informer wiring (in the
JAX order: the subclass's indexes, then the cache, then the queue
handlers), the run loop, the PostFilter / Reserve / Permit runners, the
waiting-pod registry (the ``Handle`` plugins call back into) and the
binding cycle with its requeue paths.

Left out: the scalar one-pod cycle (``schedule_one`` / ``_schedule_pod``)
and ``new_scheduler``, which need every plugin's scalar filter and score
half (ROADMAP item 10e); the HA shard filter; trace spans.

One addition over the JAX loop, so a card run can see what the loop
swallows: ``_loop`` still survives every exception (it prints the
traceback and goes on, as the JAX loop does), but counts each one in
``loop_errors`` and keeps the last in ``last_loop_error``.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from minisched_tpu_torch.api.objects import Binding, Pod, gang_key
from minisched_tpu_torch.controlplane.client import (
    AlreadyBound,
    Client,
    OutOfCapacity,
)
from minisched_tpu_torch.controlplane.informer import SharedInformerFactory
from minisched_tpu_torch.controlplane.store import Conflict, StorageDegraded
from minisched_tpu_torch.engine import eventhandlers
from minisched_tpu_torch.engine.cache import SchedulerCache
from minisched_tpu_torch.engine.waitingpod import WaitingPod
from minisched_tpu_torch.framework.events import (
    ClusterEventMap,
    merge_event_registrations,
    unioned_gvks,
)
from minisched_tpu_torch.framework.nodeinfo import NodeInfo
from minisched_tpu_torch.framework.plugin import implements_enqueue
from minisched_tpu_torch.framework.types import (
    CycleState,
    Diagnosis,
    FitError,
    QueuedPodInfo,
    Status,
)
from minisched_tpu_torch.observability import counters
from minisched_tpu_torch.observability.profiling import CycleMetrics
from minisched_tpu_torch.plugins.coscheduling import is_gang_ttl_status
from minisched_tpu_torch.queue.queue import SchedulingQueue


def run_post_filter_plugins(
    post_filter_plugins: List[Any],
    state: CycleState,
    pod: Pod,
    node_infos: List[NodeInfo],
    diagnosis: Diagnosis,
) -> Tuple[Optional[str], Status]:
    """Upstream RunPostFilterPlugins: runs after filtering leaves no
    feasible node; the first plugin returning Success wins (its nominated
    node is the result), an Error aborts, otherwise Unschedulable."""
    for pl in post_filter_plugins:
        nominated, status = pl.post_filter(state, pod, node_infos, diagnosis)
        if status.is_success():
            return nominated, status
        if status.code.name == "ERROR":
            return None, status.with_plugin(status.plugin or pl.name())
    return None, Status.unschedulable(
        "no postFilter plugin made the pod schedulable")


class Scheduler:
    """The engine base (minisched/initialize.go:18-29's Scheduler struct)."""

    def __init__(
        self,
        client: Client,
        informer_factory: SharedInformerFactory,
        filter_plugins: List[Any],
        pre_score_plugins: List[Any],
        score_plugins: List[Any],
        permit_plugins: List[Any],
        score_weights: Optional[Dict[str, int]] = None,
        queue_opts: Optional[dict] = None,
        reserve_plugins: Optional[List[Any]] = None,
        post_filter_plugins: Optional[List[Any]] = None,
    ):
        self.client = client
        self.informer_factory = informer_factory
        self.filter_plugins = filter_plugins
        self.post_filter_plugins = post_filter_plugins or []
        self.pre_score_plugins = pre_score_plugins
        self.score_plugins = score_plugins
        self.permit_plugins = permit_plugins
        self.reserve_plugins = reserve_plugins or []
        self.score_weights = score_weights or {}

        # EventsToRegister → ClusterEventMap (initialize.go:68-75)
        self.event_map: ClusterEventMap = {}
        all_plugins = {
            id(p): p
            for p in filter_plugins + pre_score_plugins + score_plugins
            + self.reserve_plugins + permit_plugins
        }
        merge_event_registrations(
            ((p.name(), p.events_to_register())
             for p in all_plugins.values() if implements_enqueue(p)),
            self.event_map,
        )
        self.queue = SchedulingQueue(event_map=self.event_map,
                                     **(queue_opts or {}))

        self._waiting_pods: Dict[str, WaitingPod] = {}
        self._waiting_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._bind_lock = threading.Lock()
        self._bind_threads: set = set()
        #: observability hooks: fn(pod, node_name_or_None, status), and
        #: per-phase timing
        self.on_decision: Optional[
            Callable[[Any, Optional[str], Status], None]] = None
        self.metrics: Any = CycleMetrics()
        #: exceptions the run loop caught and survived, and the last one
        self.loop_errors = 0
        self.last_loop_error: Optional[BaseException] = None
        self._loop_error_lock = threading.Lock()

        # engine-specific handlers that must register before the cache's
        # (the device engine's indexes: the assume cache is pruned against
        # the cache, so an index may never lag it), then the NodeInfo cache
        # BEFORE the queue handlers, so a requeued pod's next snapshot
        # already reflects the event that woke it (same dispatch thread,
        # registration order = invocation order)
        self._wire_pre_cache(informer_factory)
        self.cache = SchedulerCache()
        self.cache.wire(informer_factory)
        eventhandlers.add_all_event_handlers(
            self, informer_factory, unioned_gvks(self.event_map))

        # gang-aware permit plugins (Coscheduling) count a gang's
        # already-BOUND members toward admission
        for p in permit_plugins:
            if hasattr(p, "gang_lister") and p.gang_lister is None:
                p.gang_lister = self._gang_placed_count

    def _gang_placed_count(self, key: str, exclude=()) -> int:
        """Bound members of gang ``key`` (uid-distinct, minus ``exclude``)
        from the informer cache; the device engine overrides it with its
        GangIndex."""
        ex = set(exclude)
        return sum(
            1 for p in self.informer_factory.informer_for("Pod").lister()
            if p.spec.node_name and p.metadata.uid not in ex
            and gang_key(p) == key)

    def _wire_pre_cache(self, informer_factory: Any) -> None:
        """Hook for subclasses whose informer handlers must register
        BEFORE the NodeInfo cache's (see __init__)."""

    def admits(self, pod: Pod) -> bool:
        """Queue-admission predicate the event handlers consult: one
        engine schedules every pod."""
        return True

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def run(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="scheduleOne-loop", daemon=True)
        self._thread.start()

    #: cadence of the unschedulableQ leftover flush (upstream runs
    #: flushUnschedulableQLeftover every 30 s)
    UNSCHEDULABLE_FLUSH_INTERVAL_S = 30.0

    def _loop(self) -> None:
        last_flush = time.monotonic()
        while not self._stop.is_set():
            try:
                now = time.monotonic()
                if now - last_flush >= self.UNSCHEDULABLE_FLUSH_INTERVAL_S:
                    last_flush = now
                    self.queue.flush_unschedulable_leftover()
                self.schedule_one()
            except Exception as err:  # the loop must survive anything
                self.note_loop_error(err)

    def note_loop_error(self, err: BaseException) -> None:
        """Count an exception a loop survived (the run loop, or the device
        engine's build worker) and print its traceback."""
        with self._loop_error_lock:
            self.loop_errors += 1
            self.last_loop_error = err
        traceback.print_exc()

    def schedule_one(self, timeout: Optional[float] = 0.5) -> bool:
        raise NotImplementedError(
            "the scalar one-pod cycle needs the plugins' scalar filter and "
            "score halves: ROADMAP item 10e")

    def stop(self) -> None:
        self._stop.set()
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        with self._bind_lock:
            binds = list(self._bind_threads)
        for t in binds:
            t.join(timeout=2.0)

    # ------------------------------------------------------------------
    # extension-point runners
    # ------------------------------------------------------------------
    def run_post_filter(
        self,
        state: CycleState,
        pod: Pod,
        node_infos: List[NodeInfo],
        diagnosis: Diagnosis,
    ) -> Optional[str]:
        """Run the PostFilter chain on a scheduling failure; on success the
        nominated node lands in status.nominated_node_name through the
        API.  A plugin failure is printed, never raised (the pod is
        already parked) — except NotImplementedError, the port's marker
        for a plugin body it does not have yet, which the loop counts."""
        if not self.post_filter_plugins:
            return None
        try:
            nominated, status = run_post_filter_plugins(
                self.post_filter_plugins, state, pod, node_infos, diagnosis)
        except NotImplementedError:
            raise
        except Exception:
            traceback.print_exc()
            return None
        if status.is_success() and nominated:
            def set_nominated(p):
                p.status.nominated_node_name = nominated
                return p

            try:
                self.client.pods(pod.metadata.namespace).mutate(
                    pod.metadata.name, set_nominated)
            except KeyError:
                pass  # pod deleted meanwhile
            return nominated
        return None

    def run_permit_plugins(self, state: CycleState, pod: Pod,
                           node_name: str) -> Status:
        """minisched.go:201-237: statuses Wait are pooled into one
        WaitingPod with per-plugin timeouts.  The WaitingPod is registered
        BEFORE the plugins run, so a plugin that fires Allow during its
        own Permit call cannot lose the signal."""
        if not self.permit_plugins:
            return Status.success()
        wp = WaitingPod(pod)
        with self._waiting_lock:
            self._waiting_pods[pod.metadata.uid] = wp
        any_wait = False
        for pl in self.permit_plugins:
            status, timeout_s = pl.permit(state, pod, node_name)
            if status is None or status.is_success():
                continue
            if status.is_wait():
                any_wait = True
                wp.add_pending(pl.name(), timeout_s)
            else:
                with self._waiting_lock:
                    self._waiting_pods.pop(pod.metadata.uid, None)
                return status.with_plugin(status.plugin or pl.name())
        wp.seal()
        if not any_wait:
            with self._waiting_lock:
                self._waiting_pods.pop(pod.metadata.uid, None)
            return Status.success()
        return Status.wait()

    def run_reserve_plugins(self, state: CycleState, pod: Pod,
                            node_name: str) -> Status:
        """Upstream RunReservePlugins: the first failure unreserves, in
        reverse, every plugin that already reserved (including itself)."""
        done: List[Any] = []
        for pl in self.reserve_plugins:
            done.append(pl)
            status = pl.reserve(state, pod, node_name)
            if status is not None and not status.is_success():
                for prev in reversed(done):
                    prev.unreserve(state, pod, node_name)
                return status.with_plugin(status.plugin or pl.name())
        return Status.success()

    def run_unreserve_plugins(self, state: CycleState, pod: Pod,
                              node_name: str) -> None:
        for pl in reversed(self.reserve_plugins):
            pl.unreserve(state, pod, node_name)

    def get_waiting_pod(self, uid: str) -> Optional[WaitingPod]:
        with self._waiting_lock:
            return self._waiting_pods.get(uid)

    # -- binding cycle (minisched.go:96-112,240-277) --------------------
    def wait_on_permit(self, pod: Pod) -> Status:
        wp = self.get_waiting_pod(pod.metadata.uid)
        if wp is None:
            return Status.success()
        try:
            return wp.get_signal()
        finally:
            with self._waiting_lock:
                self._waiting_pods.pop(pod.metadata.uid, None)

    def bind(self, pod: Pod, node_name: str) -> None:
        # expected_rv: bind only if the pod is still at the version this
        # cycle evaluated; a Conflict rides error_func → requeue
        self.client.pods().bind(Binding(
            pod.metadata.name, pod.metadata.namespace, node_name,
            expected_rv=pod.metadata.resource_version or None))

    def _bind_race_refresh(self, qpi: QueuedPodInfo) -> bool:
        """A bind lost a race (Conflict, AlreadyBound, OutOfCapacity).  The
        event that made our copy stale arrived while the pod was
        in flight, invisible to the queue, so consult the informer cache:
        True when the pod left the schedulable population (bound by
        anyone, deleted, recreated) — drop it; False when it is still
        pending — the queued copy is refreshed so the retry carries the
        current version."""
        cur = self.informer_factory.informer_for("Pod").get(
            qpi.pod.metadata.key)
        if (cur is None or cur.metadata.uid != qpi.pod.metadata.uid
                or cur.spec.node_name):
            return True
        qpi.pod_info.pod = cur
        return False

    @staticmethod
    def _is_bind_race(err: BaseException) -> bool:
        return isinstance(err, (AlreadyBound, Conflict, OutOfCapacity))

    def _forget(self, uid: str) -> None:
        """Release the assume cache's hold on ``uid`` (the device engine
        keeps one)."""

    def _binding_cycle(self, qpi: QueuedPodInfo, pod: Pod, node_name: str,
                       state: Optional[CycleState] = None) -> None:
        """One pod's binding tail on its own thread (a Permit answered
        Wait): wait for the signal, then bind or requeue.  Host objects
        only: a binding thread never touches a tensor."""
        state = state if state is not None else CycleState()
        try:
            with self.metrics.timed("wait_on_permit"):
                status = self.wait_on_permit(pod)
            if not status.is_success():
                self.run_unreserve_plugins(state, pod, node_name)
                if is_gang_ttl_status(status):
                    # gang TTL release: the member was feasible, its peers
                    # never arrived, and no cluster event is coming to
                    # wake it — release the assume lease and requeue
                    # through the ACTIVE queue for a prompt retry
                    self._forget(pod.metadata.uid)
                    counters.inc("gang.ttl_requeued")
                    self.queue.add(qpi.pod, requeue=True)
                    if self.on_decision:
                        self.on_decision(pod, None, status)
                    return
                self.error_func(qpi, status.as_error(), plugin=status.plugin)
                if self.on_decision:
                    self.on_decision(pod, None, status)
                return
            with self.metrics.timed("bind"):
                self.bind(pod, node_name)
            self.queue.observe_bind(pod, node_name)
            if self.on_decision:
                self.on_decision(pod, node_name, Status.success())
        except Exception as err:
            self.run_unreserve_plugins(state, pod, node_name)
            if self._is_bind_race(err) and self._bind_race_refresh(qpi):
                # bound elsewhere or gone: no longer schedulable work; the
                # assumption still releases
                self._forget(pod.metadata.uid)
                if self.on_decision:
                    self.on_decision(pod, None, Status.from_error(err))
                return
            if isinstance(err, StorageDegraded):
                counters.inc("storage.degraded_parks")
            self.error_func(qpi, err)
            if self.on_decision:
                self.on_decision(pod, None, Status.from_error(err))
        finally:
            with self._bind_lock:
                self._bind_threads.discard(threading.current_thread())

    def _fork_binding_cycle(self, qpi: QueuedPodInfo, pod: Pod,
                            node_name: str, state: CycleState) -> None:
        t = threading.Thread(
            target=self._binding_cycle, args=(qpi, pod, node_name, state),
            name=f"bind-{pod.metadata.name}", daemon=True)
        with self._bind_lock:
            self._bind_threads.add(t)
        t.start()

    # -- failure path (minisched.go:283-298) ----------------------------
    def error_func(self, qpi: QueuedPodInfo, err: Optional[BaseException],
                   plugin: str = "") -> None:
        if isinstance(err, FitError):
            qpi.unschedulable_plugins = set(err.diagnosis.unschedulable_plugins)
        elif plugin:
            qpi.unschedulable_plugins = {plugin}
        self.queue.add_unschedulable(qpi)
