"""The scalar scheduling engine and the host loop every engine stands on.

A copy of ``minisched_tpu/engine/scheduler.py``: the module-level
extension-point runners and ``schedule_pod_once`` (filter → pre-score →
score → normalize → seeded select-host for one pod, the one-pod loop of
the reference) with ``schedule_pods_sequentially`` (each placement
committed into the snapshot before the next pod: the ground truth of the
exact scan lane), and the ``Scheduler``: the event map built from the
plugins' ``events_to_register``, the scheduling queue, the NodeInfo cache
and the informer wiring (in the JAX order: the subclass's indexes, then
the cache, then the queue handlers), the run loop with the scalar
``schedule_one`` cycle (``engine/device_scheduler.py`` overrides it with
the device waves), the PostFilter / Reserve / Permit runners, the
waiting-pod registry (the ``Handle`` plugins call back into), the binding
cycle with its requeue paths, and ``new_scheduler`` (the reference's
default wiring).  The scalar engine is host code: it touches no tensor.

Left out: the HA shard filter.

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
from minisched_tpu_torch.engine.tiebreak import select_host
from minisched_tpu_torch.engine.waitingpod import WaitingPod
from minisched_tpu_torch.framework.events import (
    ClusterEventMap,
    merge_event_registrations,
    unioned_gvks,
)
from minisched_tpu_torch.framework.nodeinfo import NodeInfo
from minisched_tpu_torch.framework.plugin import (
    implements_enqueue,
    implements_pre_filter,
)
from minisched_tpu_torch.framework.types import (
    CycleState,
    Diagnosis,
    FitError,
    NodeScore,
    QueuedPodInfo,
    Status,
    is_success,
)
from minisched_tpu_torch.observability import counters, trace
from minisched_tpu_torch.observability.profiling import CycleMetrics
from minisched_tpu_torch.plugins.coscheduling import is_gang_ttl_status
from minisched_tpu_torch.queue.queue import SchedulingQueue
from minisched_tpu_torch.utils.hashing import pod_seed


def run_pre_filter_plugins(filter_plugins: List[Any], state: CycleState,
                           pod: Pod, node_infos: List[NodeInfo]
                           ) -> Tuple[Status, str]:
    """Once-per-pod PreFilter pass of the filter plugins that have one.
    Returns the first non-success status and the plugin that gave it."""
    for pl in filter_plugins:
        if implements_pre_filter(pl):
            status = pl.pre_filter(state, pod, node_infos)
            if not is_success(status):
                return status.with_plugin(status.plugin or pl.name()), pl.name()
    return Status.success(), ""


def run_filter_plugins(filter_plugins: List[Any], state: CycleState, pod: Pod,
                       node_infos: List[NodeInfo]
                       ) -> Tuple[List[NodeInfo], Diagnosis]:
    """Per node, per plugin, short-circuiting a node at its first failure
    (minisched.go:115-151); the Diagnosis feeds the event-gated requeue.
    An Error status raises."""
    feasible: List[NodeInfo] = []
    diagnosis = Diagnosis()
    for ni in node_infos:
        ok = True
        for pl in filter_plugins:
            status = pl.filter(state, pod, ni)
            if not is_success(status):
                ok = False
                status.with_plugin(status.plugin or pl.name())
                diagnosis.node_to_status[ni.name] = status
                diagnosis.unschedulable_plugins.add(pl.name())
                if status.code.name == "ERROR":
                    raise status.as_error()
                break
        if ok:
            feasible.append(ni)
    return feasible, diagnosis


def run_pre_score_plugins(pre_score_plugins: List[Any], state: CycleState,
                          pod: Pod, nodes: List[Any]) -> Status:
    for pl in pre_score_plugins:
        status = pl.pre_score(state, pod, nodes)
        if not is_success(status):
            return status.with_plugin(status.plugin or pl.name())
    return Status.success()


def run_score_plugins(score_plugins: List[Any], score_weights: Dict[str, int],
                      state: CycleState, pod: Pod,
                      node_names: List[str]) -> Dict[str, int]:
    """Score, normalize and the weighted sum (minisched.go:164-199, with
    the weights applied)."""
    totals: Dict[str, int] = {name: 0 for name in node_names}
    for pl in score_plugins:
        scores: List[int] = []
        for name in node_names:
            s, status = pl.score(state, pod, name)
            if not is_success(status):
                raise status.as_error()
            scores.append(s)
        ext = (pl.score_extensions() if hasattr(pl, "score_extensions")
               else None)
        if ext is not None:
            lst = [NodeScore(n, s) for n, s in zip(node_names, scores)]
            status = ext.normalize_score(state, pod, lst)
            if not is_success(status):
                raise status.as_error()
            scores = [ns.score for ns in lst]
        weight = score_weights.get(pl.name(), 1)
        for name, s in zip(node_names, scores):
            totals[name] += s * weight
    return totals


def schedule_pod_once(filter_plugins: List[Any], pre_score_plugins: List[Any],
                      score_plugins: List[Any], score_weights: Dict[str, int],
                      pod: Pod, node_infos: List[NodeInfo],
                      state: Optional[CycleState] = None) -> str:
    """One decision: pre-filter → filter → pre-score → score → select host
    (minisched.go:50-80).  Raises FitError or a plugin's error; returns
    the chosen node's name.  ``node_infos`` is the name-sorted snapshot:
    the tie-break is keyed on a node's index there, as the device
    kernels key it on the node table's row, so both agree even though
    scoring ran on the feasible nodes only."""
    state = state if state is not None else CycleState()
    # the snapshot lister: plugins read a node's aggregates under
    # "nodeinfo/<name>" and the whole snapshot under "nodeinfos"
    for ni in node_infos:
        state.write("nodeinfo/" + ni.name, ni)
    state.write("nodeinfos", node_infos)
    pf_status, pf_plugin = run_pre_filter_plugins(filter_plugins, state, pod,
                                                  node_infos)
    if not is_success(pf_status):
        if pf_status.code.name == "ERROR":
            raise pf_status.as_error()
        diagnosis = Diagnosis()
        diagnosis.unschedulable_plugins.add(pf_plugin)
        raise FitError(pod, len(node_infos), diagnosis)
    feasible, diagnosis = run_filter_plugins(filter_plugins, state, pod,
                                             node_infos)
    if not feasible:
        raise FitError(pod, len(node_infos), diagnosis)
    status = run_pre_score_plugins(pre_score_plugins, state, pod,
                                   [ni.node for ni in feasible])
    if not is_success(status):
        raise status.as_error()
    totals = run_score_plugins(score_plugins, score_weights, state, pod,
                               [ni.name for ni in feasible])
    seed = pod_seed(pod.metadata.uid or pod.metadata.name)
    feasible_names = {ni.name for ni in feasible}
    idx = select_host([totals.get(ni.name, 0) for ni in node_infos],
                      [ni.name in feasible_names for ni in node_infos], seed)
    return node_infos[idx].name


def schedule_pods_sequentially(filter_plugins: List[Any],
                               pre_score_plugins: List[Any],
                               score_plugins: List[Any],
                               score_weights: Dict[str, int],
                               pods: List[Pod],
                               node_infos: List[NodeInfo]) -> List[str]:
    """``schedule_pod_once`` for each pod in turn, each placement
    committed into the snapshot (``node_infos``, updated in place) before
    the next pod: the reference loop's visibility.  One node name per pod
    ('' = unschedulable).  The ground truth of the exact scan lane
    (``ops/sequential.py``)."""
    by_name = {ni.name: ni for ni in node_infos}
    out: List[str] = []
    for pod in pods:
        try:
            name = schedule_pod_once(filter_plugins, pre_score_plugins,
                                     score_plugins, score_weights, pod,
                                     node_infos)
        except FitError:
            out.append("")
            continue
        out.append(name)
        bound = pod.clone()
        bound.spec.node_name = name
        by_name[name].add_pod(bound)
    return out


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

        #: HA shard filter (``ha/membership.Membership.owns_pod``): when
        #: set, the event handlers admit only this engine's shard into
        #: the queue; None admits everything (one engine is a plane of
        #: one).  Installed before the informers start
        #: (``service.start_scheduler``), so the first replay is filtered.
        self.shard_filter: Optional[Callable[[Pod], bool]] = None

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
        """Queue-admission predicate the event handlers consult on every
        pending-pod event: does this engine schedule ``pod``?  An HA
        plane sets ``shard_filter`` so N engines partition the pods."""
        f = self.shard_filter
        return True if f is None else f(pod)

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

    def snapshot_nodes(self) -> List[NodeInfo]:
        """Name-sorted NodeInfo snapshot from the incremental cache."""
        return self.cache.snapshot()

    def schedule_one(self, timeout: Optional[float] = 0.5) -> bool:
        """One scalar cycle (minisched.go:32-113): pop a pod, snapshot,
        schedule, then reserve, permit and fork the binding cycle.
        Returns False when the queue gave nothing within ``timeout``."""
        qpi = self.queue.pop(timeout=timeout)
        if qpi is None:
            return False
        pod = qpi.pod
        state = CycleState()
        t_cycle = time.monotonic()
        with self.metrics.timed("snapshot"):
            node_infos = self.snapshot_nodes()
        try:
            with self.metrics.timed("schedule"):
                node_name = self._schedule_pod(state, pod, node_infos, qpi)
        except Exception as err:
            # park the pod BEFORE preempting: the victims' DELETE events
            # must find it in the unschedulableQ
            self.error_func(qpi, err)
            if isinstance(err, FitError):
                self.run_post_filter(state, pod, node_infos, err.diagnosis)
            if self.on_decision:
                self.on_decision(pod, None, Status.from_error(err))
            self.metrics.observe("cycle_failed", time.monotonic() - t_cycle)
            return True
        forked = self._reserve_permit_and_fork(qpi, pod, node_name, state)
        self.metrics.observe("cycle" if forked else "cycle_failed",
                             time.monotonic() - t_cycle)
        return True

    def _reserve_permit_and_fork(self, qpi: QueuedPodInfo, pod: Pod,
                                 node_name: str, state: CycleState) -> bool:
        """Reserve (rolled back on any later failure), permit, then the
        binding cycle on its own thread.  False when the pod failed (it
        already went through ``error_func``)."""
        status = self.run_reserve_plugins(state, pod, node_name)
        if not status.is_success():
            self.error_func(qpi, status.as_error(), plugin=status.plugin)
            if self.on_decision:
                self.on_decision(pod, None, status)
            return False
        with self.metrics.timed("permit"):
            status = self.run_permit_plugins(state, pod, node_name)
        if not status.is_success() and not status.is_wait():
            self.run_unreserve_plugins(state, pod, node_name)
            self.error_func(qpi, status.as_error(), plugin=status.plugin)
            if self.on_decision:
                self.on_decision(pod, None, status)
            return False
        self._fork_binding_cycle(qpi, pod, node_name, state)
        return True

    def _schedule_pod(self, state: CycleState, pod: Pod,
                      node_infos: List[NodeInfo], qpi: QueuedPodInfo) -> str:
        return schedule_pod_once(self.filter_plugins, self.pre_score_plugins,
                                 self.score_plugins, self.score_weights, pod,
                                 node_infos, state=state)

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
        API.  A plugin failure is printed, never raised: a preemption
        failure must not mask the pod's FitError path (it is already
        parked).  Each pass is timed as ``post_filter``."""
        if not self.post_filter_plugins:
            return None
        try:
            with self.metrics.timed("post_filter"):
                nominated, status = run_post_filter_plugins(
                    self.post_filter_plugins, state, pod, node_infos,
                    diagnosis)
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

    def run_filter_plugins(
        self, state: CycleState, pod: Pod, node_infos: List[NodeInfo]
    ) -> Tuple[List[NodeInfo], Diagnosis]:
        return run_filter_plugins(self.filter_plugins, state, pod, node_infos)

    def run_pre_score_plugins(
        self, state: CycleState, pod: Pod, nodes: List[Any]
    ) -> Status:
        return run_pre_score_plugins(self.pre_score_plugins, state, pod, nodes)

    def run_score_plugins(
        self, state: CycleState, pod: Pod, node_names: List[str]
    ) -> Dict[str, int]:
        return run_score_plugins(
            self.score_plugins, self.score_weights, state, pod, node_names
        )

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
    def _count_mirror_refusal(err: BaseException) -> None:
        """A bind a sharded group refused on its capacity mirror's verdict
        (``budget-mirror rv=`` in the OutOfCapacity) counts apart from a
        local capacity race: a stale mirror is sync lag, not contention
        (JAX ``scheduler.py:776-784``)."""
        if isinstance(err, OutOfCapacity) and "budget-mirror" in str(err):
            counters.inc("sched.bind_mirror_refusals")

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
            trace.span_pod(
                "bind", pod, node=node_name,
                wave=getattr(self, "_wave_seq", None),
            )
            self.queue.observe_bind(pod, node_name)
            if self.on_decision:
                self.on_decision(pod, node_name, Status.success())
        except Exception as err:
            self.run_unreserve_plugins(state, pod, node_name)
            self._count_mirror_refusal(err)
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


def new_scheduler(client: Client, informer_factory: SharedInformerFactory,
                  time_scale: float = 1.0,
                  queue_opts: Optional[dict] = None) -> Scheduler:
    """The reference's default wiring (initialize.go:44-66): filter
    [NodeUnschedulable], pre-score, score and permit [NodeNumber], on the
    scalar engine."""
    from minisched_tpu_torch.plugins.nodenumber import NodeNumber
    from minisched_tpu_torch.plugins.nodeunschedulable import NodeUnschedulable

    node_number = NodeNumber(time_scale=time_scale)
    sched = Scheduler(client, informer_factory,
                      filter_plugins=[NodeUnschedulable()],
                      pre_score_plugins=[node_number],
                      score_plugins=[node_number],
                      permit_plugins=[node_number], queue_opts=queue_opts)
    node_number.h = sched  # the Scheduler is the waiting-pod Handle
    return sched
