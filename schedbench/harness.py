"""One run of one cell: set-up, the window, the drain, the check.

Set-up builds the cell's cluster from the seed, creates the nodes in the
port's in-process store (the API server in the process, as in the
reference), starts
``SchedulerService(client).start_scheduler(default_full_roster_config(),
device_mode=True, prewarm_scan=True)`` with the service's other defaults
(waves of 1,024, the pipelined loop), creates the bound initial pods,
and makes the mix's warm rollouts through the live engine, so the window
meets no lane shape for the first time.  The window starts at the first
action after that.  The traffic's clients create and delete through the
port's ``Client``; one watch on the store, consumed in batches, sees
every bind, and the clock stamps each create call and each batch the
watch hands over.

After the window no client starts a rollout; the drain waits for the
last binds (at most the mix's ``drain_s``).  The store is read back, the
engine stopped, the peak device memory read, and then the reference
judges every bind (``check.py``).
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

from schedbench.check import LIMITS, judge, passed
from schedbench.cluster import Cluster, make_cluster
from schedbench.spec import Cell, generator, metric_reader

#: the watch's poll while nothing arrives
POLL_S = 0.02
#: a device operation's name in the breakdown is cut to this many
#: characters (kernel names carry whole template argument lists)
OP_NAME_CHARS = 160


def p99(values: List[float]) -> float:
    """The 99th percentile by nearest rank: the least value with at least
    99% of the values at or below it."""
    if not values:
        return math.nan
    ordered = sorted(values)
    return ordered[max(math.ceil(0.99 * len(ordered)) - 1, 0)]


def end_to_end(window_s: float, created: Dict[str, float],
               seen: Dict[str, float], t0: float, t_end: float,
               ) -> Tuple[float, float, int, int]:
    """(pods_per_s, ttb_p99_s, attempted, failed): every bind seen in
    [t0, t_end) over the window's seconds; the 99th percentile of create
    to bind seen over every pod created in the window, an unbound pod
    counting as infinitely late."""
    binds = sum(1 for t in seen.values() if t0 <= t < t_end)
    waits = []
    failed = 0
    for name, t in created.items():
        if not t0 <= t < t_end:
            continue
        b = seen.get(name)
        if b is None:
            failed += 1
            waits.append(math.inf)
        else:
            waits.append(b - t)
    return binds / window_s, p99(waits), len(waits), failed


@dataclass
class Snapshot:
    """What the program's counters read at one moment."""

    t: float
    phases: Dict[str, Dict[str, float]]
    lanes: Dict[str, Dict[str, float]]
    binds: int


@dataclass
class RunRecord:
    """Everything a run saw, for the metrics and the check."""

    setup_s: float = 0.0
    t0: float = 0.0
    t_end: float = 0.0
    created: Dict[str, float] = field(default_factory=dict)
    seen: Dict[str, float] = field(default_factory=dict)
    #: ("bind", name, node) / ("delete", name) in the store's order
    events: List[tuple] = field(default_factory=list)
    #: pod name → (uid, template) of every pod the traffic created
    plans: Dict[str, Tuple[str, Any]] = field(default_factory=dict)
    store_nodes: Dict[str, str] = field(default_factory=dict)
    snaps: Dict[str, Snapshot] = field(default_factory=dict)
    trace: Any = None
    spans: List[tuple] = field(default_factory=list)
    memory_peak_bytes: int = 0
    loop_errors: int = 0
    #: (phase, seconds) of set-up, in order
    setup_phases: List[Tuple[str, float]] = field(default_factory=list)
    #: seconds the client spent in its delete calls, and the pods deleted
    delete_s: float = 0.0
    deletes: int = 0
    #: when the watch saw each rollout complete
    completions: List[float] = field(default_factory=list)
    #: seconds to close the trace and to reduce it
    trace_s: Dict[str, float] = field(default_factory=dict)


def _port_pod(name: str, uid: str, pod, namespace: str, node: str = ""):
    """A pod of ``pod``'s template (``cluster.PodTemplate``) as the
    program's API object."""
    from minisched_tpu_torch.api.objects import (
        LabelSelector,
        TopologySpreadConstraint,
        make_pod,
    )

    obj = make_pod(name, namespace=namespace,
                   requests={"cpu": f"{pod.cpu_m}m",
                             "memory": f"{pod.memory_mib}Mi"},
                   labels=dict(pod.labels), node_name=node)
    obj.metadata.uid = uid
    if pod.spread:
        obj.spec.topology_spread_constraints = [TopologySpreadConstraint(
            max_skew=c.max_skew, topology_key=c.topology_key,
            when_unsatisfiable=c.when_unsatisfiable,
            label_selector=LabelSelector(match_labels=dict(c.match_labels)))
            for c in pod.spread]
    return obj


def _port_objects(cluster: Cluster):
    """The cluster as the program's API objects: nodes and the bound
    initial pods."""
    from minisched_tpu_torch.api.objects import make_node

    nodes = [
        make_node(name, labels=cluster.node_labels(i),
                  capacity={"cpu": f"{int(cluster.cpu_m[i])}m",
                            "memory": f"{int(cluster.memory_mib[i])}Mi",
                            "pods": int(cluster.pods[i])})
        for i, name in enumerate(cluster.names)]
    pods = [_port_pod(name, name, cluster.initial_pod, cluster.namespace,
                      cluster.names[row])
            for name, row in cluster.initial]
    return nodes, pods


class Run:
    """One run of ``cell``; ``device``: the engine's device (a card, or
    ``"cpu"`` where the tests drive a run on the kernels' plain twins)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: Any, t_start: float, context: Any = None):
        import torch

        self.cell = cell
        self.seed = seed
        self.seconds = float(seconds)
        self.trace = trace
        self.device = torch.device(device)
        self.t_start = t_start
        #: a thread making the card's context, joined before the engine
        self.context = context
        self.rec = RunRecord()
        self.cluster = make_cluster(cell.config, seed)
        self.loop = generator(cell, seed)
        self._bound: Dict[str, str] = {}
        self._trace_from: Optional[int] = None
        self._tracer: Any = None
        #: the closed trace, reduced once the drain is over
        self._closed: Any = None

    # -- acting for the clients ---------------------------------------------
    def _act(self, actions) -> None:
        pods_api = self.client.pods(self.cluster.namespace)
        for kind, plans in actions:
            if kind == "delete":
                t = time.monotonic()
                for p in plans:
                    pods_api.delete(p.name)
                self.rec.delete_s += time.monotonic() - t
                self.rec.deletes += len(plans)
                continue
            self._maybe_start_trace()
            ns = self.cluster.namespace
            objs = [_port_pod(p.name, p.uid, p.pod, ns) for p in plans]
            for p in plans:
                self.rec.plans[p.name] = (p.uid, p.pod)
            t = time.monotonic()
            pods_api.create_many(objs, return_objects=False)
            for p in plans:
                self.rec.created[p.name] = t

    def _consume(self, timeout: float) -> None:
        """One batch off the watch: binds and deletes recorded, each bind
        handed to the clients."""
        from minisched_tpu_torch.controlplane.store import EventType

        batch = self.watch.next_batch(timeout=timeout)
        if not batch:
            return
        t = time.monotonic()
        actions = []
        for ev in batch:
            name = ev.obj.metadata.name
            if ev.type is EventType.DELETED:
                self.rec.events.append(("delete", name))
                self._bound.pop(name, None)
                continue
            node = ev.obj.spec.node_name
            if ev.type is not EventType.MODIFIED or not node:
                continue
            if self._bound.get(name) == node:
                continue  # an update of a bound pod, not a bind
            first = name not in self._bound
            self._bound[name] = node
            self.rec.events.append(("bind", name, node))
            if first:
                self.rec.seen[name] = t
                done = self.loop.completed
                actions += self.loop.on_bound(name)
                if self.loop.completed > done:
                    self.rec.completions.append(t)
        if actions:
            self._maybe_stop_trace()
            self._act(actions)

    # -- the traced interval --------------------------------------------------
    def _maybe_start_trace(self) -> None:
        if (not self.trace or self._tracer is not None
                or self._trace_from is not None or not self.rec.t0
                or time.monotonic() < self.rec.t0 + self.seconds / 3):
            return
        from schedbench.devtrace import DeviceTrace

        self.rec.snaps["trace_start"] = self._snapshot()
        self._tracer = DeviceTrace(self.device)
        self._tracer.start()
        self._trace_from = self.loop.completed

    def _maybe_stop_trace(self, force: bool = False) -> None:
        if self._tracer is None:
            return
        want = int(self.cell.traffic.get("trace_rollouts", 1))
        if not force and self.loop.completed - self._trace_from < want:
            return
        tracer, self._tracer = self._tracer, None
        t = time.monotonic()
        self._closed = tracer.stop()
        self.rec.trace_s["stop"] = time.monotonic() - t
        self.rec.snaps["trace_end"] = self._snapshot(tracer.t1)

    def _snapshot(self, t: Optional[float] = None) -> Snapshot:
        sched = self.sched
        lanes = {k: dict(vars(v)) for k, v in sched.scan_stats.items()}
        return Snapshot(t or time.monotonic(), sched.metrics.snapshot(),
                        lanes, len(self.rec.seen))

    # -- the run ------------------------------------------------------------
    def run(self) -> RunRecord:
        from minisched_tpu_torch.controlplane.client import Client
        from minisched_tpu_torch.service.config import (
            default_full_roster_config,
        )
        from minisched_tpu_torch.service.service import SchedulerService

        traffic = self.cell.traffic
        rec = self.rec
        last = [self.t_start]

        def phase(name: str) -> None:
            now = time.monotonic()
            rec.setup_phases.append((name, now - last[0]))
            last[0] = now

        phase("start")
        self.client = Client()
        nodes, pods = _port_objects(self.cluster)
        phase("objects")
        self.client.nodes().create_many(nodes, return_objects=False)
        del nodes
        phase("store")
        if self.context is not None:
            self.context.join()
            phase("context")
        metrics = None
        if self.trace:
            from schedbench.spans import SpanRecorder

            metrics = SpanRecorder()
        svc = SchedulerService(self.client)
        try:
            self.sched = svc.start_scheduler(
                default_full_roster_config(), device_mode=True,
                prewarm_scan=True, device=self.device, metrics=metrics)
            phase("engine")
            # The running pods come once the engine has synced the nodes:
            # an engine that lists bound pods before their nodes adopts
            # them with a scan of every such pod for each node (seconds
            # to tens of seconds here), which the informers' race makes
            # happen in some starts and not others.
            self.client.pods(self.cluster.namespace).create_many(
                pods, return_objects=False)
            del pods
            self.watch, _ = self.client.store.watch("Pod",
                                                    send_initial=False)
            phase("pods")
            # set-up's warm rollouts, then a barrier: the clients held
            self.loop.budget = int(traffic.get("warm_rollouts", 1))
            self._act(self.loop.start())
            # (past the drain's bound the window starts regardless: the
            # pods left unbound then fail the check)
            deadline = time.monotonic() + float(traffic.get("drain_s", 60))
            while ((not self.loop.holding or self.loop.in_flight())
                   and time.monotonic() < deadline):
                self._consume(POLL_S)
            phase("warm")
            # the window
            rec.t0 = time.monotonic()
            rec.setup_s = rec.t0 - self.t_start
            rec.snaps["t0"] = self._snapshot(rec.t0)
            self.loop.budget = None
            self._act(self.loop.release())
            rec.t_end = rec.t0 + self.seconds
            while time.monotonic() < rec.t_end:
                self._consume(min(POLL_S, max(rec.t_end - time.monotonic(),
                                              0.0)))
            self.loop.allow_new = False
            rec.snaps["t_end"] = self._snapshot(rec.t_end)
            # the drain
            deadline = time.monotonic() + float(traffic.get("drain_s", 60))
            while self.loop.in_flight() and time.monotonic() < deadline:
                self._consume(POLL_S)
            self._consume(POLL_S)
            self._maybe_stop_trace(force=True)
            if self.trace:
                if self._closed is None:
                    raise RuntimeError("the window ended before a rollout "
                                       "to trace began; lengthen the window")
                t = time.monotonic()
                rec.trace = self._closed.reduce()
                rec.trace_s["reduce"] = time.monotonic() - t
            rec.store_nodes = {
                p.metadata.name: p.spec.node_name
                for p in self.client.pods(self.cluster.namespace).list()}
            rec.loop_errors = self.sched.loop_errors
            if metrics is not None:
                rec.spans = list(metrics.spans)
        finally:
            watch = getattr(self, "watch", None)
            if watch is not None:
                watch.stop()
            svc.close()
        # the program's state is freed before the reference runs
        self.sched = None
        self.client = None
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
            rec.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))
            gc.collect()
            torch.cuda.empty_cache()
        return rec


# -- the result ---------------------------------------------------------------
def check_counts(run: Run) -> Dict[str, int]:
    rec = run.rec
    return judge(run.cluster, rec.plans, rec.events, rec.store_nodes)


def _delta(a: Snapshot, b: Snapshot) -> SimpleNamespace:
    """The counters between two snapshots."""
    phases = {}
    for name, s in b.phases.items():
        p = a.phases.get(name, {"count": 0, "total_s": 0.0})
        phases[name] = {"count": s["count"] - p["count"],
                        "total_s": s["total_s"] - p["total_s"]}
    lanes = {}
    for lane, s in b.lanes.items():
        p = a.lanes.get(lane, {})
        lanes[lane] = {k: v - p.get(k, 0) for k, v in s.items()}
    return SimpleNamespace(phases=phases, lanes=lanes, binds=b.binds - a.binds,
                           seconds=b.t - a.t)


def _minus(a: SimpleNamespace, b: SimpleNamespace) -> SimpleNamespace:
    phases = {k: {f: v[f] - b.phases.get(k, {}).get(f, 0) for f in v}
              for k, v in a.phases.items()}
    lanes = {k: {f: v[f] - b.lanes.get(k, {}).get(f, 0) for f in v}
             for k, v in a.lanes.items()}
    return SimpleNamespace(phases=phases, lanes=lanes, binds=a.binds - b.binds,
                           seconds=a.seconds - b.seconds)


def metric_context(run: Run) -> SimpleNamespace:
    """What the per-layer readers read (``metrics/<name>.py``):

    * ``untraced``: the program's counters over the window less the traced
      interval (``phases``: CycleMetrics count and seconds per phase;
      ``lanes``: each scan lane's ``scan_stats``; ``binds``: binds the
      watch saw; ``seconds``; ``self_s``: self seconds per phase from the
      engine's spans);
    * ``traced``: the same over the traced interval, with ``trace``
      (``devtrace.TraceData``);
    * ``node_width``: the node table's width of the cell's cluster."""
    from schedbench.roofline import node_width
    from schedbench.spans import self_times

    rec = run.rec
    snaps = rec.snaps
    whole = _delta(snaps["t0"], snaps["t_end"])
    traced = None
    intervals = [(snaps["t0"].t, snaps["t_end"].t)]
    if "trace_start" in snaps and "trace_end" in snaps:
        traced = _delta(snaps["trace_start"], snaps["trace_end"])
        traced.trace = rec.trace
        a, b = snaps["trace_start"].t, snaps["trace_end"].t
        if b <= snaps["t_end"].t:
            untraced = _minus(whole, traced)
        else:  # the trace outlasted the window: the window before it
            untraced = _delta(snaps["t0"], snaps["trace_start"])
            b = snaps["t_end"].t
        intervals = [(snaps["t0"].t, a), (b, snaps["t_end"].t)]
    else:
        untraced = whole
    untraced.self_s = self_times(rec.spans, intervals)
    return SimpleNamespace(untraced=untraced, traced=traced,
                           node_width=node_width(len(run.cluster.names)))


def breakdown(run: Run) -> Optional[Dict[str, list]]:
    from schedbench.spans import engine_thread, flat_timeline

    trace = run.rec.trace
    if trace is None:
        return None
    ops = sorted(((name[:OP_NAME_CHARS], secs)
                  for name, (_n, secs) in trace.by_name.items()),
                 key=lambda x: -x[1])[:10]
    pieces = flat_timeline(run.rec.spans, engine_thread(run.rec.spans))
    idle = sorted(trace.idle_by_span(pieces).items(), key=lambda x: -x[1])
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle[:10]]}


def result_line(run: Run, counts: Dict[str, int], device: Dict[str, Any]
                ) -> Dict[str, Any]:
    """The last line of standard output."""
    rec = run.rec
    pods_per_s, ttb, attempted, failed = end_to_end(
        run.seconds, rec.created, rec.seen, rec.t0, rec.t_end)
    metrics: Dict[str, Dict[str, Any]] = {}
    out: Dict[str, Any] = {"correct": passed(counts) and rec.loop_errors == 0,
                           "attempted": attempted, "failed": failed}
    if not run.trace:
        values = {"pods_per_s": pods_per_s,
                  # a pod never bound is beyond any limit
                  "ttb_p99_s": ttb if math.isfinite(ttb) else 1e9,
                  "setup_s": rec.setup_s}
        for m in run.cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = metric_context(run)
        for m in run.cell.per_layer:
            value = metric_reader(m["name"], run.cell.package_dir)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        trace = rec.trace
        device = dict(device, busy_s=trace.busy_s, window_s=trace.window_s)
        out["breakdown"] = breakdown(run)
    out["metrics"] = metrics
    out["device"] = device
    out["check"] = {name: {"value": counts[name], "limit": LIMITS[name]}
                    for name in LIMITS}
    out["check"]["loop_errors"] = {"value": rec.loop_errors, "limit": 0}
    return out

