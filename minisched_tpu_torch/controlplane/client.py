"""Client facade over the control plane — the client-go surface.

A copy of ``minisched_tpu/controlplane/client.py``: ``nodes()`` and
``pods()`` with create, get, list, update and delete, the binding
subresource (``bind``, and ``bind_many``: a wave's placements in one
capacity-checked store transaction; on a sharded plane's group the
budgets of Nodes the group does not hold come from the capacity mirror,
JAX ``:228-303``), the ``EventRecorder`` that writes
scheduler events into the store, and the client-side QPS/Burst rate
limiter the reference configures at 5000/5000 (k8sapiserver.go:57-62) —
off by default, enabled per client.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from minisched_tpu_torch.api.objects import (
    Binding,
    Event,
    Node,
    ObjectMeta,
    Pod,
    PodStatus,
    POD_RUNNING,
)
from minisched_tpu_torch.controlplane.store import (
    Conflict,
    ObjectStore,
    StorageDegraded,
)
from minisched_tpu_torch.observability import counters

#: the reference's client limits (k8sapiserver.go:60-61)
DEFAULT_QPS = 5000.0
DEFAULT_BURST = 5000


class TokenBucket:
    """client-go flowcontrol-style token bucket: ``burst`` capacity
    refilled at ``qps`` tokens/sec; ``acquire`` blocks until a token is
    available."""

    def __init__(self, qps: float, burst: int):
        if qps <= 0:
            raise ValueError(f"qps must be positive, got {qps}")
        self._qps = float(qps)
        # a bucket that can never hold one whole token would block every
        # acquire forever — clamp like client-go's flowcontrol does
        self._burst = float(max(burst, 1))
        self._tokens = self._burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self) -> None:
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    self._burst, self._tokens + (now - self._last) * self._qps
                )
                self._last = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self._qps
            time.sleep(wait)


class _ThrottledStore:
    """Store proxy acquiring one rate-limit token per API operation (the
    client-go rate limiter gates every request; watch STREAMS pay one
    token at subscription, not per event — matching client-go, where the
    limiter covers requests, not watch deliveries)."""

    _THROTTLED = frozenset(
        # mutate_many / create_many are ONE API request each (batch
        # bind / batch create), so one token
        ("create", "create_many", "get", "list", "list_with_rv", "update",
         "delete", "mutate", "mutate_many", "watch")
    )

    def __init__(self, store: ObjectStore, limiter: TokenBucket):
        object.__setattr__(self, "_store", store)
        object.__setattr__(self, "_limiter", limiter)

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._store, name)
        if name in self._THROTTLED:
            limiter = self._limiter

            def gated(*args: Any, **kwargs: Any) -> Any:
                limiter.acquire()
                return attr(*args, **kwargs)

            return gated
        return attr

    def __setattr__(self, name: str, value: Any) -> None:
        setattr(self._store, name, value)


KIND_POD = "Pod"
KIND_NODE = "Node"
KIND_EVENT = "Event"
KIND_PV = "PersistentVolume"
KIND_PVC = "PersistentVolumeClaim"


class AlreadyBound(Exception):
    pass


class OutOfCapacity(Exception):
    """Commit-time node-capacity rejection on the bind subresource: a bind
    that would push the node past its allocatable CPU, memory or pod
    count is refused per item (the engine's assume cache makes this
    impossible for one engine; the transaction is the backstop)."""


def _raise_first_error(results: List[Any]) -> List[Any]:
    """The batch-create contract: every non-conflicting item is created;
    then the FIRST per-item KeyError is raised, with failed slots left
    as None."""
    out: List[Any] = []
    first_err: Optional[KeyError] = None
    for res in results:
        if isinstance(res, KeyError):
            out.append(None)
            if first_err is None:
                first_err = res
        elif isinstance(res, BaseException):
            raise res
        else:
            out.append(res)
    if first_err is not None:
        raise first_err
    return out


class _NodeAPI:
    def __init__(self, store: ObjectStore):
        self._store = store

    def create(self, node: Node) -> Node:
        # nodes are cluster-scoped: get/delete use the "" namespace
        node.metadata.namespace = ""
        return self._store.create(KIND_NODE, node)

    def create_many(self, nodes: List[Node],
                    return_objects: bool = True) -> List[Node]:
        for n in nodes:
            n.metadata.namespace = ""
        return _raise_first_error(
            self._store.create_many(KIND_NODE, nodes, return_objects))

    def get(self, name: str) -> Node:
        return self._store.get(KIND_NODE, "", name)

    def list(self) -> List[Node]:
        return self._store.list(KIND_NODE)

    def update(self, node: Node) -> Node:
        return self._store.update(KIND_NODE, node)

    def delete(self, name: str) -> None:
        self._store.delete(KIND_NODE, "", name)


class _PodAPI:
    def __init__(self, store: ObjectStore, namespace: str = "default"):
        self._store = store
        self._ns = namespace

    def create(self, pod: Pod) -> Pod:
        if not pod.metadata.namespace:
            pod.metadata.namespace = self._ns
        return self._store.create(KIND_POD, pod)

    def create_many(self, pods: List[Pod],
                    return_objects: bool = True) -> List[Pod]:
        for p in pods:
            if not p.metadata.namespace:
                p.metadata.namespace = self._ns
        return _raise_first_error(
            self._store.create_many(KIND_POD, pods, return_objects))

    def get(self, name: str, namespace: Optional[str] = None) -> Pod:
        return self._store.get(KIND_POD, namespace or self._ns, name)

    def list(self) -> List[Pod]:
        return self._store.list(KIND_POD)

    def update(self, pod: Pod) -> Pod:
        return self._store.update(KIND_POD, pod)

    def delete(self, name: str, namespace: Optional[str] = None) -> None:
        self._store.delete(KIND_POD, namespace or self._ns, name)

    def mutate(self, name: str, fn, namespace: Optional[str] = None) -> Pod:
        """Atomic read-modify-write under the store lock."""
        return self._store.mutate(KIND_POD, namespace or self._ns, name, fn)

    def bind(self, binding: Binding) -> Pod:
        """The binding subresource: sets spec.node_name exactly once."""
        [res] = self.bind_many([binding])
        if isinstance(res, BaseException):
            raise res
        return res

    @staticmethod
    def _node_budgets(store: ObjectStore, targets: set) -> Dict[str, list]:
        """Remaining [milli_cpu, memory, pods] per TARGET node from the
        store's live state (the caller holds the store lock): allocatable
        minus the store's per-node aggregates.  Nodes absent from the
        store get no budget and no check.

        A sharded group's store carries a ``_shard_budget_view``
        (``shards.ShardRuntime``): a Node this store does not hold (a
        non-home group holds none) takes the home group's allocatable
        minus every other vantage's usage from the rv-stamped mirror, as
        a 4th element the mirror's rv, which a refusal names; this
        group's own share is the live aggregate, under this very lock
        hold.  The home group also debits the board's reported non-home
        usage from the Nodes it holds."""
        budgets: Dict[str, list] = {}
        nodes = store._objects.get(KIND_NODE, {})
        view = getattr(store, "_shard_budget_view", None)
        for name in targets:
            node = nodes.get(f"/{name}")
            if node is None:
                if view is None:
                    continue
                counters.inc("shard.budget.mirror_checks")
                ent = view.budget(name)
                if ent is None:
                    counters.inc("shard.budget.unknown_node")
                    continue
                alloc, elsewhere, rv = ent
                b = [alloc[0] - elsewhere[0], alloc[1] - elsewhere[1],
                     alloc[2] - elsewhere[2], rv]
            else:
                alloc = node.status.allocatable
                b = [alloc.milli_cpu, alloc.memory, alloc.pods]
                extra = view.extra_used(name) if view is not None else None
                if extra is not None:
                    b = [b[0] - extra[0], b[1] - extra[1], b[2] - extra[2]]
            a = store._pod_node_agg.get(name)
            if a is not None:
                b[0] -= a[0]
                b[1] -= a[1]
                b[2] -= a[2]
            budgets[name] = b
        return budgets

    def bind_many(self, bindings: List[Binding],
                  return_objects: bool = True) -> List[Any]:
        """A wave's placements in one store transaction.  Returns a list
        aligned with ``bindings``: the bound Pod (None with
        ``return_objects=False``), or the exception for that entry
        (AlreadyBound, a missing pod's KeyError, a stale ``expected_rv``'s
        Conflict, OutOfCapacity).  The node budgets are computed under the
        same lock hold as the commits (``mutate_many``'s ``prepare``), and
        each bind debits its node's, so a later bind in the batch sees the
        earlier ones."""

        def apply_for(binding: Binding, budgets: Dict[str, list]):
            def apply(pod: Pod) -> Pod:
                # ``pod`` is the STORED object: build a new one and share
                # every sub-object a bind does not change
                spec = pod.spec
                if spec.node_name:
                    # checked before the rv precondition: a retried bind
                    # whose first attempt landed reads as AlreadyBound
                    raise AlreadyBound(
                        f"pod {pod.metadata.key} already bound to "
                        f"{spec.node_name}")
                if (binding.expected_rv is not None
                        and pod.metadata.resource_version
                        != binding.expected_rv):
                    raise Conflict(
                        f"stale resource_version for Pod {pod.metadata.key}: "
                        f"expected {binding.expected_rv}, have "
                        f"{pod.metadata.resource_version}")
                budget = budgets.get(binding.node_name)
                if budget is not None:
                    req = pod.resource_requests()
                    if (req.milli_cpu > budget[0] or req.memory > budget[1]
                            or req.pods > budget[2]):
                        # a budget of 4 came from the cross-shard mirror:
                        # the refusal carries the mirror's rv, so a
                        # consumer can judge how stale the verdict was
                        mirror = ""
                        if len(budget) > 3:
                            mirror = f", budget-mirror rv={budget[3]}"
                            counters.inc("shard.budget.refused")
                        raise OutOfCapacity(
                            f"node {binding.node_name} out of capacity for "
                            f"pod {pod.metadata.key} (remaining "
                            f"cpu={budget[0]}m mem={budget[1]} "
                            f"pods={budget[2]}{mirror})")
                    budget[0] -= req.milli_cpu
                    budget[1] -= req.memory
                    budget[2] -= req.pods
                new_spec = object.__new__(type(spec))
                new_spec.__dict__.update(spec.__dict__)
                new_spec.node_name = binding.node_name
                new = object.__new__(type(pod))
                new.metadata = pod.metadata.clone()
                new.spec = new_spec
                new.status = PodStatus(phase=POD_RUNNING)
                return new

            return apply

        # The rate-limit token (one per batch, matching _ThrottledStore)
        # is taken BEFORE the transaction: TokenBucket.acquire can sleep,
        # and sleeping while holding the store lock would stall every
        # other client and informer fanout behind this binder's throttle.
        # The transaction runs against the RAW store.
        limiter = getattr(self._store, "_limiter", None)
        if limiter is not None:
            limiter.acquire()
        raw = getattr(self._store, "_store", self._store)
        budgets: Dict[str, list] = {}
        items = [(b.pod_namespace, b.pod_name, apply_for(b, budgets))
                 for b in bindings]

        def prepare(store: ObjectStore) -> None:
            budgets.update(
                self._node_budgets(store, {b.node_name for b in bindings}))

        return raw.mutate_many(
            KIND_POD, items, return_objects=return_objects,
            clone_for_write=False, prepare=prepare)


class Client:
    """clientset.Interface equivalent over an in-process ``ObjectStore``.

    ``qps``/``burst`` enable the client-side rate limiter (the reference
    sets QPS/Burst 5000, k8sapiserver.go:57-62 — use DEFAULT_QPS /
    DEFAULT_BURST for that); None (default) = unlimited.
    """

    def __init__(
        self,
        store: Optional[ObjectStore] = None,
        qps: Optional[float] = None,
        burst: Optional[int] = None,
    ):
        raw = store or ObjectStore()
        if qps:
            self.rate_limiter: Optional[TokenBucket] = TokenBucket(
                qps, burst if burst is not None else int(qps)
            )
            self.store: Any = _ThrottledStore(raw, self.rate_limiter)
        else:
            self.rate_limiter = None
            self.store = raw

    def nodes(self) -> _NodeAPI:
        return _NodeAPI(self.store)

    def pods(self, namespace: str = "default") -> _PodAPI:
        return _PodAPI(self.store, namespace)


class EventRecorder:
    """Records scheduler lifecycle and per-decision events.

    With a ``store``, each event is also written as an ``Event`` object
    (list/watch-able) by a writer thread, so ``eventf`` on the scheduling
    path only enqueues; ``flush()`` waits for the queue to drain.
    ``max_events`` bounds both the in-process ``events`` deque and the
    Event objects kept in the store (the oldest is deleted past it)."""

    def __init__(self, store: Any = None, max_events: int = 2048) -> None:
        self._events: Any = deque(maxlen=max_events)
        self._store = store
        self._max_events = max_events
        self._seq = 0
        self._mu = threading.Lock()
        self._writer: Optional[threading.Thread] = None
        if store is not None:
            self._live: Any = deque()  # (namespace, name) in emit order
            self._q: Any = queue.Queue()
            self._writer = threading.Thread(
                target=self._drain, name="event-writer", daemon=True)
            self._writer.start()

    @property
    def events(self) -> list:
        with self._mu:
            return list(self._events)

    def eventf(self, obj: Any, event_type: str, reason: str,
               message: str) -> None:
        meta = getattr(obj, "metadata", None)
        regarding = getattr(meta, "key", "") if meta is not None else ""
        with self._mu:
            self._events.append({"object": regarding or str(obj),
                                 "type": event_type, "reason": reason,
                                 "message": message})
            self._seq += 1
            seq = self._seq
        if self._store is None:
            return
        subject = getattr(meta, "name", "") if meta is not None else ""
        namespace = (getattr(meta, "namespace", "")
                     if meta is not None else "") or "default"
        self._q.put(Event(
            metadata=ObjectMeta(name=f"{subject or 'scheduler'}.{seq:x}",
                                namespace=namespace),
            type=event_type, reason=reason, message=message,
            regarding=regarding))

    def _drain(self) -> None:
        while True:
            evt = self._q.get()
            try:
                if evt is None:  # close() sentinel
                    return
                self._store.create(KIND_EVENT, evt)
                self._live.append((evt.metadata.namespace, evt.metadata.name))
                if len(self._live) > self._max_events:
                    ns, name = self._live.popleft()
                    try:
                        self._store.delete(KIND_EVENT, ns, name)
                    except KeyError:
                        pass  # already gone: nothing to keep in step
            except Exception as err:
                # a full or closed store must not kill the writer; an
                # event shed to a degraded disk is counted, so an ENOSPC
                # episode shows in the recovery ledger, not as silence
                if isinstance(err, StorageDegraded):
                    counters.inc("storage.event_dropped_degraded")
            finally:
                self._q.task_done()

    def flush(self, timeout: float = 5.0) -> None:
        """Block until every enqueued event has been written (bounded)."""
        if self._store is None:
            return
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.01)

    def close(self, timeout: float = 5.0) -> None:
        """Drain and stop the writer thread.  Idempotent."""
        if self._writer is None:
            return
        self.flush(timeout)
        self._q.put(None)
        self._writer.join(timeout=timeout)
        self._writer = None
