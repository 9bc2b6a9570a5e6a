"""Sharded write plane: namespace-partitioned leader groups (DESIGN.md §30,
§31).

A copy of ``minisched_tpu/controlplane/shards.py`` over the port's
objects, checkpoint codec (the handoff documents are JAX's bytes, so
either package seeds the other's groups) and remote store.  Every
mutation of a replicated plane still funnels through one leader's
group-commit barrier; this module partitions the keyspace by NAMESPACE
across K independent leader groups, each a full replicated plane of its
own (its own WAL, barrier, replication hub and checkpoints).

* **Placement** — ``ShardTopology.owner(namespace)``: the rendezvous
  hash of ``ha/membership.shard_owner`` over the sorted group ids, with
  ``overrides`` for namespaces a split reassigned.  Cluster-scoped kinds
  live in namespace "" and have one home group.
* **Server guard** — ``ShardInfo`` on each façade refuses writes for
  namespaces the topology assigns elsewhere (421 ``WrongShard``) or that
  sit inside a split's freeze (503 ``ShardFrozen``), before the store
  runs anything.  Freezes are TTL'd leases, journaled to the WAL.
* **Router** — ``ShardedStore``: one endpoint-aware ``RemoteStore`` a
  group, writes routed by namespace, ``WrongShard`` chased through
  ``/shards/status``.  K=1 is a passthrough to the one ``RemoteStore``.
* **Vector cursor** — ``VectorRV`` ``{group: rv}``: merged lists and
  watches (``ShardedWatch``) resume exactly once per shard.
* **Two-shard commit** — a bind batch spanning groups splits by owner
  and posts concurrently under one logical batch id, each binding's
  ordinal in the logical batch pinned as its ack id, so a retry replays
  from each group's ack registry.
* **Split** — ``split_namespace``: freeze lease, handoff ship from the
  source leader, seed the target leader, renew the lease, flip the
  topology epoch, thaw, purge the shipped objects from the source.
* **Capacity mirror** — the home group (owner of "") publishes a
  per-Node budget document; every other group mirrors it and reports
  its own usage back, so a bind on a non-home group is checked against
  the Node's allocatable under the same lock hold as its commit.
* **Runtime** — ``ShardRuntime`` (lease journal, budget sync loop,
  optional ``AutoSplitWatcher``), ``ShardedPlane`` (K groups of replica
  children, ``controlplane/replproc.py``).

Where the port differs, for its engine behind ``ShardedClient`` (JAX
never ran one there; ROADMAP §3):

* ``ShardedStore`` mints a uid for a uid-less create when K > 1.  Each
  group's store mints uids from its own sequence (JAX's replica children
  from their own process counters), so two groups hand out the same
  uids, and the engine keys its assume ledger and tie-break seeds by
  uid.
* ``ShardedWatch`` carries a consumer through a split.  JAX's merged
  stream drops the target's seed events (the router's topology still
  names the source) and passes the source's purge DELETEs while its
  topology is stale, so an informer loses the moved namespace's pending
  pods, or keeps their source copies, whose resource_versions the
  target never issued (every bind of them then a stale-rv Conflict).
  The port holds a group's stream from the first seed event until the
  topology flip (delivered then as MODIFIED, in order) or the split's
  abort (the orphan copies dropped), and refreshes the topology before
  it passes a live DELETE, so a purge is never delivered.

The K=1 plane (``MINISCHED_SHARDS=1``, or a façade with ``shard=None``)
is byte-identical to the unsharded plane: the guard never fires, the
router is a passthrough, no shard record touches the WAL.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from minisched_tpu_torch.controlplane.checkpoint import KIND_TYPES, _decode, _encode
from minisched_tpu_torch.controlplane.store import (
    EventType,
    HistoryCompacted,
    ShardFrozen,
    StorageDegraded,
    WatchEvent,
    WrongShard,
)
from minisched_tpu_torch.ha.membership import shard_owner
from minisched_tpu_torch.observability import counters, hist

__all__ = [
    "ShardTopology",
    "ShardInfo",
    "VectorRV",
    "ShardedStore",
    "ShardedWatch",
    "ShardedClient",
    "ShardedPlane",
    "ShardRuntime",
    "AutoSplitWatcher",
    "BudgetBoard",
    "BudgetMirror",
    "attach_shard_runtime",
    "build_budget_doc",
    "split_namespace",
    "build_handoff",
    "apply_seed",
    "purge_namespace",
    "shard_count",
]

_CLUSTER_SCOPED = {"Node", "PersistentVolume"}

#: default freeze-lease TTL (override per split / MINISCHED_FREEZE_TTL_S):
#: generous against a healthy split's millisecond handoff, tight against
#: an operator page — a dead coordinator's freeze thaws itself this fast
DEFAULT_FREEZE_TTL_S = 30.0


def shard_count(default: int = 1) -> int:
    """The ``MINISCHED_SHARDS`` kill switch: how many leader groups a
    harness should run.  1 (the default) is the unsharded plane —
    pinned byte-identical to the pre-shard plane by the parity test."""
    try:
        return max(int(os.environ.get("MINISCHED_SHARDS", str(default))), 1)
    except ValueError:
        return max(default, 1)


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------


class ShardTopology:
    """The pure-data shard map: which leader groups exist, which
    endpoints serve each, and which namespaces a split has reassigned.
    Pushed as config by the split coordinator (never consensus state — the
    correctness backstop is the server-side guard: a router holding a
    stale document gets a typed 421 and refreshes)."""

    def __init__(
        self,
        groups: Dict[str, List[str]],
        epoch: int = 1,
        overrides: Optional[Dict[str, str]] = None,
        frozen: Optional[List[str]] = None,
    ):
        if not groups:
            raise ValueError("topology requires at least one group")
        self.epoch = int(epoch)
        self.groups = {
            str(g): [u.rstrip("/") for u in urls] for g, urls in groups.items()
        }
        self.overrides = dict(overrides or {})
        self.frozen = set(frozen or [])
        for ns, gid in self.overrides.items():
            if gid not in self.groups:
                raise ValueError(f"override {ns!r} names unknown group {gid!r}")

    def owner(self, namespace: str) -> str:
        """The group owning ``namespace`` — override first, else the
        rendezvous hash over the sorted group ids.  Cluster-scoped
        objects live in namespace "" and get one deterministic home
        group like any other key."""
        own = self.overrides.get(namespace)
        if own is not None:
            return own
        return shard_owner(namespace, sorted(self.groups))

    def as_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "groups": {g: list(u) for g, u in self.groups.items()},
            "overrides": dict(self.overrides),
            "frozen": sorted(self.frozen),
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "ShardTopology":
        return cls(
            doc["groups"],
            epoch=doc.get("epoch", 1),
            overrides=doc.get("overrides"),
            frozen=doc.get("frozen"),
        )

    def copy(self) -> "ShardTopology":
        return ShardTopology.from_dict(self.as_dict())


class ShardInfo:
    """One façade's view of its own shard membership: the group this
    replica belongs to plus the current topology.  The ownership guard
    every write verb consults lives here (httpserver._shard_guard); the
    split coordinator mutates it through ``/shards/control``.

    Freeze state is held as per-namespace LEASES (DESIGN.md §31), never
    as a bare flag: every freeze carries a coordinator-chosen lease id
    and a TTL, and ``check_write`` reaps expired leases before judging —
    a split coordinator that dies mid-freeze strands NOTHING, because
    every replica auto-thaws independently at expiry.  Transitions are
    journaled through ``self.journal`` (the durable store's
    ``record_shard_lease`` when one is attached — see
    ``attach_shard_runtime``) so a replica restarting inside a freeze
    window keeps refusing until the TTL, not until someone notices.

    ``budget_board`` / ``budget_mirror`` hang the capacity-mirror halves
    here (home group: the board collecting remote usage reports; every
    other group: the rv-stamped mirror of the home group's budget doc)
    — one object per façade, wired by ``attach_shard_runtime``."""

    def __init__(self, group_id: str, topology: Any):
        self.group_id = str(group_id)
        if isinstance(topology, dict):
            topology = ShardTopology.from_dict(topology)
        self._mu = threading.Lock()
        self._topology = topology
        if self.group_id not in topology.groups:
            raise ValueError(
                f"group {self.group_id!r} not in topology "
                f"{sorted(topology.groups)}"
            )
        #: ns → {"ns", "lease_id", "ttl_s", "expires_at"} (wall clock);
        #: invariant: set(self._leases) == self._topology.frozen after
        #: every reap, so as_dict()/describe() stay truthful
        self._leases: Dict[str, dict] = {
            ns: self._new_lease(ns, "", None) for ns in topology.frozen
        }
        #: best-effort durable lease journal — callable(entry dict); set
        #: by attach_shard_runtime when the store can persist (never a
        #: ctor arg: in-process test stubs construct ShardInfo bare)
        self.journal: Optional[Callable[[dict], None]] = None
        #: per-namespace accepted-write tally since the last drain (the
        #: autosplit watcher's "hottest namespace" signal)
        self._write_counts: Dict[str, int] = {}
        self.budget_board: Optional["BudgetBoard"] = None
        self.budget_mirror: Optional["BudgetMirror"] = None

    @staticmethod
    def _new_lease(ns: str, lease_id: str, ttl_s: Any) -> dict:
        ttl = float(ttl_s) if ttl_s else DEFAULT_FREEZE_TTL_S
        return {
            "ns": ns,
            "lease_id": str(lease_id or ""),
            "ttl_s": ttl,
            "expires_at": time.time() + ttl,
        }

    def _journal_locked(self, entry: dict) -> None:
        j = self.journal
        if j is None:
            return
        try:
            j(entry)
        except Exception:  # noqa: BLE001 — best-effort: TTL bounds a
            pass  # dropped record's damage

    def _reap_locked(self, now: Optional[float] = None) -> None:
        """Drop expired leases (caller holds ``_mu``): the auto-thaw —
        coordinator death bounds the refusal window at the lease TTL
        with no operator in the loop."""
        now = time.time() if now is None else now
        for ns in [
            n for n, l in self._leases.items() if now >= l["expires_at"]
        ]:
            lease = self._leases.pop(ns)
            self._topology.frozen.discard(ns)
            counters.inc("storage.shard.freeze_expired")
            self._journal_locked(
                {"action": "thaw", "ns": ns, "lease_id": lease["lease_id"]}
            )

    def adopt_leases(self, recovered: Dict[str, dict]) -> None:
        """Re-arm freeze leases recovered from the WAL/checkpoint at
        boot (already journaled — adopting never re-journals); entries
        whose TTL lapsed while the process was down are dropped."""
        now = time.time()
        with self._mu:
            for ns, lease in recovered.items():
                if float(lease.get("expires_at", 0)) <= now:
                    continue
                self._leases[str(ns)] = {
                    "ns": str(ns),
                    "lease_id": str(lease.get("lease_id") or ""),
                    "ttl_s": float(
                        lease.get("ttl_s") or DEFAULT_FREEZE_TTL_S
                    ),
                    "expires_at": float(lease["expires_at"]),
                }
                self._topology.frozen.add(str(ns))

    @property
    def topology(self) -> ShardTopology:
        with self._mu:
            return self._topology

    def check_write(self, namespace: str) -> None:
        """Raise WrongShard/ShardFrozen when this group must not execute
        a write in ``namespace`` (the effective namespace: "" for
        cluster-scoped kinds).  Called BEFORE the store runs anything."""
        with self._mu:
            self._reap_locked()
            topo = self._topology
            lease = self._leases.get(namespace)
            if lease is not None:
                remaining = max(lease["expires_at"] - time.time(), 0.0)
                raise ShardFrozen(
                    f"shard frozen: namespace {namespace!r} is mid-split "
                    f"(epoch {topo.epoch}, lease "
                    f"{lease['lease_id'] or '-'} thaws in "
                    f"{remaining:.3f}s)"
                )
            own = topo.owner(namespace)
            if own != self.group_id:
                raise WrongShard(
                    f"wrong shard: namespace {namespace!r} is owned by "
                    f"group {own!r}, this façade serves group "
                    f"{self.group_id!r} (epoch {topo.epoch})"
                )

    def note_writes(self, namespaces: Any) -> None:
        """Tally accepted writes per effective namespace (one bump per
        namespace per request) — drained by the autosplit watcher."""
        with self._mu:
            wc = self._write_counts
            for ns in namespaces:
                wc[ns] = wc.get(ns, 0) + 1

    def drain_write_counts(self) -> Dict[str, int]:
        with self._mu:
            out, self._write_counts = self._write_counts, {}
            return out

    def describe(self) -> dict:
        with self._mu:
            self._reap_locked()
            now = time.time()
            return {
                "group": self.group_id,
                "epoch": self._topology.epoch,
                "topology": self._topology.as_dict(),
                "leases": {
                    ns: {
                        "lease_id": l["lease_id"],
                        "ttl_s": l["ttl_s"],
                        "expires_in_s": round(
                            max(l["expires_at"] - now, 0.0), 3
                        ),
                    }
                    for ns, l in self._leases.items()
                },
            }

    def apply_control(self, body: dict) -> None:
        """One ``/shards/control`` op: ``topology`` replaces the whole
        document (stale epochs refused — a racing older push must not
        roll the map back), ``freeze``/``unfreeze`` manage one
        namespace's split-window lease without an epoch bump, and
        ``budget_report`` folds a non-home group's node-usage aggregate
        into the home group's budget board.

        Freeze semantics (DESIGN.md §31): a fresh freeze creates a
        lease; re-freezing with the SAME lease id renews it (extends the
        TTL); with ``renew: true`` a renewal is refused (ValueError →
        HTTP 400 → the coordinator aborts the split) unless the very
        lease is still live — the coordinator's proof that no replica
        thawed and admitted writes mid-handoff.  Freezing over a LIVE
        foreign lease is refused, so two coordinators can never split
        the same namespace concurrently.  An unfreeze with a mismatched
        lease id is a NO-OP: a stale coordinator must not thaw a newer
        split's freeze."""
        op = body.get("op")
        if op == "topology":
            new = ShardTopology.from_dict(body["topology"])
            with self._mu:
                if new.epoch < self._topology.epoch:
                    raise ValueError(
                        f"stale topology epoch {new.epoch} < "
                        f"{self._topology.epoch}"
                    )
                self._reap_locked()
                # a freeze applied through the freeze op survives a
                # re-push that does not mention it; ones the push names
                # as unfrozen thaw here
                unfrozen = set(body["topology"].get("unfrozen", []))
                for ns in list(self._leases):
                    if ns in unfrozen:
                        lease = self._leases.pop(ns)
                        self._journal_locked(
                            {
                                "action": "thaw",
                                "ns": ns,
                                "lease_id": lease["lease_id"],
                            }
                        )
                # a pushed frozen list freezes WITH a default-TTL lease:
                # nothing is ever frozen without an expiry
                for ns in new.frozen:
                    if ns not in unfrozen and ns not in self._leases:
                        lease = self._new_lease(ns, "", None)
                        self._leases[ns] = lease
                        self._journal_locked(dict(lease, action="freeze"))
                new.frozen = set(self._leases)
                self._topology = new
            counters.inc("storage.shard.topology_updates")
        elif op == "freeze":
            ns = body["namespace"]
            lid = str(body.get("lease_id") or "")
            renew = bool(body.get("renew"))
            with self._mu:
                self._reap_locked()
                cur = self._leases.get(ns)
                if (
                    cur is not None
                    and lid
                    and cur["lease_id"]
                    and cur["lease_id"] != lid
                ):
                    raise ValueError(
                        f"namespace {ns!r} already frozen by lease "
                        f"{cur['lease_id']!r}"
                    )
                if renew and cur is None:
                    raise ValueError(
                        f"freeze lease {lid!r} on {ns!r} was lost "
                        f"(expired or thawed) — renewal refused"
                    )
                lease = self._new_lease(
                    ns,
                    lid or (cur or {}).get("lease_id", ""),
                    body.get("ttl_s"),
                )
                self._leases[ns] = lease
                self._topology.frozen.add(ns)
                self._journal_locked(dict(lease, action="freeze"))
            counters.inc("storage.shard.freezes")
        elif op == "unfreeze":
            ns = body["namespace"]
            lid = str(body.get("lease_id") or "")
            with self._mu:
                cur = self._leases.get(ns)
                if cur is None:
                    self._topology.frozen.discard(ns)
                elif not lid or not cur["lease_id"] \
                        or cur["lease_id"] == lid:
                    self._leases.pop(ns, None)
                    self._topology.frozen.discard(ns)
                    self._journal_locked(
                        {
                            "action": "thaw",
                            "ns": ns,
                            "lease_id": cur["lease_id"],
                        }
                    )
                # else: stale coordinator's unfreeze against a newer
                # lease — deliberately ignored
        elif op == "budget_report":
            gid = str(body.get("group") or "")
            if not gid:
                raise ValueError("budget_report requires group")
            board = self.budget_board
            if board is not None:
                board.report(
                    gid,
                    body.get("nodes") or {},
                    int(body.get("rv") or 0),
                )
        else:
            raise ValueError(f"unknown shard control op {op!r}")


# ---------------------------------------------------------------------------
# split machinery: handoff / seed / purge (server side)
# ---------------------------------------------------------------------------


def build_handoff(store: Any, namespace: str) -> dict:
    """One namespace's objects as a checkpoint-codec document — the §28
    snapshot encoding filtered to the moving namespace.  Served by the
    SOURCE group's leader while the namespace is frozen, so the doc is a
    consistent cut: no write can land between the per-kind lists."""
    objects: Dict[str, list] = {}
    names: Dict[str, list] = {}
    total = 0
    for kind in KIND_TYPES:
        shipped = [
            o for o in store.list(kind) if o.metadata.namespace == namespace
        ]
        if shipped:
            objects[kind] = [_encode(o) for o in shipped]
            # the keyed-purge manifest: the coordinator deletes exactly
            # these names after the flip, so a write that slipped in
            # post-thaw (lease expired mid-split) is never destroyed
            names[kind] = sorted(o.metadata.name for o in shipped)
            total += len(shipped)
    counters.inc("storage.shard.handoff_ships")
    counters.inc("storage.shard.handoff_objects", total)
    return {
        "version": 1,
        "namespace": namespace,
        "resource_version": store.applied_rv(),
        "objects": objects,
        "names": names,
    }


def apply_seed(store: Any, doc: dict) -> dict:
    """Install a handoff doc's objects into the TARGET group's store
    through the normal durable create path (they WAL, they replicate,
    they fan out — the namespace's history restarts cleanly on this
    group's rv line with uids preserved).  Idempotent per item: a
    retried seed's already-created objects come back as per-item
    conflicts and are counted as skipped."""
    created = skipped = 0
    for kind, items in (doc.get("objects") or {}).items():
        if kind not in KIND_TYPES:
            raise ValueError(f"handoff doc names unknown kind {kind!r}")
        objs = [_decode(KIND_TYPES[kind], it) for it in items]
        for res in store.create_many(kind, objs, return_objects=False):
            if isinstance(res, StorageDegraded):
                raise res
            if isinstance(res, BaseException):
                skipped += 1
            else:
                created += 1
    counters.inc("storage.shard.seed_objects", created)
    return {
        "namespace": doc.get("namespace", ""),
        "created": created,
        "skipped": skipped,
    }


def purge_namespace(
    store: Any, namespace: str, names: Optional[Dict[str, list]] = None
) -> dict:
    """Delete a moved namespace's objects from the SOURCE group after
    the topology flipped — the final step of a split.  The deletes fan
    out as DELETED watch events on this group; a vector-cursor watch
    suppresses them (the group no longer owns the namespace), so
    consumers keep the target group's live copies.

    When ``names`` (the handoff doc's per-kind manifest) is given the
    purge is KEYED: exactly the shipped objects are deleted.  Anything
    else in the namespace got there AFTER the handoff — a write admitted
    when the freeze lease expired under a slow coordinator — and was
    never copied to the target, so deleting it would be acked-write
    loss.  Survivors are counted (``storage.shard.purge_skipped``) and
    left for the 421 chase to surface."""
    deleted = skipped = 0
    for kind in KIND_TYPES:
        allow = None if names is None else set(names.get(kind, []))
        for o in store.list(kind):
            if o.metadata.namespace != namespace:
                continue
            if allow is not None and o.metadata.name not in allow:
                skipped += 1
                continue
            try:
                store.delete(kind, namespace, o.metadata.name)
                deleted += 1
            except KeyError:
                pass  # raced its own retry
    counters.inc("storage.shard.purged_objects", deleted)
    if skipped:
        counters.inc("storage.shard.purge_skipped", skipped)
    return {"namespace": namespace, "deleted": deleted, "skipped": skipped}


# ---------------------------------------------------------------------------
# vector cursor
# ---------------------------------------------------------------------------


def _covers(a: Dict[str, int], b: Dict[str, int]) -> bool:
    """Pointwise a ≥ b (missing components are 0)."""
    for k, v in b.items():
        if int(a.get(k, 0)) < int(v):
            return False
    return True


class VectorRV(dict):
    """A ``{group_id: rv}`` watch/list cursor over the sharded plane.

    Per-shard rvs never form one total order, so the cursor is a vector
    ordered by DOMINANCE: ``a > b`` iff a is pointwise ≥ b and has
    advanced somewhere.  That is exactly the comparison the informer's
    cursor logic performs (``ev.rv > self._last_rv``; ``max(cursor,
    start_rv)``) — events from a merged stream only ever advance one
    component at a time, so successive cursors are always comparable and
    the informer code runs UNCHANGED over vectors.  Serializes as a
    plain JSON object (it is a dict).

    Against an int, only the 0/"" falsy case is ever exercised (the
    informer's initial cursor): truthiness and ``> 0`` mean "any
    component has advanced"."""

    def __bool__(self) -> bool:
        return any(int(v) > 0 for v in self.values())

    def __gt__(self, other: Any) -> bool:
        if isinstance(other, dict):
            return _covers(self, other) and not _covers(other, self)
        o = int(other)
        if o <= 0:
            return bool(self)
        return bool(self) and min(int(v) for v in self.values()) > o

    def __ge__(self, other: Any) -> bool:
        if isinstance(other, dict):
            return _covers(self, other)
        o = int(other)
        if o <= 0:
            return True
        return bool(self) and min(int(v) for v in self.values()) >= o

    def __lt__(self, other: Any) -> bool:
        if isinstance(other, dict):
            return _covers(other, self) and not _covers(self, other)
        return not self.__ge__(other)

    def __le__(self, other: Any) -> bool:
        if isinstance(other, dict):
            return _covers(other, self)
        return not self.__gt__(other)


# ---------------------------------------------------------------------------
# merged watch
# ---------------------------------------------------------------------------

#: how long a per-shard merger waits between reopen attempts after its
#: stream dies mid-run (the per-group RemoteStore already rotates
#: endpoints inside one open; this paces attempts across elections)
_REOPEN_BACKOFF_S = 0.25
_REOPEN_BACKOFF_MAX_S = 2.0
#: how often a held group's merger polls the topology during a split
_HOLD_POLL_S = 0.05


class ShardedWatch:
    """K per-group watch streams merged into one Watch-shaped consumer.

    Every delivered event is RE-TAGGED with the vector cursor after it
    (``{**cursor, group: event.rv}`` built under the merge lock, so
    cursors are monotone in delivery order).  A shard's stream dying
    mid-run reopens ONLY that shard at its last-delivered component rv —
    the server's exact ``rv > resume_rv`` replay keeps that shard
    exactly-once while the other shards never miss a beat.  Any shard's
    history being compacted past its cursor kills the whole watch (the
    consumer's 410 path relists with a fresh vector).

    Ownership filter: LIVE events from a group that does not own the
    event's namespace (stale pre-move copies) are suppressed — the
    owner's stream is the one source of truth per namespace.  Initial
    snapshot replay is NOT suppressed: the SYNC contract promises
    exactly ``initial_count()`` replayed events and the sync barrier
    counts them.

    Splits (the port's addition, see the module docstring): a live
    ADDED from a group that does not own its namespace is a split's
    seed.  From it on, that group's events are HELD, in order, while
    the merger polls the topology: once the namespace's owner is that
    group, the held events are delivered (an object the consumer knew on
    another group arrives as MODIFIED, not ADDED); once the namespace is
    no longer frozen and still owned by the source, the split aborted
    and the seed's orphan copies are dropped.  A live DELETED refreshes
    the router's topology before it is judged, so the source's purge
    (which runs after the flip) is suppressed even when no write of this
    router has chased a 421 yet."""

    def __init__(
        self,
        sstore: "ShardedStore",
        kind: str,
        send_initial: bool,
        resume: Optional[Dict[str, int]],
    ):
        self._sstore = sstore
        self._kind = kind
        self._cond = threading.Condition()
        self._events: List[WatchEvent] = []
        self._stopped = False
        self._explicit_stop = False
        self._initial_total = 0
        gids = sorted(sstore._stores)
        if resume is not None:
            missing = [g for g in gids if int(resume.get(g, 0)) <= 0]
            if missing:
                # a group this cursor has never observed (topology grew
                # since the cursor was cut): resuming it from 0 would
                # replay its whole history — force the relist path, the
                # fresh list carries a complete vector
                raise HistoryCompacted(
                    f"vector cursor missing groups {missing} "
                    f"(topology epoch {sstore._topology.epoch})"
                )
        self._shard_rv: Dict[str, int] = {}
        self._watches: Dict[str, Any] = {}
        #: initial-replay countdown per group: events inside it bypass
        #: the ownership filter (see class docstring)
        self._replaying: Dict[str, int] = {}
        #: a held group → {"ns": the moving namespace, "events": its
        #: events since the seed began, "rv": the last of them}
        self._held: Dict[str, dict] = {}
        #: namespace.name → the group whose copy was last delivered
        #: (namespaced kinds only): a moved object's first event from its
        #: new owner is a MODIFIED
        self._key_group: Dict[str, str] = {}
        self._namespaced = kind not in _CLUSTER_SCOPED
        opened: List[Any] = []
        try:
            for gid in gids:
                rs = sstore._stores[gid]
                rv = int(resume[gid]) if resume is not None else None
                w, snapshot = rs.watch(
                    kind,
                    send_initial=send_initial and resume is None,
                    resume_rv=rv,
                )
                opened.append(w)
                self._watches[gid] = w
                self._shard_rv[gid] = (
                    rv if rv is not None else int(getattr(w, "start_rv", 0))
                )
                self._replaying[gid] = len(snapshot)
                self._initial_total += len(snapshot)
        except BaseException:
            for w in opened:
                w.stop()
            raise
        self.start_rv = VectorRV(self._shard_rv)
        self._threads = [
            threading.Thread(
                target=self._merge,
                args=(gid,),
                name=f"shard-watch-{kind}-{gid}",
                daemon=True,
            )
            for gid in gids
        ]
        for t in self._threads:
            t.start()

    # -- merger -------------------------------------------------------------
    def _merge(self, gid: str) -> None:
        watch = self._watches[gid]
        backoff = _REOPEN_BACKOFF_S
        while True:
            with self._cond:
                if self._stopped:
                    return
                held = gid in self._held
            if held:
                self._resolve(gid)
            batch = watch.next_batch(timeout=_HOLD_POLL_S if held else 0.25)
            if batch:
                backoff = _REOPEN_BACKOFF_S
                self._deliver(gid, batch)
                continue
            if not watch.stopped:
                continue
            if self._explicit_stop:
                return
            # mid-run stream death: reopen ONLY this shard at its
            # last-delivered (or last-held) component rv — the other
            # shards' mergers never notice
            try:
                watch = self._reopen(gid)
                self._watches[gid] = watch
                backoff = _REOPEN_BACKOFF_S
            except HistoryCompacted:
                # this shard's tail is gone past our cursor: the whole
                # vector cursor is dead — consumer must relist
                self._die()
                return
            except Exception:
                with self._cond:
                    if self._stopped:
                        return
                time.sleep(backoff)
                backoff = min(backoff * 2, _REOPEN_BACKOFF_MAX_S)

    def _reopen(self, gid: str) -> Any:
        with self._cond:
            rv = max(self._shard_rv[gid],
                     int(self._held.get(gid, {}).get("rv", 0)))
        counters.inc("shard.watch_reopen")
        w, _ = self._sstore._stores[gid].watch(
            self._kind, send_initial=False, resume_rv=rv
        )
        return w

    def _ns_of(self, ev: WatchEvent) -> str:
        return "" if not self._namespaced else ev.obj.metadata.namespace

    def _deliver(self, gid: str, batch: List[WatchEvent]) -> None:
        sstore = self._sstore
        with self._cond:
            live = len(batch) - self._replaying.get(gid, 0)
        if self._namespaced and live > 0 and any(
                ev.type == EventType.DELETED for ev in batch[-live:]):
            # a delete may be a split's purge, which runs only after the
            # flip reached every replica: judge it on a fresh topology
            sstore.refresh_topology()
        out: List[WatchEvent] = []
        with self._cond:
            if self._stopped:
                return
            for ev in batch:
                replay = self._replaying.get(gid, 0)
                if replay > 0:
                    self._replaying[gid] = replay - 1
                    self._emit_locked(gid, ev, out, filtered=False)
                    continue
                held = self._held.get(gid)
                if held is not None:
                    held["events"].append(ev)
                    held["rv"] = max(held["rv"], ev.rv)
                    continue
                ns = self._ns_of(ev)
                if (self._namespaced and ev.type == EventType.ADDED
                        and sstore._owner_gid(ns) != gid):
                    # a split's seed: hold this group until it resolves
                    counters.inc("shard.watch.held")
                    self._held[gid] = {"ns": ns, "events": [ev],
                                       "rv": ev.rv}
                    continue
                self._emit_locked(gid, ev, out)
            if out:
                self._events.extend(out)
                self._cond.notify_all()

    def _emit_locked(self, gid: str, ev: WatchEvent, out: List[WatchEvent],
                     filtered: bool = True,
                     moved: Optional[str] = None) -> None:
        """Advance ``gid``'s cursor past ``ev`` and append it, re-tagged,
        to ``out`` (caller holds the condition) — unless the filter says
        its group does not own its namespace, or it is a seed's orphan
        copy of an aborted split (``moved`` None for a held event of the
        moving namespace)."""
        ns = self._ns_of(ev)
        if ev.rv > self._shard_rv[gid]:
            # the cursor advances past suppressed events too — a resume
            # must not replay them
            self._shard_rv[gid] = ev.rv
        if filtered and self._sstore._owner_gid(ns) != gid:
            counters.inc("shard.events_suppressed")
            return
        typ = ev.type
        if self._namespaced:
            key = f"{ns}/{ev.obj.metadata.name}"
            last = self._key_group.get(key)
            if typ == EventType.DELETED:
                self._key_group.pop(key, None)
            else:
                if typ == EventType.ADDED and last is not None \
                        and last != gid:
                    # the new owner's copy of an object this stream
                    # delivered from the old one
                    typ = EventType.MODIFIED
                self._key_group[key] = gid
        out.append(
            WatchEvent(
                typ,
                ev.obj,
                old_obj=ev.old_obj,
                rv=VectorRV(self._shard_rv),
                born=ev.born,
            )
        )

    def _resolve(self, gid: str) -> None:
        """One poll of a held group's split: release its events once the
        moving namespace is its own, or drop the seed's copies once the
        split is over without the flip; otherwise keep holding."""
        with self._cond:
            held = self._held.get(gid)
            if held is None:
                return
            ns = held["ns"]
            src = self._sstore._owner_gid(ns)
        frozen = self._frozen_on(src, ns)
        self._sstore.refresh_topology()
        owner = self._sstore._owner_gid(ns)
        if owner == gid:
            moved = True
        elif frozen is False:
            moved = False  # thawed without a flip: the split aborted
        else:
            return
        out: List[WatchEvent] = []
        with self._cond:
            held = self._held.pop(gid, None)
            if held is None or self._stopped:
                return
            for ev in held["events"]:
                if (not moved and ev.type == EventType.ADDED
                        and self._ns_of(ev) == ns):
                    counters.inc("shard.events_suppressed")
                    if ev.rv > self._shard_rv[gid]:
                        self._shard_rv[gid] = ev.rv
                    continue
                self._emit_locked(gid, ev, out)
            if out:
                self._events.extend(out)
                self._cond.notify_all()
        counters.inc("shard.watch.moves" if moved else "shard.watch.aborts")

    def _frozen_on(self, gid: str, ns: str) -> Optional[bool]:
        """Whether ``ns`` is frozen on group ``gid`` per the first of its
        façades that answers ``/shards/status`` (None: none answered)."""
        with self._sstore._mu:
            rs = self._sstore._stores.get(gid)
        for url in (rs._endpoints if rs is not None else []):
            try:
                return ns in fetch_topology(url, timeout_s=2.0).frozen
            except Exception:  # noqa: BLE001 — dead replica, probe on
                continue
        return None

    def _die(self) -> None:
        with self._cond:
            if self._stopped:
                return
            self._stopped = True
            self._cond.notify_all()
        for w in self._watches.values():
            try:
                w.stop()
            except Exception:
                pass

    # -- Watch surface ------------------------------------------------------
    def initial_count(self, timeout: float = 30.0) -> int:
        return self._initial_total

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        batch = self._wait(timeout, take_all=False)
        return batch[0] if batch else None

    def next_batch(self, timeout: Optional[float] = None) -> List[WatchEvent]:
        return self._wait(timeout, take_all=True)

    def _wait(
        self, timeout: Optional[float], take_all: bool
    ) -> List[WatchEvent]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._events and not self._stopped:
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        break
            if not self._events:
                return []
            if take_all:
                out, self._events = self._events, []
                return out
            return [self._events.pop(0)]

    def stop(self) -> None:
        self._explicit_stop = True
        self._die()

    @property
    def stopped(self) -> bool:
        with self._cond:
            return self._stopped


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

#: bounded WrongShard chase: stale-topology retries per logical call
_CHASE_ATTEMPTS = 3


def _raw_req(
    base: str, method: str, path: str, payload: Any = None,
    timeout_s: float = 10.0,
) -> Tuple[int, Any]:
    """One pooled request outside any RemoteStore (topology discovery
    and the split coordinator's control fanout)."""
    from minisched_tpu_torch.controlplane.httppool import shared_pool

    data = json.dumps(payload).encode() if payload is not None else None
    status, raw, _ = shared_pool(base, timeout_s=timeout_s).request(
        method, path, body=data
    )
    try:
        doc = json.loads(raw) if raw else {}
    except ValueError:
        doc = {}
    return status, doc


def fetch_topology(url: str, timeout_s: float = 10.0) -> ShardTopology:
    """One façade's ``/shards/status`` → its topology document.  A 404
    means the server is UNSHARDED: synthesized as a single-group
    topology so every router code path (including the K=1 parity
    passthrough) works against it unchanged."""
    status, doc = _raw_req(url, "GET", "/shards/status", timeout_s=timeout_s)
    if status == 404:
        return ShardTopology({"g0": [url]}, epoch=0)
    if status != 200:
        raise RuntimeError(f"GET {url}/shards/status: HTTP {status}: {doc}")
    return ShardTopology.from_dict(doc["topology"])


class ShardedStore:
    """The ObjectStore surface informers + the engine consume, routed
    across K leader groups.  One endpoint-aware RemoteStore per group;
    ``**remote_kwargs`` pass through to each (timeouts, retry policy,
    fault fabric).

    K=1 is a literal passthrough to the single RemoteStore — scalar
    rvs, the same RemoteWatch objects, the same bytes on the wire: the
    kill-switch parity path."""

    def __init__(
        self,
        seeds: Optional[List[str]] = None,
        topology: Optional[ShardTopology] = None,
        **remote_kwargs: Any,
    ):
        if topology is None:
            if not seeds:
                raise ValueError("ShardedStore needs seeds or a topology")
            last: Optional[BaseException] = None
            for url in seeds:
                try:
                    topology = fetch_topology(url)
                    break
                except Exception as e:  # noqa: BLE001 — probe next seed
                    last = e
            if topology is None:
                raise RuntimeError(f"no seed answered /shards/status: {last}")
        self._kw = dict(remote_kwargs)
        self._mu = threading.Lock()
        self._topology = topology
        self._stores: Dict[str, Any] = {}
        self._build_stores(topology)
        #: RemoteStore parity: informer jitter reads ``store.faults``
        self.faults = self._kw.get("faults")

    @staticmethod
    def _discover_endpoints(eps: List[str]) -> List[str]:
        """Union a group's topology endpoints with the follower data
        urls its ``/repl/status`` advertises (§29 multi-endpoint read
        client folded into the router): reads/watches then fan across
        that group's whole replica set even when the topology document
        only names the leader.  A 404 means the group is unreplicated —
        nothing to add; probe failures keep the topology list."""
        out = [u.rstrip("/") for u in eps]
        for url in out:
            try:
                status, doc = _raw_req(url, "GET", "/repl/status")
            except Exception:  # noqa: BLE001 — dead endpoint, probe on
                continue
            if status != 200:
                continue
            for peer in doc.get("peers") or []:
                pu = str(peer.get("url") or "").rstrip("/")
                if pu and pu not in out:
                    out.append(pu)
                    counters.inc("shard.endpoint_discoveries")
            break  # one live answer describes the whole group
        return out

    def _build_stores(self, topology: ShardTopology) -> None:
        from minisched_tpu_torch.controlplane.remote import RemoteStore

        fresh: Dict[str, Any] = {}
        for gid, eps in topology.groups.items():
            eps = self._discover_endpoints(eps)
            old = self._stores.get(gid)
            if old is not None and old._endpoints == eps:
                fresh[gid] = old
                continue
            fresh[gid] = RemoteStore(
                eps[0], endpoints=list(eps), **self._kw
            )
        for gid, rs in self._stores.items():
            if fresh.get(gid) is not rs:
                rs.close()
        self._stores = fresh

    # -- routing ------------------------------------------------------------
    @property
    def topology(self) -> ShardTopology:
        with self._mu:
            return self._topology

    @property
    def _single(self) -> Optional[Any]:
        """The one RemoteStore when K == 1 (the passthrough path)."""
        with self._mu:
            if len(self._stores) == 1:
                return next(iter(self._stores.values()))
        return None

    def _owner_gid(self, namespace: str) -> str:
        with self._mu:
            return self._topology.owner(namespace)

    def _effective_ns(self, kind: str, namespace: str) -> str:
        return "" if kind in _CLUSTER_SCOPED else (namespace or "default")

    def _store_for(self, kind: str, namespace: str) -> Any:
        gid = self._owner_gid(self._effective_ns(kind, namespace))
        with self._mu:
            return self._stores[gid]

    def refresh_topology(self) -> ShardTopology:
        """Re-discover the topology from every known endpoint, adopting
        the highest epoch that answers — the WrongShard chase's other
        half."""
        t0 = time.monotonic()
        with self._mu:
            urls = [u for eps in self._topology.groups.values() for u in eps]
            best = self._topology
        for url in urls:
            try:
                topo = fetch_topology(url)
            except Exception:  # noqa: BLE001 — dead endpoint, probe on
                continue
            if topo.epoch > best.epoch:
                best = topo
        with self._mu:
            if best.epoch > self._topology.epoch:
                self._topology = best
                self._build_stores(best)
            out = self._topology
        counters.inc("shard.topology_refreshes")
        hist.observe("shard.route_s", time.monotonic() - t0)
        return out

    def _chase(self, fn: Any) -> Any:
        """Run ``fn()`` (which resolves its target group per call),
        refreshing topology on WrongShard — the typed 421 a stale
        router gets from a façade whose namespace moved."""
        last: Optional[BaseException] = None
        for _ in range(_CHASE_ATTEMPTS):
            try:
                return fn()
            except WrongShard as e:
                counters.inc("shard.wrong_shard_chased")
                last = e
                self.refresh_topology()
        raise last if last is not None else RuntimeError("unreachable")

    # -- session rv (vector) -------------------------------------------------
    @property
    def session_rv(self) -> Any:
        single = self._single
        if single is not None:
            return single.session_rv
        with self._mu:
            return VectorRV(
                {g: rs.session_rv for g, rs in self._stores.items()}
            )

    def observe_rv(self, rv: Any) -> None:
        """Advance per-group session floors from a vector cursor.  A
        bare int is DROPPED in multi-group mode on purpose: a scalar rv
        carries no group identity, and bounding every group's reads by
        it would 504 unrelated shards' followers against a number from
        someone else's history (the exact failure the vector cursor
        exists to prevent)."""
        single = self._single
        if single is not None:
            if isinstance(rv, dict):
                rv = max((int(v) for v in rv.values()), default=0)
            single.observe_rv(int(rv))
            return
        if not isinstance(rv, dict):
            return
        with self._mu:
            stores = dict(self._stores)
        for gid, component in rv.items():
            rs = stores.get(gid)
            if rs is not None:
                rs.observe_rv(int(component))

    # -- reads --------------------------------------------------------------
    def get(self, kind: str, namespace: str, name: str) -> Any:
        single = self._single
        if single is not None:
            return single.get(kind, namespace, name)
        try:
            return self._store_for(kind, namespace).get(kind, namespace, name)
        except KeyError:
            # the namespace may have MOVED since our topology: one
            # refresh, and only a changed owner earns a retry (a true
            # 404 must not pay a second round trip every time)
            ns = self._effective_ns(kind, namespace)
            before = self._owner_gid(ns)
            self.refresh_topology()
            if self._owner_gid(ns) == before:
                raise
            return self._store_for(kind, namespace).get(kind, namespace, name)

    def list(self, kind: str) -> List[Any]:
        return self.list_with_rv(kind)[0]

    def list_with_rv(self, kind: str) -> Tuple[List[Any], Any]:
        """Merged cross-shard list under a vector rv: each group's
        snapshot is epoch-consistent per shard, filtered to the
        namespaces that group OWNS (a mid-split double-residence never
        yields duplicates), concatenated.  The vector rv is exactly the
        resume cursor a follow-up ``watch(resume_rv=...)`` consumes."""
        single = self._single
        if single is not None:
            return single.list_with_rv(kind)
        with self._mu:
            stores = dict(self._stores)
        items: List[Any] = []
        rv = VectorRV()
        for gid in sorted(stores):
            sub, sub_rv = stores[gid].list_with_rv(kind)
            for o in sub:
                ns = self._effective_ns(kind, o.metadata.namespace)
                if self._owner_gid(ns) == gid:
                    items.append(o)
            rv[gid] = int(sub_rv)
        return items, rv

    def watch(
        self,
        kind: str,
        send_initial: bool = True,
        resume_rv: Any = None,
    ) -> Tuple[Any, List[Any]]:
        single = self._single
        if single is not None:
            if isinstance(resume_rv, dict):
                resume_rv = max(
                    (int(v) for v in resume_rv.values()), default=0
                )
            return single.watch(
                kind, send_initial=send_initial, resume_rv=resume_rv
            )
        resume: Optional[Dict[str, int]] = None
        if isinstance(resume_rv, dict):
            resume = {g: int(v) for g, v in resume_rv.items()}
        elif resume_rv:
            # a scalar resume cursor cannot be attributed to any shard:
            # force the relist path rather than replay the wrong history
            raise HistoryCompacted(
                f"scalar resume cursor {resume_rv!r} on a sharded plane"
            )
        w = ShardedWatch(self, kind, send_initial, resume)
        return w, [None] * w.initial_count()

    # -- writes -------------------------------------------------------------
    def _mint_uid(self, kind: str, obj: Any) -> None:
        """Give a uid-less object a uid before it is created (K > 1 only;
        the port's addition): each group mints from its own sequence, so
        two groups would hand out the same uids to different objects.
        The suffix is never all digits, so no store's recovery floors its
        own sequence on it."""
        if not obj.metadata.uid:
            obj.metadata.uid = f"{kind.lower()}-u{uuid.uuid4().hex}"

    def create(self, kind: str, obj: Any) -> Any:
        if self._single is None:
            self._mint_uid(kind, obj)
        return self._chase(
            lambda: self._store_for(kind, obj.metadata.namespace).create(
                kind, obj
            )
        )

    def update(
        self, kind: str, obj: Any, expected_rv: Optional[int] = None
    ) -> Any:
        return self._chase(
            lambda: self._store_for(kind, obj.metadata.namespace).update(
                kind, obj, expected_rv=expected_rv
            )
        )

    def delete(self, kind: str, namespace: str, name: str) -> None:
        return self._chase(
            lambda: self._store_for(kind, namespace).delete(
                kind, namespace, name
            )
        )

    def mutate(
        self,
        kind: str,
        namespace: str,
        name: str,
        fn: Any,
        max_conflict_retries: int = 16,
    ) -> Any:
        return self._chase(
            lambda: self._store_for(kind, namespace).mutate(
                kind, namespace, name, fn,
                max_conflict_retries=max_conflict_retries,
            )
        )

    def create_many(
        self, kind: str, objs: List[Any], return_objects: bool = True
    ) -> List[Any]:
        single = self._single
        if single is not None:
            return single.create_many(
                kind, objs, return_objects=return_objects
            )
        for obj in objs:
            self._mint_uid(kind, obj)
        results: List[Any] = [None] * len(objs)
        pending = list(range(len(objs)))
        for attempt in range(_CHASE_ATTEMPTS):
            by_gid: Dict[str, List[int]] = {}
            for i in pending:
                ns = self._effective_ns(kind, objs[i].metadata.namespace)
                by_gid.setdefault(self._owner_gid(ns), []).append(i)
            still: List[int] = []
            chased = False
            with self._mu:
                stores = dict(self._stores)
            for gid, idxs in by_gid.items():
                try:
                    sub = stores[gid].create_many(
                        kind, [objs[i] for i in idxs],
                        return_objects=return_objects,
                    )
                except WrongShard:
                    counters.inc("shard.wrong_shard_chased")
                    chased = True
                    still.extend(idxs)
                    continue
                for i, res in zip(idxs, sub):
                    results[i] = res
            if not still:
                return results
            pending = still
            if chased and attempt < _CHASE_ATTEMPTS - 1:
                self.refresh_topology()
        for i in pending:
            results[i] = WrongShard(
                f"create_many: no owning group accepted item {i} after "
                f"{_CHASE_ATTEMPTS} topology refreshes"
            )
        return results

    # -- two-shard bind commit ----------------------------------------------
    def bind_many_remote(
        self,
        bindings: List[Any],
        return_objects: bool = True,
        batch_id: Optional[str] = None,
    ) -> List[Any]:
        """A wave's bind batch across shards as a TWO-SHARD COMMIT.

        The batch splits deterministically by namespace owner and every
        sub-batch POSTs concurrently under ONE logical ``batch_id`` with
        each binding's ordinal in the LOGICAL batch pinned as its ack
        id.  The call returns only after EVERY group has answered — and
        a group's 200 is ack-after-durability (§25), so success means
        both sides are durable.

        Exactly-once across retries: each group's WAL-backed ack
        registry answers already-acked ordinals without
        re-executing, keyed ``{batch_id}/{ordinal}`` — stable even when
        a topology change re-partitions the sub-batches, because the
        ordinal is the LOGICAL batch position, not the sub-batch index.
        A group that fails outright leaves its items as typed per-item
        errors; the caller re-posts the SAME logical batch and the
        durable side replays from its registry while the failed side
        executes for the first time — never a double execution, never a
        half-acked batch reported as success."""
        single = self._single
        if single is not None:
            return single.bind_many_remote(
                bindings, return_objects=return_objects, batch_id=batch_id
            )
        logical = batch_id or uuid.uuid4().hex
        results: List[Any] = [None] * len(bindings)
        pending = list(range(len(bindings)))
        t0 = time.monotonic()
        crossed = False
        for attempt in range(_CHASE_ATTEMPTS):
            by_gid: Dict[str, List[int]] = {}
            for i in pending:
                ns = self._effective_ns(
                    "Pod", bindings[i].pod_namespace
                )
                by_gid.setdefault(self._owner_gid(ns), []).append(i)
            if attempt == 0 and len(by_gid) > 1:
                crossed = True
                counters.inc("shard.cross_bind_batches")
                counters.inc("shard.cross_bind_entries", len(bindings))
            with self._mu:
                stores = dict(self._stores)
            wrong: List[int] = []
            wrong_mu = threading.Lock()

            def dispatch(gid: str, idxs: List[int]) -> None:
                try:
                    sub = stores[gid].bind_many_remote(
                        [bindings[i] for i in idxs],
                        return_objects=return_objects,
                        batch_id=logical,
                        ack_ids=[str(i) for i in idxs],
                        # a re-dispatch after a chase may follow a lost
                        # first execution on the previous owner (whose
                        # bound pods the split seeded over): convert
                        # AlreadyBound-to-our-node to success like any
                        # retried attempt
                        assume_retry=attempt > 0,
                    )
                except WrongShard:
                    counters.inc("shard.wrong_shard_chased")
                    with wrong_mu:
                        wrong.extend(idxs)
                    return
                except BaseException as e:  # noqa: BLE001 — typed per item
                    for i in idxs:
                        results[i] = e
                    return
                for i, res in zip(idxs, sub):
                    results[i] = res

            threads = [
                threading.Thread(target=dispatch, args=(gid, idxs))
                for gid, idxs in by_gid.items()
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if not wrong:
                break
            pending = wrong
            if attempt < _CHASE_ATTEMPTS - 1:
                self.refresh_topology()
            else:
                for i in pending:
                    results[i] = WrongShard(
                        "bind: no owning group accepted after "
                        f"{_CHASE_ATTEMPTS} topology refreshes"
                    )
        if crossed:
            hist.observe("shard.crossbind_s", time.monotonic() - t0)
        return results

    def close(self) -> None:
        with self._mu:
            stores = list(self._stores.values())
        for rs in stores:
            rs.close()


class ShardedClient:
    """Client facade over a ShardedStore — what ``RemoteClient`` is to
    one ``RemoteStore``.  ``seeds`` may be any façade of any group
    (topology discovery finds the rest); kwargs pass to each group's
    RemoteStore."""

    def __init__(self, seeds: List[str], **kwargs: Any):
        self.store = ShardedStore(seeds=seeds, **kwargs)

    def nodes(self) -> Any:
        from minisched_tpu_torch.controlplane.remote import _RemoteNodeAPI

        return _RemoteNodeAPI(self.store)

    def pods(self, namespace: str = "default") -> Any:
        from minisched_tpu_torch.controlplane.remote import _RemotePodAPI

        return _RemotePodAPI(self.store, namespace)


# ---------------------------------------------------------------------------
# split coordinator
# ---------------------------------------------------------------------------


def _leader_of(endpoints: List[str], timeout_s: float = 10.0) -> str:
    """The writable façade of one group: probe ``/repl/status`` on each
    endpoint — 404 means unreplicated (that server IS the leader),
    otherwise the replica claiming the unfenced leader role."""
    last: Any = None
    for url in endpoints:
        try:
            status, doc = _raw_req(
                url, "GET", "/repl/status", timeout_s=timeout_s
            )
        except Exception as e:  # noqa: BLE001 — dead replica, probe on
            last = e
            continue
        if status == 404:
            return url
        if status == 200 and doc.get("role") == "leader" \
                and not doc.get("fenced"):
            return url
    raise RuntimeError(f"no leader among {endpoints}: {last}")


def _control_all(topology: ShardTopology, body: dict) -> None:
    """Push one ``/shards/control`` op to EVERY replica of every group
    (each façade guards writes off its own ShardInfo copy)."""
    errors = []
    for gid, eps in topology.groups.items():
        for url in eps:
            try:
                status, doc = _raw_req(
                    url, "POST", "/shards/control", body
                )
                if status != 200:
                    errors.append(f"{url}: HTTP {status}: {doc}")
            except Exception as e:  # noqa: BLE001 — collect, report below
                errors.append(f"{url}: {e}")
    # a dead replica is tolerated (it re-learns the topology when its
    # supervisor restarts it with the new doc, and until then its
    # fenced store refuses writes anyway); a LIVE refusal is not
    if any("HTTP 4" in e for e in errors):
        raise RuntimeError(f"shard control refused: {errors}")


def freeze_ttl_s(default: Optional[float] = None) -> float:
    """The freeze-lease TTL a split coordinator grants itself:
    ``MINISCHED_FREEZE_TTL_S`` else the module default."""
    if default is not None:
        return float(default)
    try:
        return float(
            os.environ.get(
                "MINISCHED_FREEZE_TTL_S", str(DEFAULT_FREEZE_TTL_S)
            )
        )
    except ValueError:
        return DEFAULT_FREEZE_TTL_S


def split_namespace(
    topology: ShardTopology,
    namespace: str,
    target_gid: str,
    timeout_s: float = 30.0,
    ttl_s: Optional[float] = None,
    _after_freeze: Optional[Callable[[str], None]] = None,
) -> dict:
    """Reassign ``namespace`` to ``target_gid`` via checkpoint-seed
    handoff (DESIGN.md §30/§31): freeze writes for ONLY this namespace
    on every façade under a TTL'd lease, ship its objects from the
    source leader as a §28-codec doc, seed the target leader through
    the normal durable path, RENEW the lease (the proof no replica
    thawed and admitted writes mid-handoff), flip the topology epoch
    everywhere, unfreeze, purge the shipped objects from the source.
    Returns ``{namespace, from, to, epoch, objects, freeze_s, handoff_s,
    seed_s}`` (the last two the port's); the freeze window is the doc's
    round trip, not a function of shard size.

    Crash safety (§31): every freeze carries ``lease_id`` +
    ``ttl_s`` — a coordinator that dies anywhere in this function
    strands NOTHING, because each replica auto-thaws its lease at
    expiry independently.  If the lease expired under a slow
    coordinator, the pre-flip renewal is refused (HTTP 400 →
    RuntimeError here) and the split aborts with ownership unchanged;
    the purge is keyed to the handoff manifest so a write admitted in
    any thaw gap is never deleted.  On failure before the topology
    flip, the namespace is unfrozen and ownership is UNCHANGED (a
    partially-seeded target holds orphaned copies the next attempt's
    seed skips as conflicts — harmless, the topology never pointed at
    them).

    ``_after_freeze`` is a test seam: called with the lease id right
    after the freeze fanout (chaos harnesses SIGKILL leaders or the
    coordinator itself inside this window)."""
    if target_gid not in topology.groups:
        raise ValueError(f"unknown target group {target_gid!r}")
    source_gid = topology.owner(namespace)
    if source_gid == target_gid:
        return {
            "namespace": namespace, "from": source_gid, "to": target_gid,
            "epoch": topology.epoch, "objects": 0, "freeze_s": 0.0,
        }
    lease_id = uuid.uuid4().hex
    ttl = freeze_ttl_s(ttl_s)
    t0 = time.monotonic()
    _control_all(
        topology,
        {
            "op": "freeze",
            "namespace": namespace,
            "lease_id": lease_id,
            "ttl_s": ttl,
        },
    )
    flipped = False
    try:
        if _after_freeze is not None:
            _after_freeze(lease_id)
        src = _leader_of(topology.groups[source_gid], timeout_s)
        dst = _leader_of(topology.groups[target_gid], timeout_s)
        t1 = time.monotonic()
        status, doc = _raw_req(
            src, "GET", f"/shards/handoff?namespace={namespace}",
            timeout_s=timeout_s,
        )
        if status != 200:
            raise RuntimeError(f"handoff: HTTP {status}: {doc}")
        t2 = time.monotonic()
        status, seeded = _raw_req(
            dst, "POST", "/shards/seed", doc, timeout_s=timeout_s
        )
        if status != 200:
            raise RuntimeError(f"seed: HTTP {status}: {seeded}")
        handoff_s, seed_s = t2 - t1, time.monotonic() - t2
        # the liveness gate: renewing on EVERY replica proves no lease
        # expired (and thus no writes were admitted on the source)
        # between the freeze and this instant — a refusal (HTTP 400)
        # raises out of _control_all and aborts the split pre-flip
        _control_all(
            topology,
            {
                "op": "freeze",
                "namespace": namespace,
                "lease_id": lease_id,
                "ttl_s": ttl,
                "renew": True,
            },
        )
        new_topo = topology.copy()
        new_topo.epoch += 1
        new_topo.overrides[namespace] = target_gid
        new_topo.frozen.discard(namespace)
        _control_all(
            topology,
            {
                "op": "topology",
                "topology": dict(
                    new_topo.as_dict(), unfrozen=[namespace]
                ),
            },
        )
        flipped = True
    finally:
        _control_all(
            topology,
            {
                "op": "unfreeze",
                "namespace": namespace,
                "lease_id": lease_id,
            },
        )
    freeze_s = time.monotonic() - t0
    hist.observe("shard.freeze_s", freeze_s)
    # purge AFTER the unfreeze: ownership already flipped, so the source
    # refuses new writes for the namespace regardless — the purge is
    # KEYED to the handoff manifest, clearing exactly the shipped
    # objects out of the source's snapshot and nothing else
    status, purged = _raw_req(
        src,
        "POST",
        "/shards/purge",
        {"namespace": namespace, "names": doc.get("names")},
        timeout_s=timeout_s,
    )
    if status != 200:
        raise RuntimeError(f"purge: HTTP {status}: {purged}")
    counters.inc("shard.splits")
    assert flipped
    topology.epoch = new_topo.epoch
    topology.overrides[namespace] = target_gid
    topology.frozen.discard(namespace)
    return {
        "namespace": namespace,
        "from": source_gid,
        "to": target_gid,
        "epoch": new_topo.epoch,
        "objects": int(
            sum(len(v) for v in (doc.get("objects") or {}).values())
        ),
        "freeze_s": freeze_s,
        # the port's: the handoff's and the seed's round trips, inside
        # the freeze
        "handoff_s": handoff_s,
        "seed_s": seed_s,
    }


# ---------------------------------------------------------------------------
# capacity mirror (DESIGN.md §31): home budget board + remote mirrors
# ---------------------------------------------------------------------------


def build_budget_doc(store: Any, shard: ShardInfo) -> dict:
    """The HOME group's per-Node budget document, served from
    ``GET /shards/budget``: allocatable + home-side usage per Node
    (straight off the store's incremental ``_pod_node_agg``), stamped
    with the serving replica's applied rv, plus every non-home group's
    last usage report (the board) so a mirror can reconstruct
    used-elsewhere for ITS vantage by excluding its own report."""
    nodes: Dict[str, dict] = {}
    agg = getattr(store, "_pod_node_agg", None) or {}
    lk = getattr(store, "locked", None)
    ctx = lk() if callable(lk) else _null_lock()
    with ctx:
        agg_snap = {n: list(v) for n, v in agg.items()}
        node_objs = list(store.list("Node"))
        rv = store.applied_rv()
    for node in node_objs:
        alloc = node.status.allocatable
        nodes[node.metadata.name] = {
            "alloc": [alloc.milli_cpu, alloc.memory, alloc.pods],
            "used": agg_snap.get(node.metadata.name, [0, 0, 0]),
        }
    board = shard.budget_board
    return {
        "group": shard.group_id,
        "rv": rv,
        "nodes": nodes,
        "reported": board.snapshot() if board is not None else {},
    }


class _null_lock:
    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> bool:
        return False


class BudgetBoard:
    """HOME-group side of the capacity mirror: the last usage report
    from every non-home group (``{gid: {"rv", "nodes": {name:
    [cpu, mem, pods]}}}``), folded in via the ``budget_report`` control
    op.  Reports are monotonic PER GROUP by the reporter's applied rv —
    a delayed duplicate can never roll a newer aggregate back."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._reports: Dict[str, dict] = {}

    def report(self, gid: str, nodes: Dict[str, Any], rv: int) -> None:
        clean = {
            str(n): [int(x) for x in (v or [0, 0, 0])[:3]]
            for n, v in (nodes or {}).items()
        }
        with self._mu:
            cur = self._reports.get(gid)
            if cur is not None and rv < cur["rv"]:
                return
            self._reports[gid] = {"rv": int(rv), "nodes": clean}
        counters.inc("shard.budget.reports")

    def extra_used(self, name: str) -> Optional[List[int]]:
        """Summed non-home usage of Node ``name`` across every group's
        last report, or None when no group reported it — what the home
        group's own bind path must debit ON TOP of its local agg."""
        total = [0, 0, 0]
        seen = False
        with self._mu:
            for rep in self._reports.values():
                u = rep["nodes"].get(name)
                if u is not None:
                    seen = True
                    for i in range(3):
                        total[i] += u[i]
        return total if seen else None

    def snapshot(self) -> Dict[str, dict]:
        with self._mu:
            return {
                gid: {"rv": r["rv"], "nodes": dict(r["nodes"])}
                for gid, r in self._reports.items()
            }


class BudgetMirror:
    """NON-home side of the capacity mirror: an rv-stamped read-only
    view of the home group's budget doc.  ``update`` is monotonic on
    the doc's rv (a stale fetch never rolls the view back); ``budget``
    answers with (allocatable, used-elsewhere, rv) where used-elsewhere
    excludes THIS group's own report — the local store's live
    ``_pod_node_agg`` covers that share exactly, under the very lock
    hold the bind commits under."""

    def __init__(self, own_gid: str) -> None:
        self._own = str(own_gid)
        self._mu = threading.Lock()
        self._rv = 0
        #: name → (alloc [cpu, mem, pods], used-elsewhere [cpu, mem, pods])
        self._budgets: Dict[str, Tuple[List[int], List[int]]] = {}

    def update(self, doc: dict) -> bool:
        rv = int(doc.get("rv") or 0)
        reported = doc.get("reported") or {}
        budgets: Dict[str, Tuple[List[int], List[int]]] = {}
        for name, ent in (doc.get("nodes") or {}).items():
            alloc = [int(x) for x in (ent.get("alloc") or [0, 0, 0])[:3]]
            used = [int(x) for x in (ent.get("used") or [0, 0, 0])[:3]]
            for gid, rep in reported.items():
                if gid == self._own:
                    continue
                u = (rep.get("nodes") or {}).get(name)
                if u is not None:
                    for i in range(3):
                        used[i] += int(u[i])
            budgets[str(name)] = (alloc, used)
        with self._mu:
            if rv < self._rv:
                return False
            self._rv = rv
            self._budgets = budgets
        counters.inc("shard.budget.mirror_syncs")
        return True

    def budget(
        self, name: str
    ) -> Optional[Tuple[List[int], List[int], int]]:
        with self._mu:
            ent = self._budgets.get(name)
            if ent is None:
                return None
            return list(ent[0]), list(ent[1]), self._rv

    @property
    def rv(self) -> int:
        with self._mu:
            return self._rv


class _ShardBudgetView:
    """The adapter the bind path's budget computation consults
    (``store._shard_budget_view``, read inside ``_node_budgets`` under
    the store lock): mirror budgets for Nodes this group's store does
    not hold, board extra-usage for Nodes it does."""

    def __init__(self, shard: ShardInfo) -> None:
        self._shard = shard

    def budget(
        self, name: str
    ) -> Optional[Tuple[List[int], List[int], int]]:
        m = self._shard.budget_mirror
        return None if m is None else m.budget(name)

    def extra_used(self, name: str) -> Optional[List[int]]:
        b = self._shard.budget_board
        return None if b is None else b.extra_used(name)


# ---------------------------------------------------------------------------
# per-façade shard runtime: lease journal wiring, budget sync, autosplit
# ---------------------------------------------------------------------------


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


class AutoSplitWatcher:
    """Per-group load watcher (DESIGN.md §31 leg 2): samples the
    group-commit barrier's saturation — a WINDOWED p99 of
    ``storage.group_wait_s`` (delta of the global histogram's bucket
    counts between samples, nearest-rank over the shared ladder) plus
    the live stage depth — and, after ``hot_samples`` consecutive hot
    reads with a post-split cooldown, splits this group's hottest
    namespace to the group the rendezvous hash picks among the OTHERS.
    No operator in the loop; every decision is countered
    (``shard.autosplit.*``) and the windowed p99 is observed as its own
    histogram so "did the split help" is answerable off a scrape."""

    def __init__(
        self,
        store: Any,
        shard: ShardInfo,
        p99_hot_s: Optional[float] = None,
        depth_hot: Optional[int] = None,
        hot_samples: Optional[int] = None,
        cooldown_s: Optional[float] = None,
        split: Callable[..., dict] = None,  # type: ignore[assignment]
    ) -> None:
        self._store = store
        self._shard = shard
        self.p99_hot_s = (
            _env_f("MINISCHED_AUTOSPLIT_P99_S", 0.05)
            if p99_hot_s is None else float(p99_hot_s)
        )
        self.depth_hot = (
            int(_env_f("MINISCHED_AUTOSPLIT_DEPTH", 64))
            if depth_hot is None else int(depth_hot)
        )
        self.hot_samples = (
            int(_env_f("MINISCHED_AUTOSPLIT_HOT", 3))
            if hot_samples is None else int(hot_samples)
        )
        self.cooldown_s = (
            _env_f("MINISCHED_AUTOSPLIT_COOLDOWN_S", 30.0)
            if cooldown_s is None else float(cooldown_s)
        )
        self._split = split if split is not None else split_namespace
        self._prev: Optional[Tuple[List[int], int]] = None
        self._streak = 0
        self._last_trigger: Optional[float] = None
        self._tally: Dict[str, int] = {}
        #: namespaces a split moved ONTO this group (an override naming
        #: it), with when this watcher first saw them here: not split
        #: away again within the cooldown (the port's; JAX's watcher on
        #: the target, seeing the moved load, splits it straight back)
        self._arrived: Dict[str, float] = {}

    def _window_p99(self) -> Optional[float]:
        """p99 over the observations that arrived SINCE the last sample:
        delta of the merged bucket counts (the cumulative histogram can
        never recover after a hot burst; the window can).  None when the
        window is empty; +inf when the rank lands in overflow."""
        counts, overflow, _s, _n = hist.GLOBAL.merged(
            "storage.group_wait_s"
        )
        prev = self._prev
        self._prev = (list(counts), overflow)
        if prev is None:
            return None
        d = [c - p for c, p in zip(counts, prev[0])]
        d_ovf = overflow - prev[1]
        n = sum(d) + d_ovf
        if n <= 0:
            return None
        rank = max(1, math.ceil(0.99 * n))
        cum = 0
        for i, c in enumerate(d):
            cum += c
            if cum >= rank:
                return hist.BUCKET_BOUNDS[i]
        return float("inf")

    def _candidate(self) -> Optional[str]:
        """The hottest namespace this group still OWNS (write tallies
        drained from the guard), excluding "" (cluster-scoped objects
        never move — the home group is the budget mirror's anchor) and
        anything currently frozen."""
        for ns, n in self._shard.drain_write_counts().items():
            self._tally[ns] = self._tally.get(ns, 0) + n
        topo = self._shard.topology
        if len(topo.groups) < 2:
            return None
        now = time.monotonic()
        for ns, gid in topo.overrides.items():
            if gid == self._shard.group_id:
                self._arrived.setdefault(ns, now)
        for ns, _n in sorted(self._tally.items(), key=lambda kv: -kv[1]):
            if not ns or ns in topo.frozen:
                continue
            if topo.owner(ns) != self._shard.group_id:
                continue
            arrived = self._arrived.get(ns)
            if arrived is not None and now - arrived < self.cooldown_s:
                continue
            return ns
        return None

    def sample(self) -> dict:
        """One watcher tick; returns the decision record (tests drive
        this synchronously, the runtime thread calls it on a timer)."""
        counters.inc("shard.autosplit.samples")
        p99 = self._window_p99()
        depth = len(getattr(self._store, "_gc_stage", ()) or ())
        if p99 is not None:
            hist.observe(
                "shard.autosplit.window_p99_s", min(p99, 3600.0)
            )
        hot = bool(
            (p99 is not None and p99 >= self.p99_hot_s)
            or depth >= self.depth_hot
        )
        out = {
            "p99_s": p99, "depth": depth, "hot": hot,
            "streak": self._streak, "split": None,
        }
        if not hot:
            self._streak = 0
            return out
        counters.inc("shard.autosplit.hot")
        self._streak += 1
        out["streak"] = self._streak
        if self._streak < self.hot_samples:
            return out
        now = time.monotonic()
        if (
            self._last_trigger is not None
            and now - self._last_trigger < self.cooldown_s
        ):
            counters.inc("shard.autosplit.skipped")
            return out
        if getattr(self._store, "_fenced", False):
            counters.inc("shard.autosplit.skipped")
            return out
        ns = self._candidate()
        if ns is None:
            counters.inc("shard.autosplit.skipped")
            return out
        topo = self._shard.topology.copy()
        target = shard_owner(
            ns, sorted(set(topo.groups) - {self._shard.group_id})
        )
        try:
            result = self._split(topo, ns, target)
        except Exception as e:  # noqa: BLE001 — next tick retries
            counters.inc("shard.autosplit.errors")
            out["split"] = {"namespace": ns, "error": str(e)}
            return out
        counters.inc("shard.autosplit.triggered")
        self._last_trigger = now
        self._streak = 0
        self._tally.pop(ns, None)
        out["split"] = result
        return out


def autosplit_enabled() -> bool:
    return os.environ.get("MINISCHED_AUTOSPLIT", "").strip().lower() in (
        "1", "true", "yes", "on",
    )


class ShardRuntime:
    """Everything a sharded façade runs BESIDES serving requests
    (DESIGN.md §31), owned per process and wired by
    :func:`attach_shard_runtime`:

    * freeze-lease durability — ``shard.journal`` points at the store's
      ``record_shard_lease`` (leader-only inside) and leases recovered
      from the WAL re-arm the guard at boot;
    * the capacity mirror — home group grows a :class:`BudgetBoard`,
      every other group a :class:`BudgetMirror` plus a sync loop that
      fetches ``/shards/budget`` from the home group and reports its
      own per-Node usage back (``budget_report`` control op); both
      sides expose :class:`_ShardBudgetView` on the store for the bind
      path;
    * autosplit — an optional :class:`AutoSplitWatcher` ticking on its
      own timer (``MINISCHED_AUTOSPLIT=1``)."""

    def __init__(
        self,
        store: Any,
        shard: ShardInfo,
        autosplit: Optional[AutoSplitWatcher] = None,
        sync_interval_s: Optional[float] = None,
        autosplit_interval_s: Optional[float] = None,
    ) -> None:
        self.store = store
        self.shard = shard
        self.autosplit = autosplit
        self.sync_interval_s = (
            _env_f("MINISCHED_BUDGET_SYNC_S", 0.25)
            if sync_interval_s is None else float(sync_interval_s)
        )
        self.autosplit_interval_s = (
            _env_f("MINISCHED_AUTOSPLIT_INTERVAL_S", 1.0)
            if autosplit_interval_s is None
            else float(autosplit_interval_s)
        )
        self.is_home = shard.topology.owner("") == shard.group_id
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        journal = getattr(store, "record_shard_lease", None)
        if callable(journal):
            shard.journal = journal
        recovered = getattr(store, "recovered_shard_leases", None)
        if callable(recovered):
            shard.adopt_leases(recovered())
        if self.is_home:
            shard.budget_board = BudgetBoard()
        else:
            shard.budget_mirror = BudgetMirror(shard.group_id)
        store._shard_budget_view = _ShardBudgetView(shard)

    def _home_urls(self) -> List[str]:
        topo = self.shard.topology
        return list(topo.groups.get(topo.owner(""), []))

    def sync_once(self) -> bool:
        """One budget round trip (non-home only): refresh the mirror
        from any home replica that answers, then report this group's
        own per-Node usage to EVERY home replica (each board copy folds
        it — whichever serves the next budget doc has it).  Only a
        non-fenced replica reports: a fenced store's agg is a stale
        ghost of the partition it lost."""
        if self.is_home:
            return False
        mirror = self.shard.budget_mirror
        updated = False
        for url in self._home_urls():
            try:
                status, doc = _raw_req(url, "GET", "/shards/budget")
            except Exception:  # noqa: BLE001 — probe the next replica
                continue
            if status == 200 and isinstance(doc, dict) and doc.get("nodes") \
                    is not None:
                if mirror is not None:
                    updated = mirror.update(doc)
                break
        if not getattr(self.store, "_fenced", False):
            agg = getattr(self.store, "_pod_node_agg", None) or {}
            lk = getattr(self.store, "locked", None)
            ctx = lk() if callable(lk) else _null_lock()
            with ctx:
                nodes = {n: list(v) for n, v in agg.items()}
                rv = self.store.applied_rv()
            body = {
                "op": "budget_report",
                "group": self.shard.group_id,
                "rv": rv,
                "nodes": nodes,
            }
            for url in self._home_urls():
                try:
                    _raw_req(url, "POST", "/shards/control", body)
                except Exception:  # noqa: BLE001 — next round resends
                    pass
        return updated

    def _sync_loop(self) -> None:
        while not self._stop.wait(self.sync_interval_s):
            try:
                self.sync_once()
            except Exception:  # noqa: BLE001 — loop must not die
                pass

    def _autosplit_loop(self) -> None:
        while not self._stop.wait(self.autosplit_interval_s):
            try:
                self.autosplit.sample()
            except Exception:  # noqa: BLE001 — loop must not die
                pass

    def start(self) -> "ShardRuntime":
        if not self.is_home:
            t = threading.Thread(
                target=self._sync_loop,
                name="shard-budget-sync",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        if self.autosplit is not None:
            t = threading.Thread(
                target=self._autosplit_loop,
                name="shard-autosplit",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)


def attach_shard_runtime(
    store: Any, shard: Optional[ShardInfo]
) -> Optional[ShardRuntime]:
    """Wire a façade's shard runtime onto its store (called from
    ``start_api_server`` for sharded servers; None passthrough keeps
    the unsharded plane byte-identical)."""
    if shard is None:
        return None
    watcher = AutoSplitWatcher(store, shard) if autosplit_enabled() else None
    return ShardRuntime(store, shard, autosplit=watcher).start()


# ---------------------------------------------------------------------------
# process-level harness
# ---------------------------------------------------------------------------


class ShardedPlane:
    """K leader groups of N replica children each — the harness `make
    chaos-shard` and the bench ``shard`` role drive.  Each group is one
    full :class:`replproc.ReplicatedPlane` (own WAL dir, own arbiter,
    own election); the shard topology is computed up front from the
    supervisors' pre-allocated ports and threaded to every child."""

    def __init__(
        self,
        wal_dir: str,
        k: Optional[int] = None,
        replicas_per_group: int = 3,
        fsync: bool = False,
        ack_timeout_s: float = 10.0,
        ttl_s: Optional[float] = None,
        compact_every_s: float = 0.0,
    ):
        from minisched_tpu_torch.controlplane.replproc import (
            DEFAULT_TTL_S,
            ReplicatedPlane,
        )

        self.k = k if k is not None else shard_count()
        self.ttl_s = DEFAULT_TTL_S if ttl_s is None else ttl_s
        os.makedirs(wal_dir, exist_ok=True)
        self.groups: Dict[str, ReplicatedPlane] = {}
        for i in range(self.k):
            gid = f"g{i}"
            self.groups[gid] = ReplicatedPlane(
                os.path.join(wal_dir, gid),
                n=replicas_per_group,
                fsync=fsync,
                ack_timeout_s=ack_timeout_s,
                ttl_s=self.ttl_s,
                compact_every_s=compact_every_s,
                replica_prefix=f"{gid}r",
            )
        self.topology = ShardTopology(
            {
                gid: [r.base_url for r in plane.replicas]
                for gid, plane in self.groups.items()
            },
            epoch=1,
        )
        topo_doc = self.topology.as_dict()
        for gid, plane in self.groups.items():
            for r in plane.replicas:
                r.shard = {"group_id": gid, "topology": topo_doc}

    def start(self) -> List[str]:
        """Boot every group (its own r0 bootstraps); returns the seed
        urls (one leader per group)."""
        return [plane.start() for plane in self.groups.values()]

    def client(self, **kwargs: Any) -> ShardedStore:
        return ShardedStore(topology=self.topology.copy(), **kwargs)

    def leader(self, gid: str) -> Any:
        return self.groups[gid].leader()

    def wait_for_leader(
        self, gid: str, timeout_s: float = 30.0, exclude: str = ""
    ) -> dict:
        return self.groups[gid].wait_for_leader(
            timeout_s=timeout_s, exclude=exclude
        )

    def split(self, namespace: str, target_gid: str) -> dict:
        """Drive the split procedure against the live plane and fold the
        new epoch into this harness's own topology record."""
        return split_namespace(self.topology, namespace, target_gid)

    def statuses(self) -> Dict[str, dict]:
        return {
            gid: plane.statuses() for gid, plane in self.groups.items()
        }

    def stop(self) -> None:
        for plane in self.groups.values():
            plane.stop()
