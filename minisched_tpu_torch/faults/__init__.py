"""Seedable, deterministic fault-injection fabric.

A copy of ``minisched_tpu/faults/__init__.py``.  Components take an
optional ``FaultFabric`` and consult it at *named injection points*;
an unconfigured point costs one attribute read.

Named points the port wires (grep for the literal string):

    store.get / store.list / store.create / store.update / store.delete
        — ObjectStore API calls raise InjectedFault (a flaky apiserver /
          etcd), through ``ObjectStore.fault_injector =
          fabric.as_store_injector()``
    wal.append
        — DurableObjectStore refuses the mutation before touching memory
    disk.enospc
        — the WAL append itself fails with OSError(ENOSPC): the store
          latches DEGRADED read-only (typed store.StorageDegraded, HTTP
          507 on the wire) until its recovery probe re-arms writes
    wal.bitflip
        — the append SUCCEEDS but one payload bit flips after the CRC
          was computed (the lying disk); replay and fsck must DETECT it
    wal.torn_mid
        — only a prefix of the frame reaches the file and later appends
          bury it: a mid-file torn write replay must locate
    ckpt.corrupt
        — one byte of a freshly written checkpoint flips post-rename;
          the sha256 sidecar convicts it and restore takes the fallback
          chain
    repl.ship
        — the leader's replication stream server drops a follower's
          connection mid-ship with no goodbye; the follower reconnects
          and resumes from its own WAL offset; key = replica id
    repl.ack
        — the leader's /repl/ack handler answers 503 and DISCARDS the
          follower's durability ack; the follower's next group or
          heartbeat re-ack heals it; key = replica id
    net.drop
        — an outbound replication-plane call (arbiter lease CAS,
          follower stream/status/ack) is refused before it touches the
          socket: the scheduled flaky-link half of ``faults/net.py``,
          keyed "src>dst"

Determinism: whether call *n* at (point, key) fires is a pure function
of ``(seed, point, key, n)`` (a blake2s hash, not a shared RNG), so the
schedule reproduces byte for byte for a fixed seed whatever the thread
interleaving, and equals the JAX fabric's for the same seed and calls.

``wal_double_binds`` (JAX ``:192``), the full-history double-bind audit,
lives here as in JAX; ``controlplane.fsck`` imports it.

``remote.request`` (``RemoteStore(faults=)``: each attempt raises
InjectedFault before it leaves the process, retried like a reset
connection; key = the request path) is wired since the sharded plane's
tests race binds under it.

Left out, for the rest of ROADMAP item 8: ``faults/proc.py`` (the
killable control-plane child), and the ``http.500``, ``http.reset``,
``watch.drop`` and ``engine.bind`` points.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from hashlib import blake2s
from typing import Dict, FrozenSet, Optional, Tuple

from minisched_tpu_torch.controlplane.walio import iter_wal_records_lenient


class InjectedFault(RuntimeError):
    """An error manufactured by the fabric (never raised by real code)."""


@dataclass
class FaultRule:
    """Per-point firing policy.

    ``rate``: probability each eligible call fires.  ``after``: skip the
    first N calls at the point (let a scenario boot cleanly).
    ``max_fires``: stop injecting after this many fires (bounds the worst
    case so a soak always converges).  ``keys``: restrict to these call
    keys (e.g. only the Pod/Node watch streams).
    """

    rate: float
    after: int = 0
    max_fires: Optional[int] = None
    keys: Optional[FrozenSet[str]] = None


class FaultFabric:
    def __init__(self, seed: int):
        self._seed = int(seed)
        self._rules: Dict[str, FaultRule] = {}
        self._mu = threading.Lock()
        self._calls: Dict[Tuple[str, str], int] = {}
        self._fires: Dict[str, int] = {}

    @property
    def seed(self) -> int:
        return self._seed

    def on(self, point: str, rate: float, after: int = 0,
           max_fires: Optional[int] = None, keys=None) -> "FaultFabric":
        """Arm a point (chainable)."""
        self._rules[point] = FaultRule(
            rate=float(rate), after=after, max_fires=max_fires,
            keys=frozenset(keys) if keys is not None else None)
        return self

    def _decision(self, point: str, key: str, n: int) -> float:
        h = blake2s(f"{self._seed}:{point}:{key}:{n}".encode(),
                    digest_size=4).digest()
        return int.from_bytes(h, "big") / 2**32

    def should_fire(self, point: str, key: str = "") -> bool:
        """True when this call at (point, key) is scheduled to fail.
        Counts the call either way — the decision depends on the per-key
        call ordinal, which is what makes the schedule deterministic."""
        rule = self._rules.get(point)
        if rule is None:
            return False
        with self._mu:
            n = self._calls.get((point, key), 0)
            self._calls[(point, key)] = n + 1
            if rule.keys is not None and key not in rule.keys:
                return False
            if n < rule.after:
                return False
            if (rule.max_fires is not None
                    and self._fires.get(point, 0) >= rule.max_fires):
                return False
            fire = self._decision(point, key, n) < rule.rate
            if fire:
                self._fires[point] = self._fires.get(point, 0) + 1
            return fire

    def check(self, point: str, key: str = "") -> None:
        """Raise InjectedFault when the schedule says this call fails."""
        if self.should_fire(point, key):
            raise InjectedFault(f"injected fault at {point} ({key})")

    def fires(self, point: str) -> int:
        with self._mu:
            return self._fires.get(point, 0)

    def stats(self) -> Dict[str, Dict[str, int]]:
        """{'fires': per-point fire counts, 'calls': per-point call counts}
        — the chaos soak's injection evidence."""
        with self._mu:
            calls: Dict[str, int] = {}
            for (point, _key), n in self._calls.items():
                calls[point] = calls.get(point, 0) + n
            return {"fires": dict(self._fires), "calls": calls}

    def as_store_injector(self):
        """Adapter for ``ObjectStore.fault_injector`` (op, kind, key):
        routes mutations and reads to the ``store.{op}`` points."""

        def injector(op: str, kind: str, key: str) -> None:
            self.check(f"store.{op}", f"{kind}/{key}")

        return injector


def wal_double_binds(wal_path: str):
    """Audit a DurableObjectStore WAL's FULL history for double binds:
    returns [(uid, first_node, other_node), ...] for every pod that ever
    appeared bound to two different nodes.  The archived segments
    (``<path>.history``, then a ``.pending-archive`` a crash left) are
    read first, in append order, so compaction never shrinks the
    evidence.  Records ride the frame reader in LENIENT mode: torn tails
    drop silently and a corrupt region is skipped by magic resync — an
    audit wants every record it can still prove intact, while REPLAY of
    the same bytes hard-fails (fsck reports the divergence)."""
    bound_to: dict = {}
    violations = []
    paths = [
        p
        for p in (
            wal_path + ".history",
            wal_path + ".pending-archive",  # claimed by a compaction a
            wal_path,                       # crash interrupted mid-copy
        )
        if os.path.exists(p)
    ]
    for path in paths:
        for rec in iter_wal_records_lenient(path):
            if rec.get("op") != "put" or rec.get("kind") != "Pod":
                continue
            obj = rec["obj"]
            node = (obj.get("spec") or {}).get("node_name")
            uid = (obj.get("metadata") or {}).get("uid")
            if not node:
                continue
            prev = bound_to.setdefault(uid, node)
            if prev != node:
                violations.append((uid, prev, node))
    return violations
