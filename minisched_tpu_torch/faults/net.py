"""Deterministic network-fault layer: partitions as data (DESIGN.md §28).

A copy of ``minisched_tpu/faults/net.py``.  The process nemeses (SIGKILL,
bit-flips, ENOSPC) kill *machines*; this module kills *links*.  Every
replication-plane client call — a follower's stream/status/ack traffic,
the coordinator's arbiter lease CAS — consults :data:`GLOBAL_NET` before
touching the socket, keyed on the (src, dst) replica-id pair and a
channel:

    ``arbiter``  — lease acquire/renew/read traffic (the failure
                   detector's input)
    ``data``     — /repl/* stream, status, ack, checkpoint fetch

A link rule is either IMPOSED (``cut()`` / the façade's
``/net/partition`` control surface — how a test partitions replica
children from outside) or SCHEDULED through an embedded
:class:`~minisched_tpu_torch.faults.FaultFabric` at the ``net.drop``
point (key ``"src>dst"``), so flaky-link chaos reproduces byte for byte
from a seed, call for call with JAX's.  Modes:

    ``drop``       — fail immediately (connection refused)
    ``blackhole``  — hang for the caller's timeout (capped at
                     ``BLACKHOLE_CAP_S``), then fail
    ``delay``      — sleep ``delay_s`` then let the call through

Rules are DIRECTIONAL: ``cut("r0", "r1")`` severs r0→r1 only; each
process enforces only its own outbound edges, like a firewall.  Failures
surface as :class:`NetPartitioned`, an ``OSError`` subclass, so every
retry/degrade path treats a partitioned link exactly like a dead peer.

Counters: ``net.partition.dropped`` / ``blackholed`` / ``delayed`` per
enforced verdict, ``cuts`` / ``heals`` per rule change, gauge
``net.partition.links`` = live imposed rules.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from minisched_tpu_torch.faults import FaultFabric
from minisched_tpu_torch.observability import counters

#: longest a blackholed call may hang when the caller gave no timeout —
#: bounds the worst case so an un-timeouted code path cannot wedge a soak
BLACKHOLE_CAP_S = 5.0

_MODES = ("drop", "blackhole", "delay")
_CHANNELS = ("*", "arbiter", "data")


class NetPartitioned(OSError):
    """A call refused/failed by the network-fault layer (never raised by
    real networking).  Subclasses OSError on purpose: partition handling
    must ride the SAME retry/fence/degrade paths as real link death."""


class NetFabric:
    """One process's outbound network-fault table.

    ``identity`` is this process's replica id (the implicit ``src`` of
    every outbound check); replica children set it at boot, the test
    process sets it per in-process actor by passing ``src=`` explicitly.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.identity: str = ""
        # (src, dst) -> {"mode", "channel", "delay_s"}
        self._links: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._fabric: Optional[FaultFabric] = None
        self._enforced: Dict[str, int] = {}

    # -- configuration ----------------------------------------------------
    def configure(
        self,
        identity: str = "",
        seed: int = 0,
        rules: Optional[List[dict]] = None,
    ) -> "NetFabric":
        """Boot-time setup (replica children): set identity, arm the
        blake2s-scheduled ``net.drop`` point when a seed is given, and
        install any pre-imposed link rules."""
        with self._mu:
            if identity:
                self.identity = str(identity)
            if seed:
                self._fabric = FaultFabric(int(seed)).on("net.drop", rate=1.0)
        for rule in rules or []:
            self.cut(**rule)
        return self

    def flake(self, rate: float, seed: int, **kw: Any) -> "NetFabric":
        """Arm scheduled link drops: each outbound call fires per the
        deterministic (seed, "net.drop", "src>dst", n) schedule."""
        with self._mu:
            self._fabric = FaultFabric(int(seed)).on(
                "net.drop", rate=rate, **kw
            )
        return self

    def cut(
        self,
        src: str,
        dst: str,
        mode: str = "drop",
        channel: str = "*",
        delay_s: float = 0.0,
    ) -> None:
        """Impose a directional link rule (src may be "*": any local
        actor; dst may be "*": every peer)."""
        if mode not in _MODES:
            raise ValueError(f"unknown partition mode {mode!r}")
        if channel not in _CHANNELS:
            raise ValueError(f"unknown partition channel {channel!r}")
        with self._mu:
            self._links[(str(src), str(dst))] = {
                "mode": mode,
                "channel": channel,
                "delay_s": float(delay_s),
            }
            counters.inc("net.partition.cuts")
            counters.set_gauge("net.partition.links", len(self._links))

    def heal(self, src: str, dst: str) -> bool:
        with self._mu:
            gone = self._links.pop((str(src), str(dst)), None)
            if gone is not None:
                counters.inc("net.partition.heals")
            counters.set_gauge("net.partition.links", len(self._links))
            return gone is not None

    def heal_all(self) -> int:
        with self._mu:
            n = len(self._links)
            self._links.clear()
            if n:
                counters.inc("net.partition.heals", n)
            counters.set_gauge("net.partition.links", 0)
            return n

    # -- enforcement ------------------------------------------------------
    def _match(
        self, src: str, dst: str, channel: str
    ) -> Optional[Dict[str, Any]]:
        for key in ((src, dst), (src, "*"), ("*", dst), ("*", "*")):
            rule = self._links.get(key)
            if rule is not None and rule["channel"] in ("*", channel):
                return rule
        return None

    def check(
        self,
        dst: str,
        channel: str = "data",
        src: str = "",
        timeout_s: Optional[float] = None,
    ) -> None:
        """Gate one outbound call from ``src`` (default: our identity)
        to ``dst`` on ``channel``.  Raises :class:`NetPartitioned` when
        the link is cut; sleeps first for blackhole/delay modes."""
        src = src or self.identity
        with self._mu:
            rule = self._match(src, dst, channel)
            fabric = self._fabric
        if rule is None:
            if fabric is not None and fabric.should_fire(
                "net.drop", f"{src}>{dst}"
            ):
                self._count("dropped")
                raise NetPartitioned(
                    f"net.drop scheduled: {src} -> {dst} ({channel})"
                )
            return
        mode = rule["mode"]
        if mode == "drop":
            self._count("dropped")
            raise NetPartitioned(
                f"link cut: {src} -> {dst} ({channel})"
            )
        if mode == "blackhole":
            hang = min(
                timeout_s if timeout_s is not None else BLACKHOLE_CAP_S,
                BLACKHOLE_CAP_S,
            )
            time.sleep(max(0.0, hang))
            self._count("blackholed")
            raise NetPartitioned(
                f"link blackholed {hang:.1f}s: {src} -> {dst} ({channel})"
            )
        # delay: impose the latency, then let the call proceed
        time.sleep(max(0.0, float(rule["delay_s"])))
        self._count("delayed")

    def _count(self, verdict: str) -> None:
        counters.inc(f"net.partition.{verdict}")
        with self._mu:
            self._enforced[verdict] = self._enforced.get(verdict, 0) + 1

    # -- control surface (httpserver /net/partition) ----------------------
    def describe(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "identity": self.identity,
                "links": [
                    {"src": s, "dst": d, **rule}
                    for (s, d), rule in sorted(self._links.items())
                ],
                "enforced": dict(self._enforced),
            }

    def control(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Apply one control op: {"op": "cut"|"heal"|"heal_all", ...} —
        the wire form the chaos soak POSTs at replica children."""
        op = body.get("op")
        if op == "cut":
            self.cut(
                body["src"],
                body["dst"],
                mode=body.get("mode", "drop"),
                channel=body.get("channel", "*"),
                delay_s=float(body.get("delay_s", 0.0)),
            )
        elif op == "heal":
            self.heal(body["src"], body["dst"])
        elif op == "heal_all":
            self.heal_all()
        else:
            raise ValueError(f"unknown net control op {op!r}")
        return self.describe()


#: the process-wide instance every outbound replication-plane call
#: consults; replica children configure identity at boot, tests drive it
#: directly (in-process) or over POST /net/partition (child processes)
GLOBAL_NET = NetFabric()
