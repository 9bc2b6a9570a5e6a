"""Process-level replicated plane: N killable store replicas (DESIGN.md
§27).

A copy of ``minisched_tpu/controlplane/replproc.py``.  Each replica
child hosts two façades on fixed ports:

* the DATA plane — the replicated ``DurableObjectStore`` behind
  ``start_api_server(repl=ReplRuntime)``, serving clients and the
  ``/repl/*`` replication surface;
* the ARBITER plane — a tiny in-memory ``ObjectStore`` whose only job is
  lease CAS for leader election.  In memory on purpose twice over:
  coordination traffic must never advance the replicated data rv, and an
  arbiter dying WITH its process gives the lease exactly the TTL
  semantics election needs.

:class:`ReplicatedPlane` spawns the fleet, discovers the current leader
by polling ``/repl/status``, and SIGKILLs any replica;
``ReplicaSupervisor.restart`` brings one back as a follower on the same
ports over the same WAL.

``shard={"group_id", "topology"}`` (JAX ``:56-140``) makes a replica a
member of one leader group of a sharded write plane
(``shards.ShardedPlane``): its data façade gets ``shards.ShardInfo``.
``SplitCoordinator`` (JAX ``:384-517``) runs one ``split_namespace`` in
a child of its own, so a test can SIGKILL the coordinator inside the
freeze and watch every replica's lease thaw at its TTL.

The children import the control plane only (store, façade, replication,
shards, faults), never torch: they never resolve a device, and they are
started with ``CUDA_VISIBLE_DEVICES`` empty, so replicas never open
contexts on the card beside the engine's.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional

#: default election lease TTL for the harness (JAX ``replproc.py:41``;
#: a soak's promotion deadline is a small multiple of it)
DEFAULT_TTL_S = 2.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _replica_child_main(
    replica_id: str,
    wal_path: str,
    data_port: int,
    arbiter_port: int,
    peers: List[dict],
    bootstrap_leader: str = "",
    fsync: bool = False,
    ack_timeout_s: float = 10.0,
    ttl_s: float = DEFAULT_TTL_S,
    parent_pid: Optional[int] = None,
    compact_every_s: float = 0.0,
    shard: Optional[dict] = None,
) -> None:
    """One replica's whole life: recover the store from its own WAL,
    serve data + arbiter façades on fixed ports, join the plane (lead
    if bootstrapped, else tail/elect), park until SIGKILL.  Runs in a
    fresh interpreter — import inside, keep it light.

    ``compact_every_s`` > 0 runs a background compaction loop that
    fires only while THIS replica leads with a hub attached — the
    checkpoint-shipping half of DESIGN.md §28.

    ``shard`` (``{"group_id": gid, "topology": ShardTopology.as_dict()}``)
    makes this replica a member of one leader group of a sharded plane:
    the façade grows ``/shards/*`` and refuses writes for namespaces the
    topology gives other groups.  None is the unsharded plane."""
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore
    from minisched_tpu_torch.controlplane.httpserver import start_api_server
    from minisched_tpu_torch.controlplane.repl import (
        PeerSpec,
        ReplRuntime,
        repl_enabled,
    )
    from minisched_tpu_torch.controlplane.store import ObjectStore
    from minisched_tpu_torch.faults.net import GLOBAL_NET

    # every outbound replication call this process makes is keyed off
    # this identity in the partition layer (the /net/partition control
    # surface cuts/heals links by (src, dst) pair)
    GLOBAL_NET.configure(identity=replica_id)
    # salvage="covered": a replica restarting after SIGKILL may carry a
    # torn tail; replay truncates it and the follower re-tails the gap
    store = DurableObjectStore(wal_path, fsync=fsync, salvage="covered")
    runtime = None
    if repl_enabled():
        runtime = ReplRuntime(
            store,
            replica_id,
            peers=[PeerSpec(**p) for p in peers],
            ack_timeout_s=ack_timeout_s,
            ttl_s=ttl_s,
        )
    shard_info = None
    if shard:
        from minisched_tpu_torch.controlplane.shards import ShardInfo

        shard_info = ShardInfo(shard["group_id"], shard["topology"])
    start_api_server(ObjectStore(), port=arbiter_port)
    start_api_server(store, port=data_port, repl=runtime, shard=shard_info)
    if runtime is not None:
        runtime.start(bootstrap_leader or None)
    if compact_every_s and compact_every_s > 0:
        rt = runtime

        def compactor() -> None:
            while True:
                time.sleep(compact_every_s)
                try:
                    if rt is not None and rt.role == "leader" \
                            and rt.hub is not None:
                        store.compact()
                except Exception:  # noqa: BLE001 — housekeeping only;
                    pass  # a failed compaction leaves the old chain arm

        threading.Thread(target=compactor, daemon=True).start()
    if parent_pid:
        # orphan watchdog: an aborted run must not strand listeners on
        # the fixed ports
        def watchdog() -> None:
            while os.getppid() == parent_pid:
                time.sleep(0.5)
            os.kill(os.getpid(), signal.SIGKILL)

        threading.Thread(target=watchdog, daemon=True).start()
    threading.Event().wait()  # until SIGKILL — no orderly shutdown, ever


_CHILD_CMD = (
    "import json, sys; "
    "from minisched_tpu_torch.controlplane.replproc import "
    "_replica_child_main; "
    "_replica_child_main(**json.loads(sys.argv[1]))"
)


class ReplicaSupervisor:
    """One killable replica child with FIXED data+arbiter ports across
    restarts (clients and peers need no re-discovery)."""

    def __init__(
        self,
        replica_id: str,
        wal_path: str,
        data_port: int = 0,
        arbiter_port: int = 0,
        fsync: bool = False,
        ack_timeout_s: float = 10.0,
        ttl_s: float = DEFAULT_TTL_S,
        boot_timeout_s: float = 30.0,
        compact_every_s: float = 0.0,
        shard: Optional[dict] = None,
    ):
        self.replica_id = replica_id
        self.wal_path = wal_path
        self.data_port = data_port or _free_port()
        self.arbiter_port = arbiter_port or _free_port()
        self._fsync = fsync
        self._ack_timeout_s = ack_timeout_s
        self._ttl_s = ttl_s
        self._boot_timeout_s = boot_timeout_s
        self._compact_every_s = compact_every_s
        #: the child's shard membership ({"group_id", "topology"}), passed
        #: through verbatim; None = an unsharded replica
        self.shard = shard
        self._proc: Any = None
        self._peers: List[dict] = []
        self.kills = 0

    @property
    def base_url(self) -> str:
        return f"http://127.0.0.1:{self.data_port}"

    @property
    def arbiter_url(self) -> str:
        return f"http://127.0.0.1:{self.arbiter_port}"

    def spec(self) -> dict:
        from minisched_tpu_torch.controlplane.repl import PeerSpec

        return PeerSpec(
            self.replica_id, self.base_url, self.arbiter_url
        ).as_dict()

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def start(self, peers: List[dict], bootstrap_leader: str = "") -> str:
        """Spawn the child and block until its DATA façade answers
        /healthz.  ``bootstrap_leader`` is only honored on the very
        first generation — a restarted replica rejoins as a follower
        and lets the coordinator discover (or re-win) leadership."""
        if self.alive():
            raise RuntimeError(f"replica {self.replica_id} already running")
        self._peers = peers
        cfg = {
            "replica_id": self.replica_id,
            "wal_path": self.wal_path,
            "data_port": self.data_port,
            "arbiter_port": self.arbiter_port,
            "peers": peers,
            "bootstrap_leader": bootstrap_leader,
            "fsync": self._fsync,
            "ack_timeout_s": self._ack_timeout_s,
            "ttl_s": self._ttl_s,
            "parent_pid": os.getpid(),
            "compact_every_s": self._compact_every_s,
            "shard": self.shard,
        }
        env = dict(os.environ)
        repo_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        # a replica is host code: no CUDA context on the card, ever
        env["CUDA_VISIBLE_DEVICES"] = ""
        self._proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD_CMD, json.dumps(cfg)],
            env=env,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        deadline = time.monotonic() + self._boot_timeout_s
        url = self.base_url + "/healthz"
        while time.monotonic() < deadline:
            if self._proc.poll() is not None:
                raise RuntimeError(
                    f"replica {self.replica_id} died at boot "
                    f"(exitcode {self._proc.returncode})"
                )
            try:
                with urllib.request.urlopen(url, timeout=1.0) as r:
                    if r.status == 200:
                        return self.base_url
            except OSError:
                pass
            time.sleep(0.05)
        raise RuntimeError(
            f"replica {self.replica_id} failed /healthz within "
            f"{self._boot_timeout_s}s"
        )

    def kill(self) -> None:
        """SIGKILL — no flush, no lease release, no goodbye.  The lease
        simply stops being renewed; expiry IS the failure detector."""
        if self._proc is None:
            return
        if self._proc.poll() is None:
            self._proc.kill()
            self.kills += 1
        try:
            self._proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            pass
        self._proc = None

    def restart(self) -> str:
        return self.start(self._peers)  # never re-bootstrap

    def status(self, timeout: float = 1.0) -> Optional[dict]:
        try:
            with urllib.request.urlopen(
                self.base_url + "/repl/status", timeout=timeout
            ) as r:
                return json.loads(r.read())
        except OSError:
            return None

    def net_control(self, body: dict, timeout: float = 5.0) -> dict:
        """Drive this child's network-fault layer (faults/net.py) over
        its /net/partition control surface — how a partition test cuts
        and heals a replica's OUTBOUND links from outside the process.
        Symmetric partitions need the op on both sides."""
        req = urllib.request.Request(
            self.base_url + "/net/partition",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())


class ReplicatedPlane:
    """N replica children forming one control plane."""

    def __init__(
        self,
        wal_dir: str,
        n: int = 3,
        fsync: bool = False,
        ack_timeout_s: float = 10.0,
        ttl_s: float = DEFAULT_TTL_S,
        compact_every_s: float = 0.0,
        shard: Optional[dict] = None,
        replica_prefix: str = "r",
    ):
        self.ttl_s = ttl_s
        os.makedirs(wal_dir, exist_ok=True)
        # replica ids must be unique across a multi-group plane (the
        # partition layer and the hub key channels on them), so a sharded
        # harness prefixes them per group ("g0r0")
        self.replica_prefix = replica_prefix
        self.replicas: List[ReplicaSupervisor] = [
            ReplicaSupervisor(
                f"{replica_prefix}{i}",
                os.path.join(wal_dir, f"{replica_prefix}{i}.wal"),
                fsync=fsync,
                ack_timeout_s=ack_timeout_s,
                ttl_s=ttl_s,
                compact_every_s=compact_every_s,
                shard=shard,
            )
            for i in range(n)
        ]

    def __getitem__(self, i: int) -> ReplicaSupervisor:
        return self.replicas[i]

    def start(self) -> str:
        """Boot every replica (r0 bootstraps as leader) and return the
        leader's base_url."""
        peers = [r.spec() for r in self.replicas]
        boot = self.replicas[0].replica_id
        for r in self.replicas:
            r.start(peers, bootstrap_leader=boot)
        return self.wait_for_leader()["url"]

    def statuses(self) -> Dict[str, dict]:
        out = {}
        for r in self.replicas:
            s = r.status()
            if s is not None:
                out[r.replica_id] = s
        return out

    def leader(self) -> Optional[ReplicaSupervisor]:
        """The replica currently claiming the leader role (alive +
        unfenced).  None while the plane is between leaders."""
        for r in self.replicas:
            s = r.status()
            if s is not None and s.get("role") == "leader" \
                    and not s.get("fenced"):
                return r
        return None

    def wait_for_leader(
        self, timeout_s: float = 30.0, exclude: str = ""
    ) -> dict:
        """Block until some replica (optionally: not ``exclude``) serves
        as leader; returns {"id", "url", "elapsed_s"}."""
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        while time.monotonic() < deadline:
            r = self.leader()
            if r is not None and r.replica_id != exclude:
                return {
                    "id": r.replica_id,
                    "url": r.base_url,
                    "elapsed_s": time.monotonic() - t0,
                }
            time.sleep(0.05)
        raise RuntimeError(
            f"no leader within {timeout_s}s (statuses: {self.statuses()})"
        )

    def stop(self) -> None:
        for r in self.replicas:
            r.kill()


# ---------------------------------------------------------------------------
# killable split coordinator
# ---------------------------------------------------------------------------


def _split_coordinator_child_main(
    topology: dict,
    namespace: str,
    target_gid: str,
    ttl_s: float,
    hold_s: float = 0.0,
) -> None:
    """One split coordinator's whole life in a fresh interpreter: run
    ``split_namespace`` against a live sharded plane, optionally parking
    ``hold_s`` inside the freeze (right after the freeze fanout, before
    the handoff), where a test SIGKILLs it.  Prints ``FROZEN <lease_id>``
    once the namespace is frozen and ``DONE <result json>`` at the end."""
    from minisched_tpu_torch.controlplane.shards import (
        ShardTopology,
        split_namespace,
    )

    topo = ShardTopology.from_dict(topology)

    def after_freeze(lease_id: str) -> None:
        print(f"FROZEN {lease_id}", flush=True)
        if hold_s > 0:
            time.sleep(hold_s)

    result = split_namespace(topo, namespace, target_gid, ttl_s=ttl_s,
                             _after_freeze=after_freeze)
    print("DONE " + json.dumps(result), flush=True)


_COORD_CMD = (
    "import json, sys; "
    "from minisched_tpu_torch.controlplane.replproc import "
    "_split_coordinator_child_main; "
    "_split_coordinator_child_main(**json.loads(sys.argv[1]))"
)


class SplitCoordinator:
    """A killable split-coordinator child: one ``split_namespace`` from its
    own interpreter, so a test can SIGKILL the coordinator (not just a
    shard leader) anywhere in the split and check the plane heals itself
    (leases thaw at their TTL, ownership unchanged, no acked write
    lost)."""

    def __init__(self, topology: dict, namespace: str, target_gid: str,
                 ttl_s: float, hold_s: float = 0.0):
        self._cfg = {"topology": topology, "namespace": namespace,
                     "target_gid": target_gid, "ttl_s": ttl_s,
                     "hold_s": hold_s}
        self._proc: Any = None
        self.lease_id = ""
        self.result: Optional[dict] = None

    def start(self) -> "SplitCoordinator":
        env = dict(os.environ)
        repo_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        # host code: no CUDA context on the card
        env["CUDA_VISIBLE_DEVICES"] = ""
        self._proc = subprocess.Popen(
            [sys.executable, "-c", _COORD_CMD, json.dumps(self._cfg)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        return self

    def wait_frozen(self, timeout_s: float = 30.0) -> str:
        """Block until the child reports the freeze fanout landed; the
        lease id."""
        deadline = time.monotonic() + timeout_s
        line = ""
        while time.monotonic() < deadline:
            line = self._proc.stdout.readline()
            if line.startswith("FROZEN "):
                self.lease_id = line.split(None, 1)[1].strip()
                return self.lease_id
            if not line and self._proc.poll() is not None:
                break
        raise RuntimeError(f"coordinator never froze (last line {line!r}, "
                           f"exit {self._proc.poll()})")

    def wait_done(self, timeout_s: float = 60.0) -> dict:
        """Block until the child's split completes; its result."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            line = self._proc.stdout.readline()
            if line.startswith("DONE "):
                self.result = json.loads(line[len("DONE "):])
                self._proc.wait(timeout=10.0)
                return self.result
            if not line and self._proc.poll() is not None:
                raise RuntimeError(f"coordinator exited "
                                   f"{self._proc.returncode} without "
                                   "completing the split")
        raise RuntimeError(f"split not done within {timeout_s}s")

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def kill(self) -> None:
        """SIGKILL mid-split: the lease TTL is then the only thaw."""
        if self._proc is None:
            return
        if self._proc.poll() is None:
            self._proc.kill()
        try:
            self._proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            pass
