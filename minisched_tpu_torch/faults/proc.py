"""Process-level chaos: kill the control plane, not just its responses.

A copy of ``minisched_tpu/faults/proc.py``.  A :class:`ServerSupervisor`
runs the REST façade in a child process over a ``file://`` WAL store,
SIGKILLs it (no shutdown handler runs: torn WAL tails and half-written
responses included) and restarts it on the same port.  Recovery is the
durable store's checkpoint and WAL tail replay; the port stays fixed, so
clients need no re-discovery, only the retry and reconnect machinery
they already have.

The child is a fresh ``python -c`` interpreter importing only the
control plane, never a fork: the parent's CUDA context and threads never
leak into it.  It runs with ``CUDA_VISIBLE_DEVICES`` empty (a control
plane is host code) and an orphan watchdog that polls ``getppid``.
``fault_seed``/``fault_rules`` arm a ``FaultFabric`` in the child, read
by its store (``watch.drop`` and the disk points) and its façade
(``http.500``, ``http.reset``).  The kill schedule can ride the same
fabric (``proc.kill``), so a failing soak reproduces from its seed.

Beyond JAX's child, the port's publishes two gauges on its ``/metrics``
once it serves: ``proc.boot_replay_us`` (the store's replay) and
``proc.boot_pending_pods`` (the pods it found without a node), and the
supervisor keeps ``boot_s`` (spawn to ``/healthz``) of the last start.
A child that dies at boot raises with the tail of its stderr; one whose
port, picked by the supervisor, another socket took first is started
again on a port picked anew, before the first start only.  And the
port's child stops in order on SIGTERM (``terminate``): it ends every
stream, closes its store and exits 0, where JAX's child only dies.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Any, Optional


def _free_port() -> int:
    """One ephemeral port, reused for every incarnation of the child:
    the client's base_url must survive restarts.  (Another process can
    grab it between close and the child's bind; that race is vanishing
    at test scale, and the server reuses addresses, so our own TIME_WAIT
    ghosts never block the rebind.)"""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: a child that dies at boot saying so lost its port to another socket
#: between the parent's pick and its own bind (an outgoing connection
#: can be handed the same ephemeral port); a port the supervisor picked
#: itself is picked anew at most this many times, before the first start
PORT_TAKEN = "Address already in use"
PORT_RETRIES = 3


class PortTaken(RuntimeError):
    """A child died at boot because its port was taken."""


def orphan_watchdog(parent_pid: int) -> None:
    """SIGKILL this process once its parent is gone: an aborted run must
    not strand a listener on a fixed port.  Polling ``getppid`` beats
    PR_SET_PDEATHSIG through ``preexec_fn``, which forces subprocess
    onto fork."""
    def watch() -> None:
        while os.getppid() == parent_pid:
            time.sleep(0.5)
        os.kill(os.getpid(), signal.SIGKILL)

    threading.Thread(target=watch, daemon=True, name="orphan-watchdog").start()


def stderr_tail(f: Any, limit: int = 4000) -> str:
    """The last ``limit`` characters a child wrote to ``f``."""
    try:
        f.seek(0)
        return f.read().decode(errors="replace")[-limit:]
    except (OSError, ValueError):
        return ""


def _child_main(
    wal_path: str,
    port: int,
    compact_every_s: Optional[float] = None,
    archive: bool = False,
    fsync: bool = False,
    parent_pid: Optional[int] = None,
    salvage: str = "off",
    scrub_every_s: Optional[float] = None,
    fault_seed: Optional[int] = None,
    fault_rules: Optional[dict] = None,
) -> None:
    """The child's whole life: recover the store from disk, serve REST on
    the fixed port, optionally compact on a timer, park until SIGKILL,
    or until SIGTERM, then stop the façade and close the store.

    ``salvage`` is the store's mid-file corruption policy at replay.
    ``fault_rules`` (``{point: {rate, after, max_fires, keys}}``) arms a
    FaultFabric in this process, so the disk points fire inside the
    server that owns the WAL.  ``scrub_every_s`` starts the store's
    background scrub."""
    from minisched_tpu_torch.controlplane.durable import DurableObjectStore
    from minisched_tpu_torch.controlplane.httpserver import start_api_server
    from minisched_tpu_torch.observability import counters

    store = DurableObjectStore(wal_path, fsync=fsync,
                               archive_compacted=archive, salvage=salvage)
    with store.locked():
        pending = sum(1 for p in store._objects.get("Pod", {}).values()
                      if not p.spec.node_name)
    counters.set_gauge("proc.boot_replay_us",
                       int(round(store.replay_s * 1e6)))
    counters.set_gauge("proc.boot_pending_pods", pending)
    fabric = None
    if fault_rules:
        from minisched_tpu_torch.faults import FaultFabric

        fabric = FaultFabric(fault_seed or 0)
        for point, rule in fault_rules.items():
            fabric.on(point, **rule)
        store.faults = fabric
    if scrub_every_s:
        store.start_scrub(scrub_every_s)
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    _server, _base, stop_server = start_api_server(store, port=port,
                                                   faults=fabric)
    if compact_every_s:
        def compactor() -> None:
            while True:
                time.sleep(compact_every_s)
                try:
                    store.compact()
                except Exception:
                    pass  # compaction is best effort; the WAL still grows

        threading.Thread(target=compactor, daemon=True).start()
    if parent_pid:
        orphan_watchdog(parent_pid)
    done.wait()  # a SIGKILL ends it here, with no orderly shutdown
    stop_server()
    store.close()


#: the -c stub each child incarnation boots through
_CHILD_CMD = (
    "import json, sys; "
    "from minisched_tpu_torch.faults.proc import _child_main; "
    "_child_main(**json.loads(sys.argv[1]))"
)


def child_env(cuda: bool) -> dict:
    """The environment of a child: this checkout first on PYTHONPATH (the
    caller's cwd may be elsewhere); without ``cuda`` no card visible."""
    env = dict(os.environ)
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    if not cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return env


class ServerSupervisor:
    """Run the REST control plane as a killable child process.

    ``compact_every_s`` arms periodic checkpoint compaction in the child,
    so restarts take the bounded-replay path and watch resumes can hit
    410.  ``archive_history=True`` keeps every truncated WAL segment in
    ``<wal>.history``, so the full-history double-bind audit stays
    possible across compactions."""

    def __init__(
        self,
        wal_path: str,
        port: int = 0,
        compact_every_s: Optional[float] = None,
        archive_history: bool = True,
        fsync: bool = False,
        boot_timeout_s: float = 30.0,
        salvage: str = "off",
        scrub_every_s: Optional[float] = None,
        fault_seed: Optional[int] = None,
        fault_rules: Optional[dict] = None,
    ):
        self._wal = wal_path
        #: a port picked here may be taken before the child binds it; it
        #: is picked anew only before the first start (restarts keep it)
        self._auto_port = not port
        self._port = port or _free_port()
        self._compact_every_s = compact_every_s
        self._archive = archive_history
        self._fsync = fsync
        self._boot_timeout_s = boot_timeout_s
        self._salvage = salvage
        self._scrub_every_s = scrub_every_s
        self._fault_seed = fault_seed
        self._fault_rules = fault_rules
        self._proc: Any = None
        self._stderr: Any = None
        self._chaos_thread: Optional[threading.Thread] = None
        self._chaos_stop = threading.Event()
        #: lifecycle evidence the soaks assert on
        self.kills = 0
        self.restarts = 0
        #: seconds from the last spawn to its first ``/healthz`` answer
        self.boot_s = 0.0
        #: the tail of the stderr of a child ``terminate`` saw fail
        self.exit_stderr = ""

    @property
    def base_url(self) -> str:
        return f"http://127.0.0.1:{self._port}"

    @property
    def metrics_url(self) -> str:
        """Where to scrape this child's telemetry: the façade serves
        ``/metrics`` and ``/debug/trace`` on the port clients know."""
        return self.base_url + "/metrics"

    @property
    def wal_path(self) -> str:
        return self._wal

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> str:
        """Spawn the child and block until ``/healthz`` answers (the
        readiness gate the reference's StartAPIServer polls)."""
        for attempt in range(PORT_RETRIES + 1):
            try:
                base = self._start_once()
                self._auto_port = False  # clients know this port now
                return base
            except PortTaken:
                if not self._auto_port or attempt == PORT_RETRIES:
                    raise
                self._port = _free_port()
        raise AssertionError("unreachable")

    def _start_once(self) -> str:
        if self.alive():
            raise RuntimeError("control-plane child already running")
        cfg = {
            "wal_path": self._wal,
            "port": self._port,
            "compact_every_s": self._compact_every_s,
            "archive": self._archive,
            "fsync": self._fsync,
            "parent_pid": os.getpid(),
            "salvage": self._salvage,
            "scrub_every_s": self._scrub_every_s,
            "fault_seed": self._fault_seed,
            "fault_rules": self._fault_rules,
        }
        t0 = time.monotonic()
        self._stderr = tempfile.TemporaryFile()
        self._proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD_CMD, json.dumps(cfg)],
            env=child_env(cuda=False),
            stdout=subprocess.DEVNULL,
            stderr=self._stderr,
        )
        deadline = t0 + self._boot_timeout_s
        url = self.base_url + "/healthz"
        while time.monotonic() < deadline:
            if self._proc.poll() is not None:
                rc, err = self._proc.returncode, stderr_tail(self._stderr)
                self.kill()
                raise (PortTaken if PORT_TAKEN in err else RuntimeError)(
                    f"control-plane child died at boot (exitcode {rc}): "
                    f"{err}")
            try:
                with urllib.request.urlopen(url, timeout=1.0) as r:
                    if r.status == 200:
                        self.boot_s = time.monotonic() - t0
                        return self.base_url
            except OSError:
                pass
            time.sleep(0.05)
        raise RuntimeError(f"control-plane child failed /healthz within "
                           f"{self._boot_timeout_s}s")

    def kill(self) -> None:
        """SIGKILL: no atexit, no flush, no goodbye.  Whatever the WAL
        holds at this instant is the whole truth the next life recovers
        (a torn mid-append tail is truncated at replay)."""
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
        if self._stderr is not None:
            self._stderr.close()
            self._stderr = None

    def terminate(self, timeout_s: float = 60.0) -> Optional[int]:
        """The port's orderly stop: SIGTERM, then the child's exit code
        (0 once it ended its streams and closed its store; SIGKILL after
        ``timeout_s``, and its code).  None when no child runs; a
        non-zero code leaves the child's stderr in ``exit_stderr``."""
        if self._proc is None:
            return None
        self._proc.terminate()
        try:
            rc = self._proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            rc = self._proc.wait(timeout=10.0)
        self._proc = None
        if self._stderr is not None:
            self.exit_stderr = stderr_tail(self._stderr) if rc else ""
            self._stderr.close()
            self._stderr = None
        return rc

    def restart(self) -> str:
        base = self.start()
        self.restarts += 1
        return base

    def kill_and_restart(self) -> str:
        self.kill()
        return self.restart()

    def stop(self) -> None:
        """Supervisor teardown: stop the chaos thread, then the child."""
        self._chaos_stop.set()
        if self._chaos_thread is not None:
            self._chaos_thread.join(timeout=10.0)
            self._chaos_thread = None
        self.kill()

    # -- scheduled chaos ----------------------------------------------------
    def start_chaos(self, fabric: Any = None, interval_s: float = 1.0,
                    max_kills: int = 3) -> None:
        """Background killer: every ``interval_s`` decide whether to
        SIGKILL and restart.  With a FaultFabric the decision is its
        ``proc.kill`` schedule (arm the point with a rate); without one,
        every tick kills.  Stops after ``max_kills`` or ``stop()``."""
        if self._chaos_thread is not None:
            raise RuntimeError("chaos already running")
        self._chaos_stop.clear()

        def run() -> None:
            while not self._chaos_stop.is_set() and self.kills < max_kills:
                if self._chaos_stop.wait(interval_s):
                    return
                if fabric is not None and not fabric.should_fire(
                        "proc.kill", str(self._port)):
                    continue
                try:
                    self.kill_and_restart()
                except Exception:
                    # a failed restart leaves the plane down; the next
                    # tick retries rather than killing the chaos thread
                    import traceback

                    traceback.print_exc()

        self._chaos_thread = threading.Thread(target=run, name="proc-chaos",
                                              daemon=True)
        self._chaos_thread.start()

    def wait_chaos_done(self, timeout_s: float = 120.0) -> bool:
        """Block until the scheduled kills all happened (the soak then
        drives to convergence on a stable plane)."""
        t = self._chaos_thread
        if t is None:
            return True
        t.join(timeout=timeout_s)
        return not t.is_alive()
