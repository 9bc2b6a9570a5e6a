"""Engines as killable child processes: real SIGKILL failover.

A copy of ``minisched_tpu/ha/proc.py``.  ``faults/proc.py`` kills the
control plane; this module kills a scheduler.  An
:class:`EngineSupervisor` runs one HA engine (``ha/plane.start_ha_engine``
over a ``RemoteClient``) in a fresh ``python -c`` child, SIGKILLs it on
demand (no lease release, no queue drain: the member just stops
renewing), and the survivors must observe the expiry through the watch
path, bump their epochs and adopt the orphaned shard within the lease
TTL.

The process hygiene of the server supervisor: a fresh interpreter (never
a fork, and never after this process opened CUDA), a parent-death
watchdog, and readiness read off the plane: the child's member lease
live in the store.

Where JAX's child sets ``JAX_PLATFORMS=cpu`` (N scalar engines must not
fight over one accelerator), the port's runs the device engine on
``device``: ``"cuda"`` by default, each child with a CUDA context of its
own on the one card, or ``"cpu"`` (the tests; the child then sees no
card).  A child asked for a CUDA device it cannot find exits non-zero
before it joins, and ``start()`` raises with the child's stderr: there
is no silent CPU engine.

``metrics_port`` arms the child's ``observability/metricsd`` sidecar, as
in JAX.  The port's child also publishes there, at each scrape, its
kernels' counts (gauges ``kernel.launches.<kernel>`` and
``kernel.plain_calls.<kernel>`` from ``ops.kernels``), its engine's
``engine.loop_errors`` and ``engine.assumed``, its peak device memory
(``cuda.peak_allocated_bytes``) and the milliseconds from its start to
a running engine (``ha.engine_ready_ms``); the parent's own
launch counts never see a child's launches.  ``scrape()`` and
``kernel_counts()`` read them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Any, Dict, Optional

from minisched_tpu_torch.faults.proc import (
    PORT_RETRIES,
    PORT_TAKEN,
    PortTaken,
    _free_port,
    child_env,
    orphan_watchdog,
    stderr_tail,
)

#: exit code of a child that finds no CUDA device where it was asked for one
NO_DEVICE_EXIT = 3


def _publish_counts(device: Any, engine: Dict[str, Any]) -> None:
    """Copy this process's kernel counts, its engine's loop errors and
    assumptions (once ``engine["ha"]`` is set) and, on a card, its peak
    device memory into the counters registry, as gauges."""
    from minisched_tpu_torch.observability import counters
    from minisched_tpu_torch.ops import kernels

    for name, n in kernels.launch_counts.items():
        counters.set_gauge(f"kernel.launches.{name}", n)
    for name, n in kernels.plain_calls.items():
        counters.set_gauge(f"kernel.plain_calls.{name}", n)
    ha = engine.get("ha")
    if ha is not None:
        counters.set_gauge("engine.loop_errors", ha.scheduler.loop_errors)
        counters.set_gauge("engine.assumed", ha.scheduler.assumed_count()
                           if hasattr(ha.scheduler, "assumed_count") else 0)
    if device.type == "cuda":
        import torch

        counters.set_gauge("cuda.peak_allocated_bytes",
                           torch.cuda.max_memory_allocated(device))


def _engine_child_main(
    base_url: str,
    engine_id: str,
    ttl_s: float = 2.0,
    device_mode: bool = True,
    max_wave: int = 64,
    parent_pid: Optional[int] = None,
    metrics_port: Optional[int] = None,
    device: str = "cuda",
) -> None:
    """The child's whole life: check its device, join the plane over the
    wire, schedule, park until SIGKILL."""
    t_start = time.monotonic()
    from hashlib import blake2s

    import torch

    dev = torch.device(device)
    if device_mode and dev.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0 or (dev.index is not None and dev.index >= n):
            print(f"engine {engine_id}: no CUDA device {device!r} "
                  f"({n} visible)", file=sys.stderr, flush=True)
            sys.exit(NO_DEVICE_EXIT)

    from minisched_tpu_torch.controlplane.remote import RemoteClient
    from minisched_tpu_torch.ha.plane import start_ha_engine
    from minisched_tpu_torch.observability import counters
    from minisched_tpu_torch.service.config import default_full_roster_config

    engine: Dict[str, Any] = {}
    if metrics_port is not None:
        from minisched_tpu_torch.observability.metricsd import (
            start_metrics_server,
        )

        start_metrics_server(port=metrics_port,
                             collect=lambda: _publish_counts(dev, engine))

    # per-engine deterministic retry jitter (hash() is salted per process)
    seed = int.from_bytes(blake2s(engine_id.encode(), digest_size=4).digest(),
                          "big")
    client = RemoteClient(base_url, retries=10, backoff_initial_s=0.05,
                          retry_seed=seed)
    engine["ha"] = start_ha_engine(
        client, engine_id, cfg=default_full_roster_config(), ttl_s=ttl_s,
        device_mode=device_mode, max_wave=max_wave, device=device)
    counters.set_gauge("ha.engine_ready_ms",
                       int((time.monotonic() - t_start) * 1000))
    if parent_pid:
        orphan_watchdog(parent_pid)
    threading.Event().wait()  # until SIGKILL: crashes do not say goodbye


_CHILD_CMD = (
    "import json, sys; "
    "from minisched_tpu_torch.ha.proc import _engine_child_main; "
    "_engine_child_main(**json.loads(sys.argv[1]))"
)


class EngineSupervisor:
    """Run one HA scheduler engine as a killable child process."""

    def __init__(self, base_url: str, engine_id: str, ttl_s: float = 2.0,
                 device_mode: bool = True, max_wave: int = 64,
                 boot_timeout_s: float = 90.0, device: str = "cuda",
                 metrics_port: Optional[int] = None):
        self._base = base_url
        self.engine_id = engine_id
        self._ttl_s = ttl_s
        self._device_mode = device_mode
        self._max_wave = max_wave
        self._boot_timeout_s = boot_timeout_s
        self._device = device
        # metrics_port=0 asks for an ephemeral one picked now (the parent
        # must know it to build metrics_url; restarts reuse it)
        self._auto_port = metrics_port == 0
        if self._auto_port:
            metrics_port = _free_port()
        self._metrics_port = metrics_port
        self._proc: Any = None
        self._stderr: Any = None
        self.kills = 0
        #: seconds from the last spawn to the child's member lease live
        self.boot_s = 0.0

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    @property
    def metrics_url(self) -> Optional[str]:
        """Scrape URL of the child's telemetry sidecar, or None when the
        supervisor was built without ``metrics_port``."""
        if self._metrics_port is None:
            return None
        return f"http://127.0.0.1:{self._metrics_port}/metrics"

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def _lease_live(self) -> bool:
        """Is the child's member lease present and unexpired?  The
        readiness (and liveness) probe, read off the plane."""
        from minisched_tpu_torch.controlplane.remote import RemoteStore
        from minisched_tpu_torch.ha.lease import HA_NAMESPACE
        from minisched_tpu_torch.ha.membership import MEMBER_PREFIX

        store = RemoteStore(self._base, retries=1, timeout_s=5.0)
        try:
            lease = store.get("Lease", HA_NAMESPACE,
                              MEMBER_PREFIX + self.engine_id)
        except Exception:
            return False
        finally:
            store.close()
        return not lease.expired(time.time())

    def start(self) -> None:
        """Spawn the child and block until its member lease is live (the
        engine has joined; its informers sync and its loop starts right
        after).  Raises with the child's stderr if it dies first.  An
        auto-picked metrics port that another socket took meanwhile (an
        outgoing connection can be handed the same ephemeral port) is
        picked anew, up to ``PORT_RETRIES`` times."""
        for attempt in range(PORT_RETRIES + 1):
            try:
                return self._start_once()
            except PortTaken:
                if not self._auto_port or attempt == PORT_RETRIES:
                    raise
                self._metrics_port = _free_port()

    def _start_once(self) -> None:
        if self.alive():
            raise RuntimeError(f"engine {self.engine_id!r} already running")
        cfg = {
            "base_url": self._base,
            "engine_id": self.engine_id,
            "ttl_s": self._ttl_s,
            "device_mode": self._device_mode,
            "max_wave": self._max_wave,
            "parent_pid": os.getpid(),
            "metrics_port": self._metrics_port,
            "device": self._device,
        }
        t0 = time.monotonic()
        self._stderr = tempfile.TemporaryFile()
        self._proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD_CMD, json.dumps(cfg)],
            env=child_env(cuda=self._device_mode
                          and self._device.startswith("cuda")),
            stdout=subprocess.DEVNULL,
            stderr=self._stderr,
        )
        deadline = t0 + self._boot_timeout_s
        while time.monotonic() < deadline:
            if self._proc.poll() is not None:
                rc, err = self._proc.returncode, stderr_tail(self._stderr)
                self.kill()
                raise (PortTaken if PORT_TAKEN in err else RuntimeError)(
                    f"engine child {self.engine_id!r} died at boot "
                    f"(exitcode {rc}): {err}")
            if self._lease_live():
                self.boot_s = time.monotonic() - t0
                return
            time.sleep(0.1)
        raise RuntimeError(f"engine child {self.engine_id!r} never joined "
                           f"the plane within {self._boot_timeout_s}s: "
                           f"{stderr_tail(self._stderr)}")

    def scrape(self, timeout_s: float = 10.0) -> Dict[str, float]:
        """The sidecar's exposition as {metric name: value}, each name's
        samples summed over their labels (a histogram's ``_count`` is its
        observations); histogram buckets left out."""
        from minisched_tpu_torch.observability import hist

        if self.metrics_url is None:
            raise RuntimeError(f"engine {self.engine_id!r}: no metrics_port")
        with urllib.request.urlopen(self.metrics_url, timeout=timeout_s) as r:
            _types, samples = hist.parse_prometheus(r.read().decode())
        out: Dict[str, float] = {}
        for name, _labels, val in samples:
            if not name.endswith("_bucket"):
                out[name] = out.get(name, 0.0) + val
        return out

    def kernel_counts(self) -> Dict[str, Dict[str, int]]:
        """The child's kernel launches and plain-twin calls, by kernel
        (off its sidecar's gauges)."""
        got = self.scrape()
        out: Dict[str, Dict[str, int]] = {"launches": {}, "plain_calls": {}}
        for name, val in got.items():
            for what in out:
                prefix = f"kernel_{what}_"
                if name.startswith(prefix):
                    out[what][name[len(prefix):]] = int(val)
        return out

    def kill(self) -> None:
        """SIGKILL: the lease stays behind, un-renewed; survivors must
        time it out and adopt the shard."""
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

    def stop(self) -> None:
        self.kill()
