"""Process entry point: boot the whole stack from environment config.

A copy of ``minisched_tpu/__main__.py``, which re-creates ``sched.go``'s
boot order (sched.go:21-68): read the env config (PORT, FRONTEND_URL),
bring up the control plane (the REST façade on PORT, over the in-memory
store), start the PV controller, start the scheduler service, then serve
until SIGINT or SIGTERM, which stop all three and exit 0.

    PORT=10251 FRONTEND_URL=http://localhost:3000 python -m minisched_tpu_torch

The scheduler is the device engine with the full default roster
(``default_full_roster_config``) on the card, as ``start_scheduler``'s
default is; without a card it raises at boot and the process exits
non-zero (there is no fallback to the CPU).  ``MINISCHED_DEVICE_MODE=0``
runs the host-only scalar engine with the reference's default chain
(``default_scheduler_config``) instead.

Subcommand:

    python -m minisched_tpu_torch metrics <url>

        scrape ``<url>/metrics`` (the REST façade, or ``metricsd``'s
        listener) and print the snapshot: counters, gauges, and each
        histogram's count and p50/p99 bucket bounds.

Not ported yet, and refused: the durable store
(``MINISCHED_TPU_STORE_URL=file://...`` and the ``fsck`` subcommand) and
a device mesh (``MINISCHED_MESH_DEVICES`` > 0).
"""

from __future__ import annotations

import os
import signal
import sys
import threading
from typing import Any, Callable, Tuple

from minisched_tpu_torch import resolve_device
from minisched_tpu_torch.controlplane.client import (
    DEFAULT_BURST,
    DEFAULT_QPS,
    Client,
)
from minisched_tpu_torch.controlplane.httpserver import start_api_server
from minisched_tpu_torch.controlplane.pvcontroller import start_pv_controller
from minisched_tpu_torch.controlplane.store import ObjectStore
from minisched_tpu_torch.service.config import (
    ProcessConfig,
    default_full_roster_config,
    default_scheduler_config,
)
from minisched_tpu_torch.service.service import SchedulerService

DURABLE_NOT_PORTED = (
    "the durable store (controlplane/durable.py, walio.py, checkpoint.py, "
    "fsck.py) is a later slice of the port")


def start(cfg: ProcessConfig, device_mode: bool = True, mesh_devices: int = 0,
          device: Any = None) -> Tuple[Client, str, Callable[[], None]]:
    """Boot the stack; returns (client, API base URL, stop).  ``device``
    is the device engine's (None: the card); ``stop.service`` is the
    scheduler service."""
    # refuse what cannot run BEFORE booting anything: a failure after the
    # API server and the PV controller are up would leak their threads
    if mesh_devices:
        raise ValueError("MINISCHED_MESH_DEVICES: a device mesh is not "
                         "ported yet (ROADMAP item 12)")
    if cfg.external_store_url.startswith("file://"):
        raise ValueError(f"MINISCHED_TPU_STORE_URL={cfg.external_store_url}:"
                         f" {DURABLE_NOT_PORTED}")
    if cfg.external_store_url:
        raise ValueError(f"unsupported store url {cfg.external_store_url!r} "
                         f"(file://<path> only)")
    if device_mode:
        resolve_device(device)
    store = ObjectStore()
    # the reference's client limits (k8sapiserver.go:57-62: QPS/Burst 5000)
    client = Client(store=store, qps=DEFAULT_QPS, burst=DEFAULT_BURST)
    # the HTTP façade serves the store beneath the client's rate limiter
    _server, base, shutdown_api = start_api_server(store, port=cfg.port)
    pv = start_pv_controller(client)
    service = SchedulerService(client)
    try:
        service.start_scheduler(
            default_full_roster_config() if device_mode
            else default_scheduler_config(),
            device_mode=device_mode, device=device)
    except BaseException:
        service.close()
        pv.stop()
        shutdown_api()
        raise

    def stop() -> None:
        service.close()
        pv.stop()
        shutdown_api()

    # the running service, for a caller that reads its engine's counters
    stop.service = service
    return client, base, stop


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "fsck":
        raise ValueError(f"fsck: {DURABLE_NOT_PORTED}")
    if argv and argv[0] == "metrics":
        # a scrape boots nothing of the scheduler
        from minisched_tpu_torch.observability.metricsd import scrape_main

        return scrape_main(argv[1:])
    cfg = ProcessConfig.from_env()
    device_mode = os.environ.get("MINISCHED_DEVICE_MODE", "1") != "0"
    mesh_devices = int(os.environ.get("MINISCHED_MESH_DEVICES", "0"))
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    _, base, stop = start(cfg, device_mode=device_mode,
                          mesh_devices=mesh_devices)
    print(f"minisched_tpu_torch: API on {base} (frontend "
          f"{cfg.frontend_url})", flush=True)
    done.wait()
    stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
