"""Process entry point: boot the whole stack from environment config.

A copy of ``minisched_tpu/__main__.py``, which re-creates ``sched.go``'s
boot order (sched.go:21-68): read the env config (PORT, FRONTEND_URL),
bring up the control plane (the REST façade on PORT, over the store),
start the PV controller, start the scheduler service, then serve until
SIGINT or SIGTERM, which stop all three, close the store and exit 0.

    PORT=10251 FRONTEND_URL=http://localhost:3000 python -m minisched_tpu_torch

The store is the in-memory one unless ``MINISCHED_TPU_STORE_URL`` names
a WAL: with ``file://<path>`` it is ``durable.DurableObjectStore``, so
every write lands in the log before its call returns and a restart on
the same path recovers every node, pod and bind (fsync off, group commit
on, as ``store_from_url`` gives).  Any other scheme is refused.

The scheduler is the device engine with the full default roster
(``default_full_roster_config``) on the card, as ``start_scheduler``'s
default is; without a card it raises at boot and the process exits
non-zero (there is no fallback to the CPU).  ``MINISCHED_DEVICE_MODE=0``
runs the host-only scalar engine with the reference's default chain
(``default_scheduler_config``) instead.

Subcommands:

    python -m minisched_tpu_torch fsck <wal> [--repair [--accept-loss]]

        verify a durable store's files offline (``controlplane/fsck.py``):
        frames, checkpoint digests, a read-only replay, rv and uid
        monotonicity, the per-node aggregates and the double-bind audit;
        prints the JSON report and exits 0 when it is clean.  It boots
        neither the scheduler nor the card.

    python -m minisched_tpu_torch metrics <url>

        scrape ``<url>/metrics`` (the REST façade, or ``metricsd``'s
        listener) and print the snapshot: counters, gauges, and each
        histogram's count and p50/p99 bucket bounds.

Not ported yet, and refused: a device mesh (``MINISCHED_MESH_DEVICES``
> 0).
"""

from __future__ import annotations

import os
import signal
import sys
import threading
from typing import TYPE_CHECKING, Any, Callable, Tuple

from minisched_tpu_torch import resolve_device
from minisched_tpu_torch.controlplane.client import (
    DEFAULT_BURST,
    DEFAULT_QPS,
    Client,
)
from minisched_tpu_torch.controlplane.durable import store_from_url
from minisched_tpu_torch.controlplane.httpserver import start_api_server
from minisched_tpu_torch.controlplane.store import ObjectStore

if TYPE_CHECKING:
    from minisched_tpu_torch.service.config import ProcessConfig

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
    # the scheduler's modules (torch with them) load here, not with the
    # module: ``fsck`` and ``metrics`` run without them
    from minisched_tpu_torch.controlplane.pvcontroller import (
        start_pv_controller,
    )
    from minisched_tpu_torch.service.config import (
        default_full_roster_config,
        default_scheduler_config,
    )
    from minisched_tpu_torch.service.service import SchedulerService

    if device_mode:
        resolve_device(device)
    # empty: the in-memory store; file://<path>: the WAL (replayed here);
    # any other scheme raises before anything boots
    store = store_from_url(cfg.external_store_url) or ObjectStore()
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
        store.close()
        raise

    def stop() -> None:
        service.close()
        pv.stop()
        shutdown_api()
        store.close()

    # the running service, for a caller that reads its engine's counters,
    # and the store beneath the client
    stop.service = service
    stop.store = store
    return client, base, stop


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "fsck":
        # the integrity CLI boots neither the scheduler nor the card: it
        # runs against dead files, often on a box mid-incident
        from minisched_tpu_torch.controlplane.fsck import main as fsck_main

        return fsck_main(argv[1:])
    if argv and argv[0] == "metrics":
        # a scrape boots nothing of the scheduler
        from minisched_tpu_torch.observability.metricsd import scrape_main

        return scrape_main(argv[1:])
    from minisched_tpu_torch.service.config import ProcessConfig

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
