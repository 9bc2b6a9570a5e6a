"""Writer starvation under back-to-back compaction, both packages' stores.

``test_checkpoint_snapshot_under_concurrent_writes_round_trips`` (in
``test_durable.py`` and ``test_torch_durable.py``) binds 120 pods in
batches of 10 while another thread calls ``compact()`` in a loop.  Python's
locks are not fair: a loop that re-takes the store's locks right after
releasing them can keep a woken writer out for a long time.  This script
runs that scenario ``--runs`` times on each package's
``DurableObjectStore`` and prints, per run, the wall, the compactions and
the longest ``bind_many``; then the median and the worst.

It first runs the port's device engine once on the CPU
(``test_torch_durable.test_scheduler_runs_on_durable_store``), as the test
files do before the scenario; that is the process state in which the
starvation shows.

    JAX_PLATFORMS=cpu python tests/compact_fairness.py --runs 16
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

N_NODES, N_PODS, BATCH = 4, 120, 10


def one_run(store_cls, client_cls, binding, make_node, make_pod,
            workdir: Path, timeout_s: float):
    """(wall, compactions, longest bind_many seconds, every bind done)."""
    store = store_cls(str(workdir / "store.wal"))
    client = client_cls(store=store)
    for i in range(N_NODES):
        client.nodes().create(make_node(f"n{i}"))
    for i in range(N_PODS):
        client.pods().create(make_pod(f"p{i:03d}"))
    stop = threading.Event()
    waits: list = []
    compactions = [0]

    def binder():
        try:
            for start in range(0, N_PODS, BATCH):
                t0 = time.monotonic()
                client.pods().bind_many([
                    binding(f"p{i:03d}", "default", f"n{i % N_NODES}")
                    for i in range(start, start + BATCH)])
                waits.append(time.monotonic() - t0)
        finally:
            stop.set()

    def compactor():
        while not stop.is_set():
            store.compact()
            compactions[0] += 1

    threads = [threading.Thread(target=binder, daemon=True),
               threading.Thread(target=compactor, daemon=True)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    wall = time.monotonic() - t0
    done = len(waits) == N_PODS // BATCH
    stop.set()
    for t in threads:
        t.join()
    store.close()
    return wall, compactions[0], max(waits, default=wall), done


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=16)
    ap.add_argument("--store", choices=("port", "jax", "both"),
                    default="both")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a run may take before it is cut")
    args = ap.parse_args()

    import test_torch_durable as ttd

    with tempfile.TemporaryDirectory() as d:
        ttd.test_scheduler_runs_on_durable_store(Path(d))
    sides = []
    if args.store in ("port", "both"):
        from minisched_tpu_torch.api.objects import Binding, make_node, make_pod
        from minisched_tpu_torch.controlplane.client import Client
        from minisched_tpu_torch.controlplane.durable import DurableObjectStore
        sides.append(("port", DurableObjectStore, Client, Binding,
                      make_node, make_pod))
    if args.store in ("jax", "both"):
        from minisched_tpu.api.objects import Binding as JBinding
        from minisched_tpu.controlplane.client import Client as JClient
        from minisched_tpu.controlplane.durable import (
            DurableObjectStore as JStore,
        )
        from test_durable import make_node as jnode, make_pod as jpod
        sides.append(("jax", JStore, JClient, JBinding, jnode, jpod))
    for name, *parts in sides:
        walls = []
        for i in range(args.runs):
            with tempfile.TemporaryDirectory() as d:
                wall, n, worst, done = one_run(*parts, Path(d), args.timeout)
            walls.append(wall)
            print(f"{name} run {i}: {wall:.3f} s, {n} compactions, longest "
                  f"bind_many {worst:.3f} s{'' if done else ', CUT'}",
                  flush=True)
        walls.sort()
        print(f"{name}: {args.runs} runs, median {walls[len(walls) // 2]:.3f}"
              f" s, worst {walls[-1]:.3f} s, over 2 s: "
              f"{sum(w > 2.0 for w in walls)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
