"""How fast a gRPC ``Watch`` carries binds, with its process idle or busy.

Run from the root of the repository (no card needed: the stream is host
work):

    python3 -m minisched_tpu_torch.profile_grpc_watch [--pods N]

For each pair of ``--batch`` (events a message; 1 is JAX's wire) and
``--busy`` (threads spinning in pure Python in the server's process, a
stand-in for the live engine's thread), a fresh store holds config 5's
10,000 nodes and ``--pods`` pods; ``start_grpc_server`` serves it, a
watcher process (``live.count_grpc_binds``) opens a ``Watch`` on Pods,
and the main thread binds every pod in waves of ``--wave`` paced at
``--rate`` binds a second (the live engine's rate at config 5 is about
4,000).  Each pair ends in one JSON line: the binds and their wall, the
events and messages the watcher read, its events a second (first to last
event), ``grpc.watch.evicted``, and the error the stream ended with.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import threading
import time

from minisched_tpu_torch.api.objects import Binding
from minisched_tpu_torch.controlplane.client import Client
from minisched_tpu_torch.controlplane.grpcserver import start_grpc_server
from minisched_tpu_torch.fullchain import mk_c5_cluster
from minisched_tpu_torch.live import count_grpc_binds
from minisched_tpu_torch.observability import counters


def run(n_pods: int, wave: int, rate: float, batch: int, busy: int) -> dict:
    nodes, pods = mk_c5_cluster(10_000, n_pods)
    # the special* pods carry a selector; the store binds them all the same
    client = Client()
    client.nodes().create_many(nodes)
    client.pods().create_many(pods)
    names = [n.metadata.name for n in nodes if not n.spec.unschedulable]
    counters.reset()
    ctx = multiprocessing.get_context("spawn")
    from_watcher, to_parent = ctx.Pipe(duplex=False)
    _srv, address, shutdown = start_grpc_server(store=client.store)
    proc = ctx.Process(target=count_grpc_binds,
                       args=(address, n_pods, to_parent, batch), daemon=True)
    proc.start()
    spinning = [True]

    def spin() -> None:
        x = 0
        while spinning[0]:
            x += 1

    threads = [threading.Thread(target=spin, daemon=True)
               for _ in range(busy)]
    try:
        if not from_watcher.poll(120):
            raise RuntimeError("the watcher never opened its stream")
        from_watcher.recv()
        for t in threads:
            t.start()
        t0 = time.monotonic()
        for i in range(0, n_pods, wave):
            client.pods().bind_many(
                [Binding(p.metadata.name, p.metadata.namespace,
                         names[(i + j) % len(names)])
                 for j, p in enumerate(pods[i:i + wave])],
                return_objects=False)
            ahead = t0 + (i + wave) / rate - time.monotonic()
            if ahead > 0:
                time.sleep(ahead)
        bind_s = time.monotonic() - t0
        if not from_watcher.poll(600):
            raise RuntimeError("the watcher sent no result")
        seen = from_watcher.recv()
    finally:
        spinning[0] = False
        proc.join(30)
        if proc.is_alive():
            proc.terminate()
            proc.join(10)
        shutdown()
    return {"batch": batch, "busy_threads": busy, "binds": n_pods,
            "bind_s": bind_s, "binds_per_s": n_pods / bind_s,
            "events": seen["events"], "messages": seen["messages"],
            "span_s": seen["span_s"],
            "events_per_s": seen["events"] / max(seen["span_s"], 1e-9),
            "evicted": counters.get("grpc.watch.evicted"),
            "error": seen["error"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pods", type=int, default=40_960)
    ap.add_argument("--wave", type=int, default=2_048)
    ap.add_argument("--rate", type=float, default=4_096.0)
    ap.add_argument("--batch", default="1,1024")
    ap.add_argument("--busy", default="0,1")
    args = ap.parse_args()
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "no card"
    except OSError:
        card = "no card"
    print(f"machine: {card}; {os.cpu_count()} CPUs", flush=True)
    for batch in (int(b) for b in args.batch.split(",")):
        for busy in (int(b) for b in args.busy.split(",")):
            print(json.dumps(run(args.pods, args.wave, args.rate, batch,
                                 busy)), flush=True)


if __name__ == "__main__":
    main()
