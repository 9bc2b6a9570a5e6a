"""Where the time of the headline wave path goes on the card.

Run from the root of the repository on a machine with a CUDA card:

    python3 -m minisched_tpu_torch.profile_headline [--trace-dir DIR]

For each route of ``headline.schedule_waves`` (fused, generic) on the
headline cluster (10,000 nodes, 100,000 pods, waves of 8,192), with every
table already on the device:

* the host wall time of the whole wave loop, closed by a synchronise,
  over ``REPS`` passes after one warm-up pass (median and spread);
* one pass under ``torch.profiler``: the device busy time (the union of
  the intervals of every kernel and copy on the card), the idle share of
  the profiled window, and device time by kernel (device events only).

Each route ends in one JSON line.  ``--trace-dir`` also writes a Chrome
trace per route there.  Without a card the script raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path
from typing import List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from minisched_tpu_torch import resolve_device
from minisched_tpu_torch.headline import (
    ROUTES,
    WAVE,
    make_step,
    mk_cluster,
    run_waves,
)
from minisched_tpu_torch.models.tables import pack_node_table, pack_pod_table, pad_to

REPS = 7  # timed passes of each route


def _busy_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end <= reach:
            continue
        total += end - max(start, reach)
        reach = end
    return total


def profile_route(route: str, node_host, pod_tables, n_live,
                  device: torch.device, trace_dir: Optional[Path]) -> dict:
    step = make_step(route)

    def one_pass() -> float:
        node_table = node_host.to_device(device)
        torch.cuda.synchronize(device)
        t0 = time.monotonic()
        run_waves(step, node_table, pod_tables, n_live)
        torch.cuda.synchronize(device)
        return time.monotonic() - t0

    one_pass()  # warm-up: first launches, allocator growth
    walls = [one_pass() for _ in range(REPS)]

    node_table = node_host.to_device(device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run_waves(step, node_table, pod_tables, n_live)
        torch.cuda.synchronize(device)
        window_us = (time.monotonic() - t0) * 1e6
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in device_events])
    by_kernel = sorted(
        ((a.key, a.count, a.self_device_time_total)
         for a in prof.key_averages()
         if a.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda kv: -kv[2],
    )
    if trace_dir is not None:
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / f"headline_{route}.json"))
    return {
        "route": route,
        "waves": len(pod_tables),
        "wall_ms_median": statistics.median(walls) * 1e3,
        "wall_ms_min": min(walls) * 1e3,
        "wall_ms_max": max(walls) * 1e3,
        "profiled_window_ms": window_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / window_us if window_us else None,
        "device_launches": len(device_events),
        "top_kernels": [
            {"name": name[:80], "count": count, "device_ms": us / 1e3}
            for name, count, us in by_kernel[:12]
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace-dir", type=Path, default=None)
    args = ap.parse_args(argv)
    device = resolve_device(None)

    nodes, pods = mk_cluster()
    node_host, _ = pack_node_table(nodes, capacity=pad_to(len(nodes)))
    starts = range(0, len(pods), WAVE)
    pod_tables = [pack_pod_table(pods[s:s + WAVE], capacity=WAVE)[0].to_device(device)
                  for s in starts]
    n_live = [min(WAVE, len(pods) - s) for s in starts]
    print(f"card: {torch.cuda.get_device_name(device)}", flush=True)
    for route in ROUTES:
        out = profile_route(route, node_host, pod_tables, n_live, device,
                            args.trace_dir)
        for k in out["top_kernels"]:
            print(f"[{route}] {k['device_ms']:9.4f} ms  x{k['count']:<4d} "
                  f"{k['name']}", flush=True)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
