"""Where the time of the repair-wave route goes on the card.

Run from the root of the repository on a machine with a CUDA card:

    python3 -m minisched_tpu_torch.profile_repair [--roster full|node-local] [--trace-dir DIR]

Config 5 at full size (``fullchain.mk_c5_cluster``: 10,000 nodes,
100,000 pods) in repair waves of 16,384 with the full default roster (the
default) or the node-local roster, the node and pod tables already on the
device; with the full roster each wave's constraint tables are built on
the host inside the loop, as ``schedule_waves`` builds them:

* the host wall time of the whole wave loop, closed by a synchronise,
  over ``REPS`` passes after one warm-up pass (median and spread);
* one pass under ``torch.profiler``: the device busy time (the union of
  the intervals of every kernel and copy on the card), the idle share of
  the profiled window, device launches in all and per repair round,
  device ms per round, ``select_hosts``' share of the busy time, device
  time by kernel (device events only), and device time by span: each
  plugin's batch method, ``precompute_static``, ``accept_placements`` and
  ``apply_placements``, each wrapped in a ``record_function`` range for
  this pass only (the library itself carries no annotation).
  ``select_hosts`` has no span: the profiler does not attribute its
  launch, made through ctypes, to the enclosing range, so its time and
  launches are read from the kernel list alone.  The host's constraint
  builds show as device idle time.

It ends in one JSON line.  ``--trace-dir`` also writes a Chrome trace
there.  Without a card the script raises.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import statistics
import time
from pathlib import Path
from typing import Any, Iterator, Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from minisched_tpu_torch import resolve_device
from minisched_tpu_torch.engine.gang import PlacedGangs
from minisched_tpu_torch.fullchain import WAVE, mk_c5_cluster
from minisched_tpu_torch.headline import (
    ConstraintFeed,
    RepairStep,
    make_step,
    pods_by_node,
    run_waves,
)
from minisched_tpu_torch.models.tables import pack_node_table, pack_pod_table, pad_to
from minisched_tpu_torch.ops import repair
from minisched_tpu_torch.profile_headline import _busy_us
from minisched_tpu_torch.service.config import (
    default_full_roster_config,
    node_local_roster_config,
)

REPS = 5  # timed passes
SPAN = "span:"  # prefix of the record_function ranges added here


def _spanned(fn, name: str):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(SPAN + name):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def spans(evaluator) -> Iterator[None]:
    """Wrap each plugin's batch methods and the loop's own steps in
    ``record_function`` ranges while the block runs, then restore them."""
    patched = []  # (owner, attribute, original, is_instance_attribute)
    plugins = {id(pl): pl for chain in (evaluator.filter_plugins,
                                        evaluator.pre_score_plugins,
                                        evaluator.score_plugins)
               for pl in chain}
    for pl in plugins.values():
        for method in ("batch_filter", "batch_pre_score", "batch_score",
                       "batch_normalize"):
            patched.append((pl, method, None, True))
            setattr(pl, method, _spanned(getattr(pl, method),
                                         f"{pl.name()}.{method[6:]}"))
    for module, name in ((repair, "accept_placements"),
                         (repair, "apply_placements"),
                         (repair, "precompute_static")):
        original = getattr(module, name)
        patched.append((module, name, original, False))
        setattr(module, name, _spanned(original, name))
    try:
        yield
    finally:
        for owner, name, original, on_instance in reversed(patched):
            if on_instance:
                delattr(owner, name)
            else:
                setattr(owner, name, original)


def profile_repair(step: RepairStep, nodes: Sequence[Any],
                   waves: Sequence[Sequence[Any]], device: torch.device,
                   trace_dir: Optional[Path] = None, reps: int = REPS,
                   assigned: Sequence[Any] = ()) -> dict:
    """``reps`` timed passes of ``step`` (``make_step("repair", cfg)``)
    over the pod ``waves`` against ``nodes`` holding the ``assigned``
    pods, then one profiled pass.  The node and pod tables go to the
    device before any pass; a roster that reads constraint tables gets a
    fresh ``ConstraintFeed`` each pass, and waves with gang members a
    fresh ``GangFeed``."""
    evaluator = step.evaluator
    node_cap, pod_cap = pad_to(len(nodes)), max(len(waves[0]), 128)
    node_host, node_names = pack_node_table(nodes, pods_by_node(assigned),
                                            capacity=node_cap)
    pod_tables = [pack_pod_table(w, capacity=pod_cap)[0].to_device(device)
                  for w in waves]
    pods = [p for w in waves for p in w]

    def make_feeds():
        return (ConstraintFeed.for_step(step, nodes, node_names, assigned,
                                        (), (), node_cap, device),
                PlacedGangs.for_pods(pods, nodes, assigned))

    def one_pass() -> float:
        node_table = node_host.to_device(device)
        feed, gangs = make_feeds()
        torch.cuda.synchronize(device)
        t0 = time.monotonic()
        run_waves(step, node_table, pod_tables, feed, waves, gangs)
        torch.cuda.synchronize(device)
        return time.monotonic() - t0

    one_pass()  # warm-up: first launches, allocator growth
    walls = [one_pass() for _ in range(reps)]

    node_table = node_host.to_device(device)
    feed, gangs = make_feeds()
    torch.cuda.synchronize(device)
    with spans(evaluator), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, outs = run_waves(step, node_table, pod_tables, feed, waves, gangs)
        torch.cuda.synchronize(device)
        window_us = (time.monotonic() - t0) * 1e6
    # the spans also show on the device timeline as annotations: they are
    # not kernels and are left out of busy time, launches and kernels
    cuda = torch.autograd.DeviceType.CUDA
    device_events = [e for e in prof.events() if e.device_type == cuda
                     and not e.name.startswith(SPAN)]
    busy_us = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in device_events])
    averages = prof.key_averages()
    by_kernel = sorted(
        ((a.key, a.count, a.self_device_time_total) for a in averages
         if a.device_type == cuda and not a.key.startswith(SPAN)),
        key=lambda kv: -kv[2],
    )
    select_us = sum(us for name, _, us in by_kernel if "select_hosts" in name)
    # a span's device time: the kernels launched inside its host range
    by_span = sorted(
        ((a.key[len(SPAN):], a.count, a.device_time_total) for a in averages
         if a.key.startswith(SPAN) and a.device_type != cuda),
        key=lambda kv: -kv[2],
    )
    if trace_dir is not None:
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / "repair_config5.json"))
    rounds = [o.rounds for o in outs]
    n_rounds = sum(rounds)
    return {
        "route": "repair",
        "roster": "full" if step.needs_extra else "node-local",
        "waves": len(pod_tables),
        "rounds_per_wave": rounds,
        "wall_ms_median": statistics.median(walls) * 1e3 if walls else None,
        "wall_ms_min": min(walls) * 1e3 if walls else None,
        "wall_ms_max": max(walls) * 1e3 if walls else None,
        "constraint_build_ms": feed.build_s * 1e3 if feed else 0.0,
        "gang_view_ms": gangs.view_s * 1e3 if gangs else 0.0,
        "profiled_window_ms": window_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / window_us if window_us else None,
        "device_launches": len(device_events),
        "launches_per_round": len(device_events) / n_rounds,
        "device_ms_per_round": busy_us / 1e3 / n_rounds,
        "select_hosts_launches": sum(c for name, c, _ in by_kernel
                                     if "select_hosts" in name),
        "select_hosts_ms": select_us / 1e3,
        "select_hosts_share_of_busy": select_us / busy_us if busy_us else None,
        "top_kernels": [
            {"name": name[:80], "count": count, "device_ms": us / 1e3}
            for name, count, us in by_kernel[:15]
        ],
        "spans": [
            {"name": name, "count": count, "device_ms": us / 1e3}
            for name, count, us in by_span
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roster", choices=("full", "node-local"), default="full")
    ap.add_argument("--trace-dir", type=Path, default=None)
    args = ap.parse_args(argv)
    device = resolve_device(None)

    nodes, pods = mk_c5_cluster()
    cfg = (default_full_roster_config() if args.roster == "full"
           else node_local_roster_config())
    waves = [pods[s:s + WAVE] for s in range(0, len(pods), WAVE)]
    print(f"card: {torch.cuda.get_device_name(device)}", flush=True)
    out = profile_repair(make_step("repair", cfg), nodes, waves, device,
                         args.trace_dir)
    for k in out["top_kernels"]:
        print(f"[repair] {k['device_ms']:9.4f} ms  x{k['count']:<5d} "
              f"{k['name']}", flush=True)
    for k in out["spans"]:
        print(f"[span] {k['device_ms']:9.4f} ms  x{k['count']:<5d} "
              f"{k['name']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
