#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``minisched_tpu_torch``).

Run from the root of the repository on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing catches it):

1. Build the hand-written kernels from ``minisched_tpu_torch/csrc`` and
   print the build time and the card's name and power limit.
2. Hold each kernel against its plain PyTorch twin on the card, bit for
   bit (tolerance 0: the outputs are integers), on random and tie-heavy
   scores, a row with no feasible node, seeds near 2**32, P=1, a ragged
   N=300 and the main-path shape P=8,192 x N=10,112.
3. Schedule the headline cluster (10,000 nodes, 20% cordoned, seed 1234;
   100,000 pods in waves of 8,192) through ``schedule_waves`` on the
   fused route and compare all 100,000 choices with ``headline_oracle``.
4. The same through the generic route: equal choices, and final node
   tables equal column for column.
5. Time each kernel per wave at the main-path shape (CUDA events around
   a batch of back-to-back calls, median over batches) beside its plain
   twin and its bound.  The fused kernel is timed alone, its
   ``tolerates_unschedulable`` prologue computed once beforehand and timed
   on its own line.

The launch counters are set to 0 just before each route of the main path
and read just after it.  The last three lines of output are the card's
name and power limit, one JSON object describing every kernel, and the
result line ``{"ok": true, "device": {...}}``.  Without a card, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor cores,
# which counts an FMA as two operations, i.e. 33.5 T float32 instructions
# a second.  An SM issues int32 arithmetic on 64 lanes a clock against
# float32's 128, so the int32 peak is half that: 16.75 T operations/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2 / 2
# integer operations of one mix32 (3 multiplies, 3 shifts, 4 xors) plus
# the compare against the running minimum
MIX32_OPS = 11
WAVE = 8192
N_NODES, N_PODS = 10_000, 100_000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def check_equal(what: str, got, want) -> int:
    """Raise unless the kernel's (choice, best) equal the twin's."""
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0 or any(not torch.equal(g, w) for g, w in zip(got, want)):
        bad = int((got[0] != want[0]).sum())
        raise AssertionError(f"{what}: kernel differs from its twin "
                             f"({bad} choices, max |err| {err})")
    return err


def time_ms(fn, rounds: int, batch: int, warmup: int = 3) -> float:
    """Milliseconds of one call: ``batch`` calls back to back between two
    events, so host gaps hide behind queued work; median over ``rounds``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # imported here: a bare copy of this script must fail, not half-run
    from minisched_tpu_torch.api.objects import Toleration, make_pod
    from minisched_tpu_torch.engine.oracle import headline_oracle
    from minisched_tpu_torch.headline import mk_cluster, schedule_waves
    from minisched_tpu_torch.models import tables
    from minisched_tpu_torch.ops import kernels
    from minisched_tpu_torch.plugins.nodeunschedulable import (
        tolerates_unschedulable,
    )
    from minisched_tpu_torch.utils import build

    dev = torch.device("cuda")
    torch.cuda.init()

    # -- phase 1: build ----------------------------------------------------
    t0 = time.monotonic()
    build.load_library()
    log(f"[build] kernels built in {time.monotonic() - t0:.2f}s "
        f"({build.library_path()})")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build] {line.strip()}")
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- phase 2: kernels against their twins ------------------------------
    gen = torch.Generator(device=dev)

    def plane_case(seed: int, P: int, N: int, tie_heavy: bool,
                   high_seeds: bool = False):
        gen.manual_seed(seed)
        if tie_heavy:
            scores = torch.randint(0, 2, (P, N), generator=gen, device=dev,
                                   dtype=torch.int32) * 10
        else:
            scores = torch.randint(-50, 500, (P, N), generator=gen,
                                   device=dev, dtype=torch.int32)
        mask = torch.rand((P, N), generator=gen, device=dev) < 0.7
        lo = (1 << 32) - 4096 if high_seeds else 0
        seeds = torch.randint(lo, 1 << 32, (P,), generator=gen, device=dev,
                              dtype=torch.int64)
        seeds = torch.where(seeds >= 1 << 31, seeds - (1 << 32), seeds)
        mask[0] = False  # a pod with no feasible node
        return scores.contiguous(), mask.contiguous(), seeds.to(torch.int32)

    plane_cases = {
        "random 256x2048": plane_case(1, 256, 2048, False),
        "tie-heavy 256x2048": plane_case(2, 256, 2048, True),
        "seeds near 2**32 256x2048": plane_case(3, 256, 2048, True, True),
        "P=1 N=300": plane_case(4, 1, 300, True),
        "ragged 77x300": plane_case(5, 77, 300, False, True),
        "main shape 8192x10112 tie-heavy": plane_case(6, WAVE, 10112, True),
    }
    sc, mk, _ = plane_cases["random 256x2048"]
    sc[1], mk[1] = torch.iinfo(torch.int32).min, True  # feasible at INT32_MIN
    for name, (scores, mask, seeds) in plane_cases.items():
        check_equal(f"select_hosts {name}",
                    kernels.select_hosts_cuda(scores, mask, seeds),
                    kernels.select_hosts_plain(scores, mask, seeds))
        log(f"[check] select_hosts {name}: bit-exact with the twin")

    nodes, pods = mk_cluster(N_NODES, N_PODS)
    node_table, _ = tables.build_node_table(nodes, device=dev)
    wave0, _ = tables.build_pod_table(pods[:WAVE], capacity=WAVE, device=dev)

    def tolerating_pods(n: int, seed: int):
        rng = np.random.default_rng(seed)
        tol = Toleration(key="node.kubernetes.io/unschedulable",
                         operator="Exists", effect="NoSchedule")
        return [make_pod(f"tol{i}", tolerations=[tol] if rng.random() < 0.3
                         else []) for i in range(n)]

    small_nodes = nodes[:300]
    nn_cases = {
        "tolerations 100x200": (
            tables.build_pod_table(tolerating_pods(100, 1), device=dev)[0],
            tables.build_node_table(nodes[:200], device=dev)[0]),
        "P=1 N=300": (
            tables.build_pod_table(pods[:1], capacity=1, device=dev)[0],
            tables.build_node_table(small_nodes, capacity=300, device=dev)[0]),
        "ragged 77x300 tolerations": (
            tables.build_pod_table(tolerating_pods(77, 2), capacity=77,
                                   device=dev)[0],
            tables.build_node_table(small_nodes, capacity=300, device=dev)[0]),
        "main shape 8192x10112": (wave0, node_table),
        "main shape, tolerations": (
            tables.build_pod_table(tolerating_pods(WAVE, 3), capacity=WAVE,
                                   device=dev)[0], node_table),
    }
    high = torch.arange(WAVE, device=dev, dtype=torch.int32) - WAVE
    nn_cases["main shape, seeds near 2**32"] = (
        replace(wave0, seed=high), node_table)  # 2**32 - 8192 .. 2**32 - 1
    main_err = {}
    for name, (pt, nt) in nn_cases.items():
        err = check_equal(f"nodenumber_select_hosts {name}",
                          kernels.nodenumber_select_hosts_cuda(pt, nt),
                          kernels.nodenumber_select_hosts_plain(pt, nt))
        if name == "main shape 8192x10112":
            main_err["nodenumber_select_hosts"] = err
        log(f"[check] nodenumber_select_hosts {name}: bit-exact with the twin")

    # the main-path inputs of the generic route's select_hosts: wave 0's
    # NodeUnschedulable mask and NodeNumber scores against the fresh table
    tol0 = tolerates_unschedulable(wave0)
    main_scores, main_mask = kernels.nodenumber_planes(tol0, wave0, node_table,
                                                       10)
    main_err["select_hosts"] = check_equal(
        "select_hosts main-path planes",
        kernels.select_hosts_cuda(main_scores, main_mask, wave0.seed),
        kernels.select_hosts_plain(main_scores, main_mask, wave0.seed))
    log("[check] select_hosts on the main path's wave-0 planes: bit-exact")

    # -- phases 3 and 4: the main path, both routes ------------------------
    want = headline_oracle(pods, nodes)
    runs, launches = {}, {}
    for route in ("fused", "generic"):
        kernels.reset_launch_counts()
        run = schedule_waves(nodes, pods, wave=WAVE, route=route)
        counts = dict(kernels.launch_counts)
        runs[route] = run
        log(f"[{route}] {run.n_waves} waves; launches {counts}; host build "
            f"{run.build_s:.3f}s, h2d {run.h2d_s:.3f}s, warmup "
            f"{run.warmup_s:.3f}s, schedule {run.schedule_s:.4f}s = "
            f"{N_PODS / run.schedule_s:,.0f} pods/s")
        if run.choices.shape != (N_PODS,):
            raise AssertionError(f"{route}: {run.choices.shape} choices")
        mismatch = np.flatnonzero(run.choices != want)
        if mismatch.size:
            raise AssertionError(
                f"{route}: {mismatch.size}/{N_PODS} placements differ from "
                f"headline_oracle, first at pod {int(mismatch[0])}")
        log(f"[{route}] all {N_PODS} placements equal headline_oracle")
        kernel = "nodenumber_select_hosts" if route == "fused" else "select_hosts"
        if counts[kernel] <= 0:
            raise AssertionError(f"{route}: {kernel} was never launched")
        launches[kernel] = counts[kernel]
    if not np.array_equal(runs["fused"].choices, runs["generic"].choices):
        raise AssertionError("the two routes chose differently")
    fused_cols = tables.table_columns(runs["fused"].node_table)
    for name, col in tables.table_columns(runs["generic"].node_table).items():
        if not torch.equal(col, fused_cols[name]):
            raise AssertionError(f"final node tables differ in {name}")
    placed = int((runs["fused"].choices >= 0).sum())
    if int(runs["fused"].node_table.req_pods.sum()) != placed or placed != N_PODS:
        raise AssertionError(f"{placed} placed, table holds "
                             f"{int(runs['fused'].node_table.req_pods.sum())}")
    log("[routes] equal choices; final node tables equal column for column")

    # -- phase 5: time per wave at the main-path shape ---------------------
    P, N = main_scores.shape
    best = main_scores.masked_fill(~main_mask, torch.iinfo(torch.int32).min)
    cand = int((main_mask & (best == best.max(dim=1, keepdim=True).values))
               .sum())
    pair_ops = {"select_hosts": 2, "nodenumber_select_hosts": 3}
    in_bytes = {
        # scores i32 + mask bool per pair, seeds i32 per pod
        "select_hosts": P * N * 5 + P * 4,
        # the kernel alone, its prologue's result given: node:
        # unschedulable, suffix, valid; pod: tol, valid, suffix, seed
        "nodenumber_select_hosts": N * 6 + P * (1 + 1 + 4 + 4),
    }
    calls = {
        "select_hosts": (
            lambda: kernels.select_hosts_cuda(main_scores, main_mask, wave0.seed),
            lambda: kernels.select_hosts_plain(main_scores, main_mask,
                                               wave0.seed)),
        "nodenumber_select_hosts": (
            lambda: kernels.nodenumber_body_cuda(tol0, wave0, node_table),
            lambda: kernels.nodenumber_body_plain(tol0, wave0, node_table)),
    }
    replaces = {
        "select_hosts": "minisched_tpu/ops/pallas_kernels.py:221",
        "nodenumber_select_hosts": "minisched_tpu/ops/pallas_kernels.py:174",
    }
    prologue_ms = time_ms(lambda: tolerates_unschedulable(wave0), rounds=9,
                          batch=20)
    log(f"[time] tolerates_unschedulable prologue (plain PyTorch, outside "
        f"the fused kernel's entry below) P={P}: {prologue_ms:.4f} ms")
    report = []
    for name in ("select_hosts", "nodenumber_select_hosts"):
        kernel_fn, plain_fn = calls[name]
        plain_a = time_ms(plain_fn, rounds=5, batch=2)
        ms = time_ms(kernel_fn, rounds=9, batch=20)
        ms_b = time_ms(kernel_fn, rounds=9, batch=20)
        plain_b = time_ms(plain_fn, rounds=5, batch=2)
        nbytes = in_bytes[name] + 2 * P * 4  # + choice, best
        ops = pair_ops[name] * P * N + MIX32_OPS * cand
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / INT32_OPS_PER_S * 1e3
        entry = {
            "name": name,
            "route": "cuda",
            "source": "minisched_tpu_torch/csrc/select_hosts.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": main_err[name],
            "ms": min(ms, ms_b),
            "plain_ms": min(plain_a, plain_b),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }
        report.append(entry)
        log(f"[time] {name} P={P} N={N}: kernel {ms:.4f} / {ms_b:.4f} ms, "
            f"plain {plain_a:.4f} / {plain_b:.4f} ms, bound "
            f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}: "
            f"{nbytes} B, {ops} int ops, {cand} candidates hashed)")

    log(card)
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
