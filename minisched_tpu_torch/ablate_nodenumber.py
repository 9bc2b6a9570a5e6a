"""Where the fused kernel's time goes, by ablation on the card.

Run from the root of the repository on a machine with a CUDA card:

    python3 -m minisched_tpu_torch.ablate_nodenumber

Builds variants of ``csrc/select_hosts.cu``, each the source as it stands
with one part of ``nodenumber_select_hosts_kernel`` cut out, into
``_build/ablate/`` (one ``nvcc`` per variant, all started together), and
times each variant's fused entry point on wave 0 of the headline run
(P = 8,192, N = 10,112): a CUDA graph of 20 launches replayed between two
events, the variants in turns, 15 rounds, median.  Variants:

* ``full``: the kernel as it is (checked equal to the plain twin);
* ``no_rows``: staging and the pod half, no row walks the node bitmaps;
* ``no_hash``: the row walk with an xor in place of ``mix32``;
* ``no_pod_half``: made-up row states in place of the toleration reads;
* ``empty``: the kernel returns at once (the launch alone).

The differences between them attribute the time: ``full - no_rows`` is
the row walk, ``full - no_hash`` the hashing, ``no_rows - empty`` the
staging and pod half.  A patch that no longer matches the source raises.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
from pathlib import Path
from typing import Callable, Dict

import torch

from minisched_tpu_torch import resolve_device
from minisched_tpu_torch.headline import WAVE, mk_cluster
from minisched_tpu_torch.models import tables
from minisched_tpu_torch.ops import kernels
from minisched_tpu_torch.plugins.nodeunschedulable import (
    _EMPTY_VALUE_HASH,
    _UNSCHED_KEY_HASH,
)
from minisched_tpu_torch.utils import build

ROUNDS, BATCH = 15, 20

# (old, new) replacements in the source, per variant
PATCHES = {
    "full": (),
    "no_rows": ((
        "        if (!(st.flags & kLive) || (pass == 1 && !(st.flags & kSecond))) {",
        "        if (true) {",
    ),),
    "no_hash": ((
        "        const unsigned hj = mix32(st.seed, static_cast<unsigned>(node));",
        "        const unsigned hj = static_cast<unsigned>(node) ^ st.seed;",
    ),),
    "no_pod_half": ((
        "  init_rows(a, r0, nrows, state, lane, warp);",
        "  for (int r = threadIdx.x; r < nrows; r += kNnThreads) {\n"
        "    state[r] = RowState{kNoHash, kNone, (r0 + r) % 10, 77u * r, kLive};\n"
        "  }",
    ),),
    "empty": ((
        "  const int N = a.N;\n",
        "  const int N = a.N;\n  if (N >= 0) return;\n",
    ),),
}


def build_variants(out: Path) -> Dict[str, Callable]:
    """{variant: its fused C entry point}, built from patched sources."""
    source = (build.CSRC / "select_hosts.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for name, patches in PATCHES.items():
        text = source
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: patch no longer matches: {old!r}")
            text = text.replace(old, new)
        src = out / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.COMPILE_FLAGS, "-shared", str(src), "-o",
             str(out / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).minisched_nodenumber_select_hosts
        fn.argtypes = kernels._SIGNATURES["minisched_nodenumber_select_hosts"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    device = resolve_device(None)
    fns = build_variants(build.build_dir() / "ablate")
    nodes, pods = mk_cluster(10_000, WAVE)
    nt, _ = tables.build_node_table(nodes, device=device)
    pt, _ = tables.build_pod_table(pods, capacity=WAVE, device=device)
    P, N = int(pt.valid.shape[0]), int(nt.valid.shape[0])
    T = int(pt.tol_key.shape[1])

    def call(fn):
        choice = torch.empty(P, dtype=torch.int32, device=device)
        best = torch.empty_like(choice)
        err = fn(nt.unschedulable.data_ptr(), nt.suffix.data_ptr(),
                 nt.valid.data_ptr(), N, pt.suffix.data_ptr(),
                 pt.seed.data_ptr(), pt.valid.data_ptr(), pt.tol_key.data_ptr(),
                 pt.tol_value.data_ptr(), pt.tol_effect.data_ptr(),
                 pt.tol_op.data_ptr(), pt.tol_empty_key.data_ptr(),
                 pt.num_tols.data_ptr(), T, P, 10, _UNSCHED_KEY_HASH,
                 _EMPTY_VALUE_HASH, tables.EFFECT_NONE,
                 tables.EFFECT_NO_SCHEDULE, tables.TOLERATION_OP_EXISTS_CODE,
                 choice.data_ptr(), best.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return choice, best

    want = kernels.nodenumber_select_hosts_plain(pt, nt)
    got = call(fns["full"])
    torch.cuda.synchronize(device)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("the full variant differs from the plain twin")

    graphs = {}
    for name, fn in fns.items():
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(3):
                call(fn)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(BATCH):
                call(fn)
        graphs[name] = graph
    times = {name: [] for name in graphs}
    order = list(graphs)
    for rnd in range(ROUNDS):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            graphs[name].replay()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[name].replay()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / BATCH)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    med = {name: statistics.median(ts) for name, ts in times.items()}
    for name, ts in times.items():
        print(f"{name:12s} median {med[name]:.5f} ms  (min {min(ts):.5f}, "
              f"max {max(ts):.5f})")
    print(f"row walk {med['full'] - med['no_rows']:.5f} ms, of which hashing "
          f"{med['full'] - med['no_hash']:.5f} ms; staging + pod half "
          f"{med['no_rows'] - med['empty']:.5f} ms, of which the pod half "
          f"{med['full'] - med['no_pod_half']:.5f} ms; launch "
          f"{med['empty']:.5f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
