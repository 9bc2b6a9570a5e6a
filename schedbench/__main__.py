"""``python3 -m schedbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell of ``BENCHMARK.json`` on the card.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, in a traced run
``breakdown``, and last ``check``: each number compared beside its
limit); the last lines of standard error repeat the numbers compared.
Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result; so it does when ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: the program's build and kernel caches, at fixed paths in the checkout:
#: only a checkout's first run builds
CACHE = ROOT / ".schedbench-cache"

#: top-level module names that must not be loaded in the measured process
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "minisched_tpu"})


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden
    (``minisched_tpu_torch`` is not ``minisched_tpu``)."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def _open_card() -> None:
    """Initialise the CUDA driver and retain device 0's primary context
    (the one PyTorch then uses) through the driver API.  The driver's
    first open of the card takes seconds, and ``ctypes`` releases the
    interpreter lock while it runs, so it overlaps the imports; a machine
    without the driver leaves it to the card check below."""
    import ctypes

    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return
    cuda.cuInit.argtypes = [ctypes.c_uint]
    cuda.cuInit.restype = ctypes.c_int
    cuda.cuDeviceGet.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    cuda.cuDeviceGet.restype = ctypes.c_int
    cuda.cuDevicePrimaryCtxRetain.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
    cuda.cuDevicePrimaryCtxRetain.restype = ctypes.c_int
    dev, ctx = ctypes.c_int(), ctypes.c_void_p()
    if cuda.cuInit(0) == 0 and cuda.cuDeviceGet(ctypes.byref(dev), 0) == 0:
        cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="schedbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the card is opened while the interpreter imports the program; the
    # engine joins this thread before it starts
    card = threading.Thread(target=_open_card, name="cuda-open")
    card.start()

    os.environ["MINISCHED_CACHE_DIR"] = str(CACHE / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

    from schedbench.spec import find_cell

    cell = find_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"schedbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); torch sees {seen}", file=sys.stderr)
        card.join()
        return 2

    from schedbench.harness import Run, check_counts, result_line

    run = Run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
              T_START, context=card)
    run.run()
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"schedbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 2
    counts = check_counts(run)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": run.rec.memory_peak_bytes}
    line = result_line(run, counts, device)
    print("setup phases: " + ", ".join(
        f"{name} {secs:.3f} s" for name, secs in run.rec.setup_phases),
        file=sys.stderr)
    print(f"client deletes: {run.rec.deletes} pods in "
          f"{run.rec.delete_s:.3f} s", file=sys.stderr)
    ends = [t - run.rec.t0 for t in run.rec.completions]
    print("rollouts completed at (s from the window's start): "
          + ", ".join(f"{t:.3f}" for t in ends), file=sys.stderr)
    if run.rec.trace_s:
        print("trace: " + ", ".join(f"{k} {v:.3f} s"
                                    for k, v in run.rec.trace_s.items()),
              file=sys.stderr)
    for name, entry in line["check"].items():
        print(f"check {name} {entry['value']} limit {entry['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
