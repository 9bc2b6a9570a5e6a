"""Processes of one mesh: the counterpart of ``jax.distributed``.

JAX's ``make_mesh`` reads ``jax.process_count()`` when it is given the
whole device roster (``minisched_tpu/parallel/sharding.py:134-141``) and
puts one process on each pod shard, each process's chips on the node axis
(``default_pod_shards``, ``:91-108``: "the inter-host DCN link only moves
the final per-pod results").  The port's processes form a
``torch.distributed`` group with the ``gloo`` backend, and the pod rows
they exchange travel as host tensors: a repair round's ``choice`` (P
int32s), the wave step's ``best`` beside it, the diagnostics' K x P
bools.  Every node-axis merge stays inside one process, in the tile
threads of ``parallel/sharding.py``; ``gather_pod_rows`` is the one
exchange across processes, the counterpart of JAX's DCN hop.

* ``initialize`` / ``shutdown``: the group (``jax.distributed.initialize``):
  from torchrun's variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or an explicit ``init_method``, always with a timeout;
* ``process_count`` / ``process_index``: 1 and 0 without a group;
* ``gather_pod_rows``: this process's pod rows in, the whole wave out;
* ``spawn``: ``n`` processes of one group on this host (the tests and
  ``chip_smoke.py`` phase 36), joined against one deadline.

The JAX package's live engine is one process (it fetches each wave with
``jax.device_get``, ``minisched_tpu/engine/device_scheduler.py:2090``),
and so is the port's: a mesh across processes drives the one-shot steps
only (``sharded_repair_step``, ``sharded_wave_step``, the scan lanes).
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import pickle
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch

#: seconds a collective of the group waits for its peers before it raises
DEFAULT_TIMEOUT_S = 300.0
#: torchrun's variables: ``initialize()`` without an ``init_method`` reads
#: them (through ``env://``)
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
    """Start this process's group (``gloo``) and return it.  Without
    ``init_method`` torchrun's variables name the rendezvous, the world
    size and the rank (each missing one raises); with it, ``world_size``
    and ``rank`` must be given (``file://<path>`` or
    ``tcp://localhost:<port>``)."""
    dist = _dist()
    if is_initialized():
        raise RuntimeError("a process group is already initialized")
    if init_method is None:
        missing = [k for k in TORCHRUN_VARS if not os.environ.get(k)]
        if missing:
            raise RuntimeError(f"initialize(): no init_method, and torchrun's "
                               f"{', '.join(missing)} unset")
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None \
            else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
    elif world_size is None or rank is None:
        raise ValueError("initialize(init_method=...) needs world_size and "
                         "rank")
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return dist.group.WORLD


def shutdown() -> None:
    """Leave the group (nothing without one)."""
    if is_initialized():
        _dist().destroy_process_group()


def process_count() -> int:
    """The group's world size (``jax.process_count()``); 1 without one."""
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's rank (``jax.process_index()``); 0 without a group."""
    return _dist().get_rank() if is_initialized() else 0


def default_group() -> Any:
    """The group ``initialize`` started (None without one)."""
    return _dist().group.WORLD if is_initialized() else None


def all_gather_objects(obj: Any, group: Any = None) -> List[Any]:
    """Every rank's ``obj``, in rank order (``make_mesh``'s roster check);
    ``[obj]`` without a group."""
    if not is_initialized():
        return [obj]
    dist = _dist()
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


@dataclass
class GatherStats:
    """What ``gather_pod_rows`` spent across processes for one mesh
    (``Mesh.gather_stats``) since the last ``reset``: calls; ``wait_s``,
    the copy of this process's rows to the host, which waits for the
    device to finish the work that made them; ``exchange_s``, the
    ``all_gather`` (which also waits for the slowest rank) and the copy
    back; bytes this process sent."""

    calls: int = 0
    wait_s: float = 0.0
    exchange_s: float = 0.0
    bytes_sent: int = 0

    def reset(self) -> None:
        self.calls = self.bytes_sent = 0
        self.wait_s = self.exchange_s = 0.0


def gather_pod_rows(mesh: Any, parts: Sequence[torch.Tensor], device: Any,
                    dim: int = 0) -> torch.Tensor:
    """The whole wave's tensor on ``device``, from this process's pod rows:
    ``parts[k]`` belongs to pod shard ``mesh.rows[k]``, and the result is
    every pod shard's part concatenated along ``dim`` in pod-shard order.
    Without a group (``mesh.group`` None) the parts are every row's and
    are concatenated on ``device``.  Across processes the rows are host
    major (rank r owns a block of rows), so the ranks' blocks, gathered in
    rank order, are in pod-shard order: this process's block is copied to
    the host, ``all_gather``-ed (bools as uint8) and copied back, and the
    time it took lands in ``mesh.gather_stats``."""
    device = torch.device(device)
    if getattr(mesh, "group", None) is None:
        return torch.cat([p.to(device) for p in parts], dim=dim)
    t0 = time.monotonic()
    local = torch.cat([p.to("cpu") for p in parts], dim=dim)
    t1 = time.monotonic()
    dtype = local.dtype
    send = (local.to(torch.uint8) if dtype == torch.bool else local).contiguous()
    out = [torch.empty_like(send) for _ in range(mesh.process_count)]
    _dist().all_gather(out, send, group=mesh.group)
    whole = torch.cat(out, dim=dim)
    if dtype == torch.bool:
        whole = whole.bool()
    whole = whole.to(device)
    if whole.device.type == "cuda":
        torch.cuda.current_stream(whole.device).synchronize()
    stats = mesh.gather_stats
    stats.calls += 1
    stats.wait_s += t1 - t0
    stats.exchange_s += time.monotonic() - t1
    stats.bytes_sent += send.numel() * send.element_size()
    return whole


# ---------------------------------------------------------------------------
# spawn: n processes of one group on this host
# ---------------------------------------------------------------------------


class SpawnError(RuntimeError):
    """A spawned rank failed: it raised, exited non-zero, left no result,
    or was still running at the deadline.  ``ranks`` maps each rank to
    its exit code (None: killed at the deadline) and ``tracebacks`` each
    rank that raised to its traceback."""

    def __init__(self, message: str, ranks: dict, tracebacks: dict):
        super().__init__(message)
        self.ranks = ranks
        self.tracebacks = tracebacks


def _child(rank: int, n: int, workdir: str, target: Callable[..., Any],
           args: tuple, timeout_s: float) -> None:
    # every rank of a spawned group is on this host: gloo on the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        initialize(init_method=f"file://{workdir}/rendezvous", world_size=n,
                   rank=rank, timeout_s=timeout_s)
        result = target(*args)
        tmp = os.path.join(workdir, f"result-{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(workdir, f"result-{rank}.pkl"))
    except BaseException:  # noqa: BLE001 — reported to the parent, exit 1
        with open(os.path.join(workdir, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        shutdown()


def spawn(n: int, target: Callable[..., Any], args: tuple = (),
          timeout_s: float = 120.0) -> List[Any]:
    """Run ``target(*args)`` in ``n`` new processes (the ``spawn`` start
    method: each re-imports the module that holds ``target``, which must
    be importable by name), ranks 0..n-1 of one group initialized from a
    ``file://`` rendezvous in a temporary directory (no port to choose).
    Returns each rank's result, in rank order (pickled: return host
    values).  The processes are joined against one deadline,
    ``timeout_s`` from the start: when a rank exits non-zero or the
    deadline passes, every rank still running is killed and
    ``SpawnError`` raises with each rank's exit code and traceback."""
    if n < 1:
        raise ValueError(f"spawn needs n >= 1, got {n}")
    ctx = multiprocessing.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="minisched-spawn-")
    procs = [ctx.Process(target=_child, name=f"rank{r}",
                         args=(r, n, workdir, target, args, timeout_s))
             for r in range(n)]
    deadline = time.monotonic() + timeout_s
    failure = ""
    try:
        for p in procs:
            p.start()
        while True:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                failure = "a rank failed"
                break
            if all(c == 0 for c in codes):
                break
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"the deadline of {timeout_s:g} s passed"
                break
            multiprocessing.connection.wait(
                [p.sentinel for p in procs if p.exitcode is None],
                timeout=min(left, 1.0))
        codes = {}
        for r, p in enumerate(procs):
            if p.exitcode is None:
                p.kill()
                p.join(10)
                codes[r] = None
            else:
                codes[r] = p.exitcode
        tracebacks = {}
        results = []
        for r in range(n):
            err = os.path.join(workdir, f"error-{r}.txt")
            if os.path.exists(err):
                with open(err) as f:
                    tracebacks[r] = f.read()
            out = os.path.join(workdir, f"result-{r}.pkl")
            if not failure and not os.path.exists(out):
                failure = f"rank {r} exited 0 without a result"
            if not failure:
                with open(out, "rb") as f:
                    results.append(pickle.load(f))
        if failure:
            lines = [f"spawn of {n} ranks: {failure}"]
            for r in range(n):
                code = codes[r]
                state = ("killed (still running)" if code is None
                         else f"exit code {code}")
                lines.append(f"rank {r}: {state}")
                if r in tracebacks:
                    lines.append(tracebacks[r].rstrip())
            raise SpawnError("\n".join(lines), codes, tracebacks)
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(workdir, ignore_errors=True)
