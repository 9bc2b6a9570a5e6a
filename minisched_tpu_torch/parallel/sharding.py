"""Device-mesh sharding for the batch evaluator.

Counterpart of ``minisched_tpu/parallel/sharding.py``.  The scaling axes
of this domain are the pod and node dimensions of the (pods × nodes)
scheduling planes.  A mesh is a 2-D grid of ``torch.device``:

* ``"pods"``  — data-parallel: a wave's pod rows split across the grid's
  rows; per-pod decisions need no collective across them;
* ``"nodes"`` — model-parallel: the node table splits across the grid's
  columns; every per-pod reduction over the node axis is merged across
  the node shards.

JAX's mesh is single-controller: one process holds a ``Mesh`` and GSPMD
partitions one program over it, inserting a collective for every
reduction over a sharded axis.  The port is single-controller too, but
nothing inserts the collectives: each (pod shard, node shard) tile is
evaluated by the plugin chain on its own device, in a thread of its own
(the tiles take turns, handing the turn over at each merge), and every
reduction over the node axis goes through one of the helpers
below (``node_max``, ``node_min``, ``node_sum``, ``node_any``,
``node_matmul``, ``node_cat``, and ``merge_select`` for the argmax
tail).  The node
shards of one pod shard meet there, as the ranks of one collective do:
each hands in its partial, the partials are merged on the pod shard's
lead device (an explicit ``.to(device)``, never an assumption that the
shards share one), and each gets the merged value back on its own
device.  Off a mesh (no tile running on the calling thread) every helper
is the identity.  Integer merges are exact; the domain sums are float64
sums of 0/1 counts, exact below 2^53, so placements are bit-identical to
the mesh-off path.  The merges sit at every node-axis reduction of the
chain: the normalizes' per-pod min and max (``plugins/normalize.py``,
``plugins/tainttoleration.py``), ImageLocality's node counts and largest
image sizes, PodTopologySpread's domain sums and minima and its soft
``worst``, ``fused.evaluate``'s feasible count, the diagnostics' ``any``,
and the argmax (``ops/kernels.select_hosts`` with the shard's
``node_base``, merged by ``select_hosts_merge``).  A chain whose node
shards reach different merges in different orders raises (the ranks
diverged), never merges the wrong partials.

Under a mesh the hand kernel runs on every node shard; JAX takes its XLA
tail instead (``minisched_tpu/ops/fused.py:159-165``): placements are
identical, by design.

The steps (``sharded_repair_step``, ``sharded_scan_step``,
``sharded_wave_step``): a repair wave evaluates every tile, merges each
pod shard's reductions and argmax over its node shards, gathers every pod
shard's choices on the lead device (the accept rule runs over the whole
wave), and commits each accepted pod's use into the node shard that owns
its node.  The scan lanes walk pods in order, so only the node axis
splits (the scan layout: pods replicated, one tile per node shard on the
grid's first row, each carrying its own shard of the scan state; the
blocked lane's accept rule reads the node columns gathered by
``node_cat``).  When the tiles share one device, one step of all of them
is captured in a CUDA graph and replayed, as the mesh-off lanes' step
is.  A virtual mesh repeats one device (``make_mesh(8, devices=[d] *
8)``): every line of the sharded path runs, the copies are no-ops and
nothing runs faster.

Across processes (JAX's hosts on the pod axis, ``:91-108``): under a
``parallel.distributed`` group, ``make_mesh(devices=...)`` takes each
process's own devices and spans the group, host major, one pod shard a
process by default (``Mesh.rows``: the ones this process owns).  The
one-shot steps run SPMD, as GSPMD runs JAX's under
``jax.distributed``: each process evaluates its own pod shards' tiles
(every node-axis merge stays inside it), the rows' ``choice`` (and
``best``, and the diagnostics' masks) cross processes through
``distributed.gather_pod_rows``, and the accept rule, the commits and
the next round run alike on every process, each on its own copy of the
node shards.  The scan lanes replicate the pod axis, so each process
runs the scan layout on its own first row, with no exchange.  The live
engine stays one process (it refuses such a mesh) and ``resolve_mesh``
stays local.

Left out:

* ``_CompiledShardedStep``'s jit-cache heal (JAX ``:259-393``): it
  recompiles a GSPMD executable that a poisoned jit cache dispatched
  with the wrong buffer count.  The port compiles nothing per signature;
  its tiles call the same eager functions as the mesh-off path;
* a node shard spanning processes (a pinned ``pod_shards`` that is not
  a multiple of the processes raises), and a live engine across
  processes: JAX's has none (it is one process, fetching each wave with
  ``jax.device_get``, ``minisched_tpu/engine/device_scheduler.py:2090``);
* the engine runs its blocked scan lane unsharded inside a mesh engine
  (as the JAX engine's tests pin it, ``tests/test_device_scheduler.py:
  368-373``); ``BlockedSequentialScheduler(mesh=)`` runs it in the scan
  layout.
"""

from __future__ import annotations

import functools
import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from dataclasses import dataclass, fields, replace
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from minisched_tpu_torch.parallel import distributed
from minisched_tpu_torch.parallel.distributed import gather_pod_rows

POD_AXIS = "pods"
NODE_AXIS = "nodes"

#: seconds a tile waits for its turn before it gives up (a peer that
#: hung without raising)
TURN_TIMEOUT_S = 600.0


class Mesh:
    """A 2-D grid of ``torch.device``: rows are pod shards, columns node
    shards.  ``shape`` maps each axis name to its size, as JAX's does.

    Across processes (``group``: a ``torch.distributed`` group) the grid
    is the whole mesh, host major, and ``rows`` are the pod shards this
    process owns (every process as many), whose devices are its own; the
    other rows' entries name their owners' devices and are never touched
    here.  Off a group this process owns every row."""

    axis_names = (POD_AXIS, NODE_AXIS)

    def __init__(self, grid: Sequence[Sequence[Any]], group: Any = None,
                 rows: Optional[Sequence[int]] = None):
        grid_rows = [[torch.device(d) for d in row] for row in grid]
        if not grid_rows or not grid_rows[0] or any(
                len(r) != len(grid_rows[0]) for r in grid_rows):
            raise ValueError("a mesh needs a non-empty rectangular grid")
        self.devices: List[List[torch.device]] = grid_rows
        #: the process group the mesh spans (None: this process alone)
        self.group = group
        #: the pod shards this process evaluates, in order
        self.rows: List[int] = (list(range(len(grid_rows))) if rows is None
                                else list(rows))
        if not self.rows or any(not 0 <= i < len(grid_rows)
                                for i in self.rows):
            raise ValueError(f"rows {self.rows} are not pod shards of a "
                             f"{len(grid_rows)}-row grid")
        #: what the exchanges across processes cost (``gather_pod_rows``)
        self.gather_stats = distributed.GatherStats()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._run_lock = threading.Lock()

    @property
    def spans_processes(self) -> bool:
        return self.group is not None

    @property
    def process_count(self) -> int:
        """The processes the mesh spans (1 off a group)."""
        return (len(self.devices) // len(self.rows)
                if self.group is not None else 1)

    @property
    def lead(self) -> torch.device:
        """This process's lead device: its first row's first device, where
        a step gathers the whole wave."""
        return self.devices[self.rows[0]][0]

    def node_device(self, j: int) -> torch.device:
        """Where this process keeps node shard ``j`` (its first row's
        device of column ``j``)."""
        return self.devices[self.rows[0]][j]

    @property
    def shape(self) -> Dict[str, int]:
        return {POD_AXIS: len(self.devices), NODE_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def device(self, i: int, j: int) -> torch.device:
        """The device of tile (pod shard ``i``, node shard ``j``)."""
        return self.devices[i][j]

    def __repr__(self) -> str:
        procs = (f", {self.process_count} processes, rows {self.rows}"
                 if self.spans_processes else "")
        return (f"Mesh({self.shape[POD_AXIS]}x{self.shape[NODE_AXIS]}, "
                f"{[str(d) for row in self.devices for d in row]}{procs})")

    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=len(self.rows) * len(self.devices[0]),
                thread_name_prefix="mesh-tile")
        return self._pool


def mesh_shape_key(mesh: Optional[Mesh]) -> Tuple:
    """Hashable (axis, size) signature of a mesh; () off-mesh."""
    if mesh is None:
        return ()
    return tuple((name, int(size)) for name, size in mesh.shape.items())


def mesh_axis_sizes(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(pod-axis size, node-axis size); (1, 1) off-mesh."""
    if mesh is None:
        return 1, 1
    return int(mesh.shape[POD_AXIS]), int(mesh.shape[NODE_AXIS])


def cap_multiple(base: int, axis: int) -> int:
    """Table-capacity quantum under a mesh axis: a multiple of ``base``
    that divides evenly across the axis's shards (lcm: a 3-shard axis
    gets 384, not ragged tiles of 128)."""
    return base * axis // math.gcd(base, axis)


def visible_devices(device: Any = None) -> List[torch.device]:
    """The devices a mesh may span: every visible card for ``device`` None
    or a CUDA device, the one host for a CPU device."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_mesh(env: Optional[Dict[str, str]] = None,
                 device: Any = None) -> Optional[Mesh]:
    """The live engine's startup mesh policy (JAX ``:65-88``):

    * ``MINISCHED_MESH=0`` — never shard;
    * ``MINISCHED_MESH=1`` — a mesh over every visible device, even a
      degenerate 1-device one (same placements, the sharded path runs);
    * unset — a mesh exactly when more than one device is visible
      (``torch.cuda.device_count() > 1``);
    * anything else raises.

    ``MINISCHED_MESH_POD_SHARDS`` pins the pod-axis factoring.  ``device``
    is the engine's: a CPU engine sees one device (the host), a card
    engine every card."""
    env = env if env is not None else os.environ
    flag = env.get("MINISCHED_MESH", "")
    if flag == "0":
        return None
    if flag not in ("", "0", "1"):
        raise ValueError(f"MINISCHED_MESH must be '', '0' or '1', got {flag!r}")
    devices = visible_devices(device)
    if flag != "1" and len(devices) <= 1:
        return None
    if not devices:
        raise RuntimeError("MINISCHED_MESH=1: no CUDA device is visible")
    pod_shards = env.get("MINISCHED_MESH_POD_SHARDS", "")
    return make_mesh(pod_shards=int(pod_shards) if pod_shards else None,
                     devices=devices, local=True)


def default_pod_shards(n_devices: int, n_processes: int = 1) -> int:
    """The pod-axis size of the 2-D factoring (JAX ``:91-108``): with
    several processes dividing the devices, one pod shard each (the pod
    axis needs no collective); on one host the largest power of two
    <= sqrt(n) dividing n, so tiles stay near square."""
    if n_processes > 1 and n_devices % n_processes == 0:
        return n_processes
    shards = 1
    while shards * 2 <= math.isqrt(n_devices) and n_devices % (shards * 2) == 0:
        shards *= 2
    return shards


def make_mesh(n_devices: Optional[int] = None,
              pod_shards: Optional[int] = None,
              devices: Optional[Sequence[Any]] = None,
              local: bool = False) -> Mesh:
    """A (pods × nodes) mesh over the first ``n_devices`` of ``devices``
    (default: every visible card), ``pod_shards`` rows of them
    (default: ``default_pod_shards``).  A device repeated in ``devices``
    gives a virtual mesh, as the tests and the smoke build one.

    Under a process group of W > 1 ranks (``parallel.distributed``) and
    unless ``local``, ``devices`` are this process's own (every rank
    passes the same count L) and the mesh spans the group, as JAX's
    spans ``jax.process_count()`` processes (``:134-141``): W × L
    devices, host major, ``default_pod_shards(W * L, W)`` = W rows by
    default, one a process.  A pinned ``pod_shards`` must be a multiple
    of W (a pod shard's node shards never span processes).  ``local``
    keeps the mesh to this process's devices under a group too (the live
    engine's, ``resolve_mesh``)."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    devices = list(devices if devices is not None else visible_devices())
    if not devices:
        raise RuntimeError("no CUDA device is visible; pass devices=")
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, only {len(devices)} available")
    devices = devices[:n]
    n_procs = 1 if local else distributed.process_count()
    if n_procs > 1:
        return _process_mesh(devices, pod_shards, n_procs)
    if pod_shards is None:
        pod_shards = default_pod_shards(n)
    if n % pod_shards:
        raise ValueError(f"{n} devices not divisible by pod_shards={pod_shards}")
    width = n // pod_shards
    return Mesh([devices[r * width:(r + 1) * width]
                 for r in range(pod_shards)])


def _process_mesh(local: List[Any], pod_shards: Optional[int],
                  n_procs: int) -> Mesh:
    """``make_mesh`` across the group: every rank sends its roster and
    its ``pod_shards``, so every rank takes the same decision (and raises
    alike) before any step runs."""
    rank = distributed.process_index()
    rosters = distributed.all_gather_objects(
        ([str(d) for d in local], pod_shards))
    counts = [len(r) for r, _ in rosters]
    if len(set(counts)) != 1:
        raise ValueError(f"a mesh across processes needs the same device "
                         f"count on every rank, got {counts}")
    pins = {p for _, p in rosters}
    if len(pins) != 1:
        raise ValueError(f"the ranks pinned different pod_shards: "
                         f"{sorted(map(str, pins))}")
    n = n_procs * counts[0]
    if pod_shards is None:
        pod_shards = default_pod_shards(n, n_procs)
    if pod_shards % n_procs:
        raise ValueError(f"pod_shards={pod_shards} is not a multiple of the "
                         f"{n_procs} processes: a pod shard's node shards "
                         "would span processes")
    if n % pod_shards:
        raise ValueError(f"{n} devices not divisible by pod_shards={pod_shards}")
    width = n // pod_shards
    every = [d for roster, _ in rosters for d in roster]
    per_proc = pod_shards // n_procs
    return Mesh([every[r * width:(r + 1) * width] for r in range(pod_shards)],
                group=distributed.default_group(),
                rows=range(rank * per_proc, (rank + 1) * per_proc))


# ---------------------------------------------------------------------------
# layouts: which axis each column is split on (None: replicated)
# ---------------------------------------------------------------------------

#: (axis, dim): the column splits on ``axis`` along dimension ``dim``;
#: None: the column is whole on every tile
Placement = Optional[Tuple[str, int]]


def _table_sharding(table: Any, axis: str,
                    replicated: Sequence[str] = ()) -> Dict[str, Placement]:
    """Leading dim on ``axis``; fields in ``replicated`` whole (their
    leading dim is not the table's axis: the node table's profile
    planes)."""
    return {f.name: (None if f.name in replicated else (axis, 0))
            for f in fields(table) if f.name != "use"}


def pod_sharding(mesh: Mesh, table: Any) -> Dict[str, Placement]:
    return _table_sharding(table, POD_AXIS)


def node_sharding(mesh: Mesh, table: Any) -> Dict[str, Placement]:
    from minisched_tpu_torch.models.tables import NODE_PROFILE_COLS

    return _table_sharding(table, NODE_AXIS, replicated=NODE_PROFILE_COLS)


_AXIS_NAME = {"pods": POD_AXIS, "nodes": NODE_AXIS, None: None}


def _constraint_axes() -> Dict[str, Tuple[str, Optional[str]]]:
    from minisched_tpu_torch.models.constraints import CONSTRAINT_AXES

    return {name: (kind, _AXIS_NAME[role])
            for name, (kind, role) in CONSTRAINT_AXES.items()}


def constraint_sharding(mesh: Mesh, extra: Any) -> Dict[str, Placement]:
    """A wave's ConstraintTables: node-axis planes split with the node
    table on their last dim, per-pod rows with the pod table, small
    metadata whole (``models/constraints.CONSTRAINT_AXES``)."""
    axes = _constraint_axes()
    out: Dict[str, Placement] = {}
    for f in fields(extra):
        if f.name == "in_use":
            continue
        kind, axis = axes.get(f.name, ("first", POD_AXIS))
        out[f.name] = (None if kind == "rep"
                       else (axis, -1 if kind == "last" else 0))
    return out


def scan_constraint_sharding(mesh: Mesh, extra: Any) -> Dict[str, Placement]:
    """The scan layout: node-axis planes split, everything pod-indexed
    whole (the scan walks pods one row at a time)."""
    return {name: (p if p is not None and p[0] == NODE_AXIS else None)
            for name, p in constraint_sharding(mesh, extra).items()}


def static_col_shardings(mesh: Mesh, cols: Dict[str, Any]
                         ) -> Dict[str, Placement]:
    """A device-resident static node column: split on the node axis, the
    profile planes whole."""
    from minisched_tpu_torch.models.tables import NODE_PROFILE_COLS

    return {name: (None if name in NODE_PROFILE_COLS else (NODE_AXIS, 0))
            for name in cols}


def _view(t: Any, placement: Placement, ranges: Dict[str, Tuple[int, int]],
          device: torch.device) -> Any:
    """``t``'s part for a tile whose axes cover ``ranges`` (axis → (start,
    width)) on ``device``."""
    if not isinstance(t, torch.Tensor):
        return t
    if placement is not None and placement[0] in ranges:
        start, width = ranges[placement[0]]
        t = t.narrow(placement[1], start, width)
    return t.to(device).contiguous()


def place(obj: Any, layout: Dict[str, Placement],
          ranges: Dict[str, Tuple[int, int]], device: torch.device) -> Any:
    """A table or ConstraintTables cut to one tile's ``ranges`` by
    ``layout`` and moved to ``device``; host fields (``use``, ``in_use``)
    stay as they are (a superset of the used slots gives the same
    result, and every tile takes the same host-known branches)."""
    return replace(obj, **{name: _view(getattr(obj, name), p, ranges, device)
                           for name, p in layout.items()})


# ---------------------------------------------------------------------------
# node shards
# ---------------------------------------------------------------------------


@dataclass
class NodeShards:
    """A node table split on the node axis: shard j holds node rows
    ``[j * width, (j + 1) * width)`` on ``mesh.node_device(j)``, this
    process's first row (a tile of another pod shard moves it to its
    device, which is a no-op on a virtual mesh).  Across processes every
    process holds its own copy, and every one commits the same
    placements."""

    shards: List[Any]
    width: int

    @property
    def capacity(self) -> int:
        return self.width * len(self.shards)

    def base(self, j: int) -> int:
        return j * self.width


def shard_nodes(mesh: Mesh, nodes: Any) -> NodeShards:
    """``nodes`` split over the mesh's node axis; its capacity must divide
    the axis size (the builder quantizes it with ``cap_multiple``)."""
    _, ns = mesh_axis_sizes(mesh)
    cap = int(nodes.valid.shape[0])
    if cap % ns:
        raise ValueError(f"node capacity {cap} does not divide over "
                         f"{ns} node shards")
    width = cap // ns
    layout = node_sharding(mesh, nodes)
    return NodeShards([place(nodes, layout, {NODE_AXIS: (j * width, width)},
                             mesh.node_device(j)) for j in range(ns)], width)


def gather_nodes(shards: NodeShards, device: Any) -> Any:
    """The whole node table on ``device``."""
    from minisched_tpu_torch.models.tables import NODE_PROFILE_COLS

    first = shards.shards[0]
    device = torch.device(device)
    cols = {}
    for f in fields(first):
        if f.name in NODE_PROFILE_COLS:
            cols[f.name] = getattr(first, f.name).to(device)
        else:
            cols[f.name] = torch.cat([getattr(s, f.name).to(device)
                                      for s in shards.shards])
    return type(first)(**cols)


def shard_pods(mesh: Mesh, pods: Any) -> List[Any]:
    """The pod table split over the pod axis: shard i on its lead device
    ``mesh.device(i, 0)``, for the pod shards this process owns
    (``mesh.rows``: every one off a group)."""
    ps, _ = mesh_axis_sizes(mesh)
    cap = int(pods.valid.shape[0])
    if cap % ps:
        raise ValueError(f"pod capacity {cap} does not divide over "
                         f"{ps} pod shards")
    width = cap // ps
    layout = pod_sharding(mesh, pods)
    return [place(pods, layout, {POD_AXIS: (i * width, width)},
                  mesh.device(i, 0)) for i in mesh.rows]


def shard_tables(mesh: Mesh, pods: Any, nodes: Any
                 ) -> Tuple[List[Any], NodeShards]:
    """Place tables on the mesh: pods split on the pod axis, nodes on the
    node axis."""
    return shard_pods(mesh, pods), shard_nodes(mesh, nodes)


# ---------------------------------------------------------------------------
# tiles and the node-axis merges
# ---------------------------------------------------------------------------


def _to(x: Any, device: torch.device) -> Any:
    if isinstance(x, tuple):
        return tuple(_to(t, device) for t in x)
    return x.to(device)


class _Aborted(Exception):
    """Another tile of the run raised; this one stops where it waits."""


class _Ring:
    """The tiles of one ``run_tiles`` call take turns, one at a time, in
    tile order: a tile runs until it waits at a merge (or ends), then
    hands the turn to the next live tile.  The host half of a tile is
    Python that holds the interpreter lock anyway; taking turns hands the
    lock over directly at each merge instead of letting every waiting
    thread contend for it (a woken thread can otherwise wait out the
    interpreter's switch interval at every merge).  The devices still run
    the tiles' queued kernels side by side."""

    def __init__(self, keys: Sequence[Tuple[int, int]]):
        self.live = list(keys)
        self._sem = {k: threading.Semaphore(0) for k in keys}
        self.error: Optional[BaseException] = None

    def start(self) -> None:
        self._sem[self.live[0]].release()

    def wait(self, key: Tuple[int, int]) -> None:
        if not self._sem[key].acquire(timeout=TURN_TIMEOUT_S):
            raise RuntimeError(f"mesh tile {key} waited {TURN_TIMEOUT_S} s "
                               "for its turn")
        if self.error is not None:
            raise _Aborted()

    def hand_on(self, key: Tuple[int, int], finished: bool = False) -> None:
        k = self.live.index(key)
        if finished:
            self.live.remove(key)
            if not self.live:
                return
            nxt = self.live[k % len(self.live)]
        else:
            nxt = self.live[(k + 1) % len(self.live)]
        self._sem[nxt].release()

    def yield_turn(self, key: Tuple[int, int]) -> None:
        if len(self.live) > 1:
            self.hand_on(key)
            self.wait(key)

    def abort(self, err: BaseException) -> None:
        if self.error is None:
            self.error = err
        for sem in self._sem.values():
            sem.release()


class _NodeGroup:
    """The node shards of one pod shard: the ranks of its merges.  Only
    the tile holding the ring's turn touches it."""

    def __init__(self, n: int, lead: torch.device):
        self.n = n
        self.lead = lead
        self._count = [0] * n  # merges each rank has entered
        self._parts: Dict[int, List[Any]] = {}
        self._results: Dict[int, List[Any]] = {}  # merge → [value, unread]
        self.finished = 0

    def merge(self, rank: int, site: Any, x: Any,
              fn: Callable[[List[Any]], Any], device: torch.device,
              ring: _Ring, key: Tuple[int, int]) -> Any:
        m = self._count[rank]
        self._count[rank] += 1
        parts = self._parts.setdefault(m, [None] * self.n)
        parts[rank] = (site, fn, x)
        if all(p is not None for p in parts):
            sites = {p[0] for p in parts}
            if len(sites) != 1:
                raise RuntimeError(
                    f"node shards diverged: merges {sorted(map(str, sites))}")
            out = fn([_to(p[2], self.lead) for p in parts])
            del self._parts[m]
            self._results[m] = [out, self.n]
        while m not in self._results:
            if self.finished:
                raise RuntimeError("node shards diverged: a shard ended "
                                   f"before merge {m} ({site})")
            ring.yield_turn(key)
        entry = self._results[m]
        entry[1] -= 1
        if not entry[1]:
            del self._results[m]
        return _to(entry[0], device)


@dataclass
class _Tile:
    group: _NodeGroup
    rank: int
    node_base: int
    device: torch.device
    ring: _Ring
    key: Tuple[int, int]


_local = threading.local()


def current_tile() -> Optional[_Tile]:
    """The tile the calling thread evaluates, or None off a mesh."""
    return getattr(_local, "tile", None)


def node_base() -> int:
    """The global index of the calling tile's first node column (0 off a
    mesh)."""
    tile = current_tile()
    return 0 if tile is None else tile.node_base


def _merged(kind: str, x: Any, fn: Callable[[List[Any]], Any]) -> Any:
    tile = current_tile()
    if tile is None or tile.group.n == 1:
        return x
    first = x[0] if isinstance(x, tuple) else x
    site = (kind, tuple(first.shape), str(first.dtype))
    return tile.group.merge(tile.rank, site, x, fn, tile.device, tile.ring,
                            tile.key)


def _fold(op: Callable[[Any, Any], Any]) -> Callable[[List[Any]], Any]:
    return lambda parts: functools.reduce(op, parts)


def node_max(x: torch.Tensor) -> torch.Tensor:
    """The max over the node axis, given each shard's max ``x``."""
    return _merged("max", x, _fold(torch.maximum))


def node_min(x: torch.Tensor) -> torch.Tensor:
    """The min over the node axis, given each shard's min ``x``."""
    return _merged("min", x, _fold(torch.minimum))


def node_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the node axis, given each shard's sum ``x`` (in its
    dtype: an int32 sum wraps as the whole one would)."""
    return _merged("sum", x, _fold(torch.add))


def node_any(x: torch.Tensor) -> torch.Tensor:
    """The ``any`` over the node axis, given each shard's ``x``."""
    return _merged("any", x, _fold(torch.logical_or))


def node_cat(x: torch.Tensor) -> torch.Tensor:
    """The whole node axis (the last dim) from each shard's part, in
    shard order: the gather the blocked lane's accept rule reads."""
    return _merged("cat", x, lambda parts: torch.cat(parts, dim=-1))


def node_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` contracted over the node axis (``a``'s last, ``b``'s
    first dim: each shard's columns): the shards' products summed.  In
    float64 over 0/1 counts the sum is exact in any order."""
    return node_sum(a @ b)


def merge_select(choice: torch.Tensor, best: torch.Tensor,
                 seeds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole rows' (choice, best) from each node shard's
    ``select_hosts`` at its ``node_base`` (``kernels.select_hosts_merge``)."""
    from minisched_tpu_torch.ops.kernels import select_hosts_merge

    def fn(parts: List[Any]) -> Any:
        return select_hosts_merge([(c, b) for c, b, _s in parts], parts[0][2])

    out = _merged("select", (choice, best, seeds), fn)
    return out[0], out[1]


def run_tiles(mesh: Mesh, fn: Callable[[int, int], Any], node_width: int,
              rows: Optional[Sequence[int]] = None) -> Dict[Tuple[int, int], Any]:
    """``fn(i, j)`` for every tile of the pod shards ``rows`` (default:
    this process's, ``mesh.rows``) and every node shard, each in a thread
    of its own with its tile set (so the merges above meet across the
    node shards of pod shard i), on its device and on the calling
    thread's current stream there; the tiles take turns (``_Ring``).
    Returns {(i, j): result}.  A tile that raises stops the others at
    their next wait; its error is raised once every tile ended.  A 1 × 1
    mesh runs inline."""
    _, ns = mesh_axis_sizes(mesh)
    rows = list(mesh.rows) if rows is None else list(rows)
    keys = [(i, j) for i in rows for j in range(ns)]
    groups = {i: _NodeGroup(ns, mesh.device(i, 0)) for i in rows}
    ring = _Ring(keys)
    streams = {}
    for i, j in keys:
        dev = mesh.device(i, j)
        if dev.type == "cuda" and dev not in streams:
            streams[dev] = torch.cuda.current_stream(dev)
    inference = torch.is_inference_mode_enabled()

    def job(i: int, j: int) -> Any:
        dev = mesh.device(i, j)
        key = (i, j)
        _local.tile = _Tile(groups[i], j, j * node_width, dev, ring, key)
        try:
            ring.wait(key)
            with ExitStack() as stack:
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                    stack.enter_context(torch.cuda.stream(streams[dev]))
                if inference:
                    stack.enter_context(torch.inference_mode())
                out = fn(i, j)
            groups[i].finished += 1
            ring.hand_on(key, finished=True)
            return out
        except BaseException as err:
            ring.abort(err)
            raise
        finally:
            _local.tile = None

    if len(keys) == 1:
        ring.start()
        return {keys[0]: job(*keys[0])}
    with mesh._run_lock:
        pool = mesh._executor()
        futures = {key: pool.submit(job, *key) for key in keys}
        ring.start()
        out, errors = {}, []
        for key, fut in futures.items():
            try:
                out[key] = fut.result()
            except BaseException as err:  # noqa: BLE001 — re-raised below
                errors.append(err)
    if errors:
        raise ring.error if ring.error is not None else errors[0]
    return out


# ---------------------------------------------------------------------------
# the sharded steps
# ---------------------------------------------------------------------------


class _GatheredNodes:
    """The node columns the accept rule reads, whole on one device."""

    COLUMNS = ("req_cpu", "alloc_cpu", "req_mem", "alloc_mem", "req_eph",
               "alloc_eph", "req_pods", "alloc_pods")

    def __init__(self, shards: Sequence[Any], device: torch.device):
        for name in self.COLUMNS:
            setattr(self, name, torch.cat([getattr(s, name).to(device)
                                           for s in shards]))


def _pad_column(t: torch.Tensor) -> torch.Tensor:
    """``t`` with one zero column more on its last dim."""
    return torch.cat([t, t.new_zeros((*t.shape[:-1], 1))], dim=-1)


def _cat_to(parts: Sequence[torch.Tensor], device: torch.device,
            dim: int = 0) -> torch.Tensor:
    return torch.cat([p.to(device) for p in parts], dim=dim)


def _mesh_repair_wave_step(mesh: Mesh, pods: Any, nodes: NodeShards,
                           extra: Any, filter_plugins: Sequence[Any],
                           pre_score_plugins: Sequence[Any],
                           score_plugins: Sequence[Any], ctx: Any,
                           max_rounds: int, with_diagnostics: bool,
                           split_static: bool) -> Any:
    """``ops/repair.repair_wave_step`` over the mesh (see the module
    docstring); the same rounds, accept rule and commits, placements
    bit-identical.  Across processes each evaluates its own pod shards'
    tiles, the rows' choices (and the diagnostics' masks) are gathered by
    ``distributed.gather_pod_rows``, and the rest of the round runs alike
    on every process, on its own copy of the node shards."""
    from minisched_tpu_torch.ops.fused import (
        evaluate,
        precompute_static,
        unschedulable_plugin_masks,
    )
    from minisched_tpu_torch.ops.repair import (
        RepairResult,
        accept_placements,
        commit_volume_state,
    )
    from minisched_tpu_torch.ops.state import apply_placements, mount_slot_planes

    ps, ns = mesh_axis_sizes(mesh)
    lead = mesh.lead
    rows = mesh.rows
    P = int(pods.valid.shape[0])
    if P % ps:
        raise ValueError(f"pod capacity {P} does not divide over {ps} pod shards")
    Pw, W = P // ps, nodes.width
    pods = place(pods, pod_sharding(mesh, pods), {}, lead)
    names = {pl.name() for pl in filter_plugins}
    check_resources = "NodeResourcesFit" in names
    check_ports = "NodePorts" in names
    fam_limits: Tuple[Tuple[int, int], ...] = ()
    check_restr = False
    if extra is not None:
        extra = place(extra, constraint_sharding(mesh, extra), {}, lead)
        fam_limits = tuple(
            (pl.volume_family_index, pl.max_volumes) for pl in filter_plugins
            if getattr(pl, "volume_family_index", None) is not None)
        check_restr = any(getattr(pl, "enforces_volume_restrictions", False)
                          for pl in filter_plugins)
    track_vols = check_restr or bool(fam_limits)
    ex_layout = constraint_sharding(mesh, extra) if extra is not None else {}
    # the carried volume state, split with the node table
    vols: List[Dict[str, torch.Tensor]] = []
    if track_vols:
        slots = mount_slot_planes(extra)
        n_vol_rows = extra.vol_any.shape[0]
        for j in range(ns):
            dev = mesh.node_device(j)
            vols.append({f: getattr(extra, f).narrow(-1, j * W, W)
                         .to(dev).contiguous()
                         for f in ("vol_any", "vol_rw", "node_vols_fam")})

    def tile_pods(p: Any, i: int, j: int) -> Any:
        return place(p, pod_sharding(mesh, p), {POD_AXIS: (i * Pw, Pw)},
                     mesh.device(i, j))

    def tile_nodes(i: int, j: int) -> Any:
        return place(nodes.shards[j], node_sharding(mesh, nodes.shards[j]),
                     {}, mesh.device(i, j))

    def tile_extra(i: int, j: int) -> Any:
        if extra is None:
            return None
        ex = place(extra, ex_layout, {POD_AXIS: (i * Pw, Pw),
                                      NODE_AXIS: (j * W, W)},
                   mesh.device(i, j))
        if track_vols:
            dev = mesh.device(i, j)
            carried = {f: t.to(dev) for f, t in vols[j].items()}
            if not fam_limits:
                carried.pop("node_vols_fam")
            ex = replace(ex, **carried)
        return ex

    statics: Dict[Tuple[int, int], Any] = {}
    if split_static:
        statics = run_tiles(mesh, lambda i, j: precompute_static(
            tile_pods(pods, i, j), tile_nodes(i, j), filter_plugins,
            pre_score_plugins, score_plugins, ctx, tile_extra(i, j)), W)

    committed = ~pods.valid  # padding rows never schedule
    final = torch.full((P,), -1, dtype=torch.int32, device=lead)
    rounds = 0
    pending = True
    while rounds < max_rounds:
        active_pods = replace(pods, valid=pods.valid & ~committed)
        results = run_tiles(mesh, lambda i, j: evaluate(
            tile_pods(active_pods, i, j), tile_nodes(i, j), filter_plugins,
            pre_score_plugins, score_plugins, ctx,
            static=statics.get((i, j)), extra=tile_extra(i, j)), W)
        choice = gather_pod_rows(mesh, [results[(i, 0)].choice for i in rows],
                                 lead)
        accept = accept_placements(
            _GatheredNodes(nodes.shards, lead), active_pods, choice,
            active_pods.valid, check_resources=check_resources,
            check_ports=check_ports,
            vol_state=([(extra.pod_vols_fam[:, f],
                         _cat_to([v["node_vols_fam"][f] for v in vols], lead),
                         mx) for f, mx in fam_limits]
                        if fam_limits else None),
            restr_state=((slots[1], slots[2], n_vol_rows)
                         if check_restr else None))
        # each accepted pod's use lands in the node shard owning its node
        for j in range(ns):
            dev = mesh.node_device(j)
            c, a = choice.to(dev), accept.to(dev)
            base = nodes.base(j)
            own = a & (c >= base) & (c < base + W)
            local = torch.where(own, c - base, -1).to(torch.int32)
            pods_j = place(active_pods, pod_sharding(mesh, active_pods),
                           {}, dev)
            nodes.shards[j] = apply_placements(nodes.shards[j], pods_j, local)
            if track_vols:
                # the slots that commit nothing write the dummy row where
                # mesh-off writes it: at the pod's node if it is accepted,
                # else at node 0 (shard 0's); a sink column past the shard
                # takes the writes of the pods another shard owns
                v = vols[j]
                sink = torch.where(a, W, 0) if base == 0 else W
                idx = torch.where(own, c - base, sink).long()
                fam, va, vr = commit_volume_state(
                    own, idx, tuple(s.to(dev) for s in slots),
                    extra.pod_missing.to(dev),
                    *(_pad_column(v[f]) for f in ("node_vols_fam",
                                                  "vol_any", "vol_rw")),
                    bool(fam_limits))
                v["node_vols_fam"], v["vol_any"], v["vol_rw"] = (
                    fam[..., :W], va[..., :W], vr[..., :W])
        final = torch.where(accept, choice, final)
        committed = committed | accept
        rounds += 1
        retryable = active_pods.valid & (choice >= 0) & ~accept
        progress = accept.any() & retryable.any()
        progress, pending = torch.stack([progress, (~committed).any()]).tolist()
        if not progress:
            break
    unsched = None
    if with_diagnostics:
        K = len(filter_plugins)
        unsched = torch.zeros((K, P), dtype=torch.bool, device=lead)
        if K and pending:
            losers = replace(pods, valid=pods.valid & ~committed)

            def diag(i: int, j: int) -> torch.Tensor:
                lp, tn = tile_pods(losers, i, j), tile_nodes(i, j)
                result = evaluate(lp, tn, filter_plugins, (), (), ctx,
                                  with_diagnostics=True,
                                  extra=tile_extra(i, j))
                valid = lp.valid[:, None] & tn.valid[None, :]
                return unschedulable_plugin_masks(result.filter_masks, valid)

            masks = run_tiles(mesh, diag, W)
            unsched = gather_pod_rows(mesh, [masks[(i, 0)] for i in rows],
                                      lead, dim=1)
    out_extra = None
    if extra is not None:
        out_extra = extra
        if track_vols:
            carried = {f: _cat_to([v[f] for v in vols], lead, dim=-1)
                       for f in ("vol_any", "vol_rw", "node_vols_fam")}
            if not fam_limits:
                carried.pop("node_vols_fam")
            out_extra = replace(extra, **carried)
    return RepairResult(gather_nodes(nodes, lead), final, rounds, unsched,
                        out_extra)


def _run_mesh_steps(mesh: Mesh, step: Callable[[Dict[str, torch.Tensor]], None],
                    state: Dict[str, torch.Tensor], n: int, log: Any) -> None:
    """Run a mesh scan's ``step`` ``n`` times: through
    ``sequential.run_steps`` when the grid's first row shares one device,
    else eagerly in a ``scan_replay`` span, keeping the same ``LoopStats``
    in ``log`` (steps, ``select_hosts`` launches a step; no replays)."""
    from minisched_tpu_torch.ops import kernels
    from minisched_tpu_torch.ops import sequential as seq

    _, ns = mesh_axis_sizes(mesh)
    if len({mesh.node_device(j) for j in range(ns)}) == 1:
        seq.run_steps(step, state, n, log)
        return
    if n <= 0:
        return
    stats = seq.LoopStats(steps=n)
    before = kernels.launch_counts["select_hosts"]
    with seq._span(log, "scan_replay"):
        for _ in range(n):
            step(state)
        for d in {mesh.node_device(j) for j in range(ns)}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
    stats.select_hosts_per_step = (
        kernels.launch_counts["select_hosts"] - before) // n
    if log is not None:
        log.loops.append(stats)


def _mesh_scan_schedule(mesh: Mesh, pods: Any, nodes: NodeShards,
                        extra: Any, filter_plugins: Sequence[Any],
                        pre_score_plugins: Sequence[Any],
                        score_plugins: Sequence[Any], ctx: Any,
                        log: Any = None
                        ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """``ops/sequential.scan_schedule`` in the scan layout: one tile per
    node shard (the grid's first row), each with its shard of the scan
    state.  A step runs every tile: its reductions and argmax merge
    across the tiles, and each commits the step's pod only where it owns
    the chosen node.  The round-invariant planes are computed once a
    call, as the blocked lane computes them (bit-identical: a plugin
    that reads no committed column and no carried plane gives each
    step's row what it gives the whole chunk).  When every tile is on
    one device (a virtual mesh) the steps go through
    ``sequential.run_steps``: one step of all the tiles is captured in a
    CUDA graph on a card and replayed, as the mesh-off scan's step is;
    over distinct devices each step runs eagerly.  ``log``: a
    ``sequential.StepLog``, kept either way (``_run_mesh_steps``)."""
    from minisched_tpu_torch.models.constraints import scan_use
    from minisched_tpu_torch.ops import sequential as seq
    from minisched_tpu_torch.ops.fused import (
        StaticWavePlanes,
        evaluate,
        precompute_static,
    )
    from minisched_tpu_torch.ops.state import apply_placements

    _, ns = mesh_axis_sizes(mesh)
    W = nodes.width
    lead = mesh.lead
    row = mesh.rows[0]
    needs = [pl.name() for pl in (*filter_plugins, *score_plugins)
             if getattr(pl, "needs_extra", False)]
    if needs and extra is None:
        raise ValueError(f"sequential scan with cross-pod plugins {needs} "
                         "needs the ConstraintTables — pass `extra`")
    tracked, scan_dynamic = seq._carried_planes(
        (*filter_plugins, *pre_score_plugins, *score_plugins))
    if extra is None:
        tracked = set()
    track_combos = "combos" in tracked
    track_vols = "volumes" in tracked
    P = int(pods.valid.shape[0])
    live = seq._live_rows(pods.valid)
    use = scan_use(extra.in_use) if extra is not None else None
    ex_layout = (scan_constraint_sharding(mesh, extra)
                 if extra is not None else {})

    def setup(_i: int, j: int) -> Dict[str, Any]:
        dev = mesh.node_device(j)
        base = nodes.base(j)
        pods_j = place(pods, pod_sharding(mesh, pods), {}, dev)
        extra_j = (place(extra, ex_layout, {NODE_AXIS: (base, W)}, dev)
                   if extra is not None else None)
        return {
            "pods": pods_j, "extra": extra_j, "base": base,
            "state": seq._initial_state(nodes.shards[j], extra_j,
                                        track_combos, track_vols, P,
                                        ("choice", "best")),
            "combos": (seq._ShardComboCommit(extra_j, base,
                                             extra.topo_domain.to(dev))
                       if track_combos else None),
            "volumes": seq._VolumeCommit(extra_j) if track_vols else None,
            "static": precompute_static(
                pods_j, nodes.shards[j], filter_plugins, pre_score_plugins,
                score_plugins, ctx, extra=extra_j,
                extra_dynamic=scan_dynamic),
        }

    tiles = run_tiles(mesh, setup, W, rows=[row])
    state = {f"{j}/{name}": t for j in range(ns)
             for name, t in tiles[(row, j)]["state"].items()}

    def tile_step(j: int, st: Dict[str, torch.Tensor]) -> None:
        t = tiles[(row, j)]
        s = {name: st[f"{j}/{name}"] for name in t["state"]}
        base = t["base"]
        i = s["i"]
        pod_row = seq.pod_rows(t["pods"], i)
        carry = seq._carried_nodes(nodes.shards[j], s)
        extra_i = (seq.extra_rows(t["extra"], i, s, use)
                   if t["extra"] is not None else None)
        static = t["static"]
        static_i = StaticWavePlanes(
            static.static_mask.index_select(0, i), static.static_names, {},
            {k: v.index_select(0, i) for k, v in static.raw_scores.items()})
        result = evaluate(pod_row, carry, filter_plugins, pre_score_plugins,
                          score_plugins, ctx, static=static_i, extra=extra_i)
        choice = result.choice  # (1,), the whole row's
        committed = choice >= 0
        n = choice.clamp(min=0).long()
        own = committed & (n >= base) & (n < base + W)
        local = torch.where(own, n - base, 0)
        if t["combos"] is not None:
            t["combos"].row(s, extra_i, n, committed)
        if t["volumes"] is not None:
            t["volumes"](s, i, extra_i.pod_missing, local, own)
        seq._store_nodes(s, apply_placements(
            carry, pod_row, torch.where(own, local, -1).to(torch.int32)))
        s["choice"].index_copy_(0, i, choice)
        s["best"].index_copy_(0, i, result.best_score)
        s["i"] += 1

    def step(st: Dict[str, torch.Tensor]) -> None:
        run_tiles(mesh, lambda _i, j: tile_step(j, st), W, rows=[row])

    _run_mesh_steps(mesh, step, state, live, log)
    shards = NodeShards([seq._carried_nodes(
        nodes.shards[j], {name: state[f"{j}/{name}"]
                          for name in tiles[(row, j)]["state"]})
        for j in range(ns)], W)
    return (gather_nodes(shards, lead), state["0/choice"].to(lead),
            state["0/best"].to(lead))


def _mesh_blocked_scan_schedule(mesh: Mesh, pods: Any, nodes: NodeShards,
                                extra: Any, filter_plugins: Sequence[Any],
                                pre_score_plugins: Sequence[Any],
                                score_plugins: Sequence[Any], ctx: Any,
                                block_size: int = 32, log: Any = None
                                ) -> Tuple[Any, torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """``ops/sequential.blocked_scan_schedule`` in the scan layout, as
    ``_mesh_scan_schedule`` runs the exact scan: a step evaluates one
    block on every node shard, gathers the node columns the accept rule
    reads (``node_cat``), runs the rule on every tile alike, and commits
    each accepted pod where its node lives."""
    from minisched_tpu_torch.models.constraints import scan_use
    from minisched_tpu_torch.ops import sequential as seq
    from minisched_tpu_torch.ops.fused import (
        StaticWavePlanes,
        evaluate,
        precompute_static,
    )
    from minisched_tpu_torch.ops.repair import accept_placements
    from minisched_tpu_torch.ops.state import apply_placements

    _, ns = mesh_axis_sizes(mesh)
    W = nodes.width
    lead = mesh.lead
    row = mesh.rows[0]
    P = int(pods.valid.shape[0])
    B = block_size
    if P % B:
        raise ValueError(f"pod capacity {P} not divisible by {B}")
    names = {pl.name() for pl in filter_plugins}
    check_resources = "NodeResourcesFit" in names
    check_ports = "NodePorts" in names
    fam_limits = tuple(
        (pl.volume_family_index, pl.max_volumes) for pl in filter_plugins
        if getattr(pl, "volume_family_index", None) is not None)
    check_restr = any(getattr(pl, "enforces_volume_restrictions", False)
                      for pl in filter_plugins)
    tracked, scan_dynamic = seq._carried_planes(
        (*filter_plugins, *pre_score_plugins, *score_plugins))
    track_combos = "combos" in tracked
    track_vols = "volumes" in tracked or bool(fam_limits) or check_restr
    use = scan_use(extra.in_use)
    ex_layout = scan_constraint_sharding(mesh, extra)
    steps = -(-seq._live_rows(pods.valid) // B)

    def setup(_i: int, j: int) -> Dict[str, Any]:
        dev = mesh.node_device(j)
        base = nodes.base(j)
        pods_j = place(pods, pod_sharding(mesh, pods), {}, dev)
        extra_j = place(extra, ex_layout, {NODE_AXIS: (base, W)}, dev)
        return {
            "pods": pods_j, "extra": extra_j, "base": base,
            "rows": torch.arange(B, device=dev),
            "state": seq._initial_state(nodes.shards[j], extra_j,
                                        track_combos, track_vols, P,
                                        ("choice", "best", "accepted")),
            "combos": (seq._ShardComboCommit(extra_j, base,
                                             extra.topo_domain.to(dev))
                       if track_combos else None),
            "volumes": seq._VolumeCommit(extra_j) if track_vols else None,
            "static": precompute_static(
                pods_j, nodes.shards[j], filter_plugins, pre_score_plugins,
                score_plugins, ctx, extra=extra_j,
                extra_dynamic=scan_dynamic),
        }

    tiles = run_tiles(mesh, setup, W, rows=[row])
    state = {f"{j}/{name}": t for j in range(ns)
             for name, t in tiles[(row, j)]["state"].items()}

    def tile_step(j: int, st: Dict[str, torch.Tensor]) -> None:
        t = tiles[(row, j)]
        s = {name: st[f"{j}/{name}"] for name in t["state"]}
        base, volumes, static = t["base"], t["volumes"], t["static"]
        rows = s["i"] * B + t["rows"]
        pod_block = seq.pod_rows(t["pods"], rows)
        carry = seq._carried_nodes(nodes.shards[j], s)
        extra_b = seq.extra_rows(t["extra"], rows, s, use)
        static_b = StaticWavePlanes(
            static.static_mask.index_select(0, rows), static.static_names,
            {}, {k: v.index_select(0, rows)
                 for k, v in static.raw_scores.items()})
        result = evaluate(pod_block, carry, filter_plugins,
                          pre_score_plugins, score_plugins, ctx,
                          extra=extra_b, static=static_b)
        choice = result.choice  # (B,), the whole rows'
        # the accept rule reads the chosen nodes' columns: the whole
        # roster's, gathered on every tile, which all decide alike
        whole = SimpleNamespace(**{
            name: node_cat(getattr(carry, name))
            for name in _GatheredNodes.COLUMNS})
        accept = accept_placements(
            whole, pod_block, choice, pod_block.valid,
            check_resources=check_resources, check_ports=check_ports,
            vol_state=([(extra_b.pod_vols_fam[:, f],
                         node_cat(s["node_vols_fam"][f]), mx)
                        for f, mx in fam_limits] if fam_limits else None),
            restr_state=((volumes.slot_vol.index_select(0, rows),
                          volumes.slot_ro.index_select(0, rows),
                          volumes.n_rows) if check_restr else None))
        committed = accept & (choice >= 0)
        n_b = choice.clamp(min=0).long()
        own = committed & (n_b >= base) & (n_b < base + W)
        local = torch.where(own, n_b - base, 0)
        if t["combos"] is not None:
            t["combos"].block(s, extra_b, n_b, committed)
        if volumes is not None:
            volumes(s, rows, extra_b.pod_missing, local, own)
        seq._store_nodes(s, apply_placements(
            carry, pod_block, torch.where(own, local, -1).to(torch.int32)))
        s["choice"].index_copy_(0, rows, choice)
        s["best"].index_copy_(0, rows, result.best_score)
        s["accepted"].index_copy_(0, rows, accept)
        s["i"] += 1

    def step(st: Dict[str, torch.Tensor]) -> None:
        run_tiles(mesh, lambda _i, j: tile_step(j, st), W, rows=[row])

    _run_mesh_steps(mesh, step, state, steps, log)
    shards = NodeShards([seq._carried_nodes(
        nodes.shards[j], {name: state[f"{j}/{name}"]
                          for name in tiles[(row, j)]["state"]})
        for j in range(ns)], W)
    return (gather_nodes(shards, lead), state["0/choice"].to(lead),
            state["0/best"].to(lead), state["0/accepted"].to(lead))


def _mesh_wave_step(mesh: Mesh, pods: Any, nodes: NodeShards, extra: Any,
                    filter_plugins: Sequence[Any],
                    pre_score_plugins: Sequence[Any],
                    score_plugins: Sequence[Any], ctx: Any
                    ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """``ops/state.wave_step`` over the mesh: evaluate every tile (across
    processes, this process's), gather the rows' choice and best, then
    commit each placement into the node shard owning its node."""
    from minisched_tpu_torch.ops.fused import evaluate
    from minisched_tpu_torch.ops.state import apply_placements

    ps, ns = mesh_axis_sizes(mesh)
    lead = mesh.lead
    P = int(pods.valid.shape[0])
    Pw, W = P // ps, nodes.width
    ex_layout = constraint_sharding(mesh, extra) if extra is not None else {}

    def tile(i: int, j: int) -> Any:
        dev = mesh.device(i, j)
        tp = place(pods, pod_sharding(mesh, pods), {POD_AXIS: (i * Pw, Pw)},
                   dev)
        tn = place(nodes.shards[j], node_sharding(mesh, nodes.shards[j]),
                   {}, dev)
        te = (place(extra, ex_layout, {POD_AXIS: (i * Pw, Pw),
                                       NODE_AXIS: (j * W, W)}, dev)
              if extra is not None else None)
        return evaluate(tp, tn, filter_plugins, pre_score_plugins,
                        score_plugins, ctx, extra=te)

    results = run_tiles(mesh, tile, W)
    choice = gather_pod_rows(mesh, [results[(i, 0)].choice
                                    for i in mesh.rows], lead)
    best = gather_pod_rows(mesh, [results[(i, 0)].best_score
                                  for i in mesh.rows], lead)
    for j in range(ns):
        dev = mesh.node_device(j)
        c = choice.to(dev)
        base = nodes.base(j)
        own = (c >= base) & (c < base + W)
        nodes.shards[j] = apply_placements(
            nodes.shards[j], place(pods, pod_sharding(mesh, pods), {}, dev),
            torch.where(own, c - base, -1).to(torch.int32))
    return gather_nodes(nodes, lead), choice, best


class MeshPackedCaller:
    """The mesh caller over the port's call form ``(pods, nodes, extra)``
    (the port has no ``call_packed``): it places the node table on the
    mesh — split on the node axis, or taken as the table builder's
    ``NodeShards`` — and runs ``consumer(mesh, pods, node_shards,
    extra, **kw)``, which cuts the pod table and the constraint tables
    per tile by the layout maps."""

    def __init__(self, consumer: Callable[..., Any], mesh: Mesh):
        self._consumer = consumer
        self.mesh = mesh

    def __call__(self, pods: Any, nodes: Any, extra: Any = None,
                 **kw: Any) -> Any:
        shards = (nodes if isinstance(nodes, NodeShards)
                  else shard_nodes(self.mesh, nodes))
        return self._consumer(self.mesh, pods, shards, extra, **kw)


def _step(fn: Callable[..., Any], filter_plugins, pre_score_plugins,
          score_plugins, ctx, **kw) -> Callable[..., Any]:
    chains = (tuple(filter_plugins), tuple(pre_score_plugins),
              tuple(score_plugins))

    def consume(mesh: Mesh, pods: Any, nodes: NodeShards, extra: Any,
                **call_kw: Any) -> Any:
        return fn(mesh, pods, nodes, extra, *chains, ctx, **kw, **call_kw)

    return consume


def sharded_repair_step(mesh: Mesh, filter_plugins, pre_score_plugins,
                        score_plugins, ctx, max_rounds: int = 16,
                        with_diagnostics: bool = False,
                        split_static: bool = True) -> MeshPackedCaller:
    """The conflict-repair wave loop over ``mesh``: ``step(pods, nodes,
    extra=None)`` → ``ops.repair.RepairResult`` (the final node table
    gathered on the lead device)."""
    return MeshPackedCaller(_step(
        _mesh_repair_wave_step, filter_plugins, pre_score_plugins,
        score_plugins, ctx, max_rounds=max_rounds,
        with_diagnostics=with_diagnostics, split_static=split_static), mesh)


def sharded_scan_step(mesh: Mesh, filter_plugins, pre_score_plugins,
                      score_plugins, ctx) -> MeshPackedCaller:
    """The bind-exact sequential scan over ``mesh``'s node axis:
    ``step(pods, nodes, extra=None)`` → (nodes, choice, best)."""
    return MeshPackedCaller(_step(
        _mesh_scan_schedule, filter_plugins, pre_score_plugins,
        score_plugins, ctx), mesh)


def sharded_wave_step(mesh: Mesh, filter_plugins, pre_score_plugins,
                      score_plugins, ctx) -> MeshPackedCaller:
    """Evaluate + commit over ``mesh``: ``step(pods, nodes, extra=None)``
    → (nodes, choice, best)."""
    return MeshPackedCaller(_step(
        _mesh_wave_step, filter_plugins, pre_score_plugins, score_plugins,
        ctx), mesh)
