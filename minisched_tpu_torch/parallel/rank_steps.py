"""One rank's one-shot steps over a mesh across processes.

``run_rank`` is the target each process of ``distributed.spawn`` runs in
``chip_smoke.py`` phase 36 and in the tests: it loads the tables a file
holds (written by ``save_inputs``), builds ``make_mesh(devices=[device] *
n_local)`` under the group (W processes: a W x n_local mesh, one pod
shard a process) and runs each step the file names:

* ``"repair"``: a full-roster repair wave with diagnostics
  (``RepairingEvaluator(mesh=)``), ``warm`` times untimed and once timed;
* ``"step"``: ``sharded_wave_step`` over the file's chain (``"full"``, or
  ``"nodenumber"``: NodeUnschedulable, then NodeNumber);
* ``"scan"``: the full-roster exact scan in the scan layout
  (``SequentialScheduler(mesh=)``).

It returns host values: each step's outputs (choices, best scores,
rounds, masks, every final node-table column, the carried volume
planes), its wall, the seconds and calls of ``distributed.gather_pod_rows``
(``Mesh.gather_stats``),
and the ``select_hosts`` launches and plain-twin calls of this process,
counted from 0 before the step, beside the engine's refusal of the mesh.
"""

from __future__ import annotations

import time
from dataclasses import fields, replace
from typing import Any, Dict, Optional, Tuple

import torch

from minisched_tpu_torch.parallel import distributed

#: the carried volume planes a repair wave hands back with its tables
CARRIED = ("vol_any", "vol_rw", "node_vols_fam")


def tables_to(obj: Any, device: Any) -> Any:
    """A table (or constraint tables) with every tensor on ``device``."""
    if obj is None:
        return None
    return replace(obj, **{f.name: getattr(obj, f.name).to(device)
                           for f in fields(obj)
                           if isinstance(getattr(obj, f.name), torch.Tensor)})


def save_inputs(path: str, **steps: Tuple[Any, ...]) -> None:
    """Write the steps' tables for ``run_rank``: ``repair=(pods, nodes,
    extra)``, ``step=(pods, nodes, extra or None, chain)``, ``scan=(pods,
    nodes, extra)``, each moved to the host."""
    torch.save({name: tuple(x if isinstance(x, str) else tables_to(x, "cpu")
                            for x in args)
                for name, args in steps.items()}, path)


def _chains(name: str) -> Tuple[Tuple[Any, Any, Any], Dict[str, int]]:
    from minisched_tpu_torch.plugins.registry import build_plugins
    from minisched_tpu_torch.service.config import default_full_roster_config

    if name == "nodenumber":
        from minisched_tpu_torch.plugins.nodenumber import NodeNumber
        from minisched_tpu_torch.plugins.nodeunschedulable import (
            NodeUnschedulable,
        )

        nn = NodeNumber()
        return ((NodeUnschedulable(),), (nn,), (nn,)), {"NodeNumber": 1}
    if name != "full":
        raise ValueError(f"unknown chain {name!r}")
    cfg = default_full_roster_config()
    chains = build_plugins(cfg)
    return (chains.filter, chains.pre_score, chains.score), cfg.score_weights()


def _columns(table: Any) -> Dict[str, torch.Tensor]:
    from minisched_tpu_torch.models.tables import table_columns

    return {name: col.cpu() for name, col in table_columns(table).items()}


def _counted(fn, mesh: Any, device: torch.device
             ) -> Tuple[Any, Dict[str, Any]]:
    """``fn()`` with this process's launch counts and ``mesh``'s gather
    stats from 0: (its result, {wall_s, gather_wait_s, gather_s (the
    exchange), gather_calls, launches, plain})."""
    from minisched_tpu_torch.ops import kernels

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    kernels.reset_launch_counts()
    mesh.gather_stats.reset()
    t0 = time.monotonic()
    out = fn()
    sync()
    stats = mesh.gather_stats
    return out, {"wall_s": time.monotonic() - t0,
                 "gather_wait_s": stats.wait_s,
                 "gather_s": stats.exchange_s, "gather_calls": stats.calls,
                 "launches": kernels.launch_counts["select_hosts"],
                 "plain": sum(kernels.plain_calls.values())}


def _engine_refusal(mesh: Any, device: torch.device) -> Optional[str]:
    """The live engine's answer to this mesh: its ValueError's message,
    or None when it took the mesh."""
    from minisched_tpu_torch.engine.device_scheduler import (
        new_device_scheduler,
    )

    try:
        new_device_scheduler(None, None, device=device, mesh=mesh)
    except ValueError as err:
        return str(err)
    return None


def run_rank(path: str, device: Any, n_local: int,
             pod_shards: Optional[int] = None, warm: int = 0
             ) -> Dict[str, Any]:
    """This rank's steps over ``make_mesh(devices=[device] * n_local,
    pod_shards=pod_shards)`` on the tables at ``path`` (module
    docstring); ``warm`` untimed repair waves run before the timed one
    and must place as it does."""
    from minisched_tpu_torch.ops.fused import BatchContext
    from minisched_tpu_torch.ops.repair import RepairingEvaluator
    from minisched_tpu_torch.ops.sequential import SequentialScheduler
    from minisched_tpu_torch.parallel import sharding

    device = torch.device(device)
    inputs = torch.load(path, weights_only=False)
    mesh = sharding.make_mesh(devices=[device] * n_local,
                              pod_shards=pod_shards)
    out: Dict[str, Any] = {
        "rank": distributed.process_index(),
        "processes": distributed.process_count(),
        "shape": sharding.mesh_axis_sizes(mesh), "rows": list(mesh.rows),
        "engine_refusal": _engine_refusal(mesh, device)}
    if "repair" in inputs:
        pt, nt, extra = (tables_to(x, device) for x in inputs["repair"])
        chain, weights = _chains("full")
        ev = RepairingEvaluator(*chain, weights=weights,
                                with_diagnostics=True, mesh=mesh)
        firsts = [ev(pt, nt, extra).choice.cpu() for _ in range(warm)]
        res, stats = _counted(lambda: ev(pt, nt, extra), mesh, device)
        if any(not torch.equal(c, res.choice.cpu()) for c in firsts):
            raise AssertionError("a warm-up repair wave placed "
                                 "differently from the timed one")
        out["repair"] = dict(
            stats, choice=res.choice.cpu(), rounds=res.rounds,
            unschedulable=res.unschedulable.cpu(),
            node_table=_columns(res.node_table),
            carried={f: getattr(res.extra, f).cpu() for f in CARRIED}
            if res.extra is not None else {})
    if "step" in inputs:
        pt, nt, extra, chain_name = inputs["step"]
        pt, nt, extra = (tables_to(x, device) for x in (pt, nt, extra))
        chain, weights = _chains(chain_name)
        ctx = BatchContext(weights=tuple(sorted(weights.items())))
        step = sharding.sharded_wave_step(mesh, *chain, ctx)
        (nodes, choice, best), stats = _counted(
            lambda: step(pt, nt, extra), mesh, device)
        out["step"] = dict(stats, choice=choice.cpu(), best=best.cpu(),
                           node_table=_columns(nodes))
    if "scan" in inputs:
        pt, nt, extra = (tables_to(x, device) for x in inputs["scan"])
        chain, weights = _chains("full")
        scan = SequentialScheduler(*chain, weights=weights, mesh=mesh)
        (nodes, choice, best), stats = _counted(
            lambda: scan(pt, nt, extra), mesh, device)
        out["scan"] = dict(stats, choice=choice.cpu(), best=best.cpu(),
                           node_table=_columns(nodes))
    return out
