"""Targets for the processes ``tests/test_torch_process_mesh.py`` and the
card tests spawn (``parallel.distributed.spawn``).

A spawned process re-imports the module that holds its target, so this
one imports the port alone: no JAX, nothing of ``minisched_tpu``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from minisched_tpu_torch.ops import fused
from minisched_tpu_torch.parallel import distributed, rank_steps, sharding

#: torch threads a spawned rank keeps to (the suite runs files side by side)
THREADS = 1


def factor_and_run(path: str, n_local: int,
                   table: Sequence[Tuple[int, Optional[int]]],
                   pod_shards: Optional[int] = None) -> Dict[str, Any]:
    """``make_mesh`` across the group for each (local devices, pinned
    pod_shards) of ``table`` (its shape and rows, or the error it
    raised) and for unequal device counts (``unequal_devices``), then
    ``rank_steps.run_rank`` on the tables at ``path``."""
    torch.set_num_threads(THREADS)
    factoring = []
    for n, pin in table:
        try:
            mesh = sharding.make_mesh(devices=[torch.device("cpu")] * n,
                                      pod_shards=pin)
            factoring.append((sharding.mesh_axis_sizes(mesh), mesh.rows))
        except ValueError as err:
            factoring.append(("ValueError", str(err)))
    unequal = unequal_devices()
    out = rank_steps.run_rank(path, "cpu", n_local, pod_shards=pod_shards)
    out["factoring"] = factoring
    out["unequal"] = unequal
    return out


def unequal_devices() -> str:
    """Rank r offers r + 1 devices: every rank must refuse the mesh."""
    try:
        sharding.make_mesh(
            devices=[torch.device("cpu")] * (distributed.process_index() + 1))
    except ValueError as err:
        return str(err)
    return ""


def _fail_mid_wave(how: str) -> None:
    """On rank 1, the wave's second evaluation (inside a tile, after rank
    0 has reached the round's gather) raises or never returns."""
    real = fused.evaluate
    calls = [0]

    def evaluate(*args: Any, **kw: Any) -> Any:
        calls[0] += 1
        if distributed.process_index() == 1 and calls[0] == 2:
            if how == "raise":
                raise RuntimeError("rank 1 fails mid-wave")
            time.sleep(3600)
        return real(*args, **kw)

    fused.evaluate = evaluate


def fail_mid_wave(path: str, n_local: int, how: str) -> Dict[str, Any]:
    torch.set_num_threads(THREADS)
    _fail_mid_wave(how)
    return rank_steps.run_rank(path, "cpu", n_local)
