"""Inputs that reach every code path of the two kernels, made with numpy
from a seed.

``chip_smoke.py`` (phase 2) and ``tests/test_torch_cuda.py`` hold each
kernel against its plain twin on these inputs; ``tests/test_torch_kernels.py``
holds the twins against the JAX package on the same toleration forms.

* ``select_case``: planes for ``select_hosts`` whose first rows are edge
  rows (no feasible node, every node a candidate, the max only in the
  last column, ties straddling 16- and 512-node chunk boundaries, feasible
  only at INT32_MIN) and whose last seeds lie near 2**32.  With P odd and
  N not a multiple of 16, row starts are not 16-byte aligned.
* ``offset_view``: the same values at a 1-byte offset, so that no row of a
  bool plane is 16-byte aligned together with its scores.
* ``repair_planes``: the (scores, mask) planes of a given round of a
  repair wave (``ops/repair.py``), for ``select_hosts`` on its real inputs.
* ``scan_planes``: the (scores, mask) planes of the first step of a scan
  lane (``ops/sequential.py``): one pod row, or one block of rows.
* ``toleration_cluster``: nodes (some cordoned, some without a numeric
  suffix) and pods carrying every toleration form, then ``garble`` fills
  the slots at or past ``num_tols`` with matching tolerations and clears
  ``valid`` on some rows.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, List, Tuple

import numpy as np
import torch

from minisched_tpu_torch.api.objects import Toleration, make_node, make_pod
from minisched_tpu_torch.models import tables
from minisched_tpu_torch.models.constraints import scan_use
from minisched_tpu_torch.ops.fused import wave_planes
from minisched_tpu_torch.ops.repair import repair_wave_step
from minisched_tpu_torch.ops.sequential import extra_rows, pod_rows
from minisched_tpu_torch.utils.hashing import fnv1a32

#: node counts of the select_hosts cases: both sides of the 16-node group
#: and the 512-node warp step, and the main path's padded node axis
SELECT_NS = (15, 16, 17, 511, 512, 513, 10112)
INT32_MIN = -(1 << 31)
#: the edge rows that ``select_case`` writes over rows 0..4
EDGE_ROWS = 5

_KEY = "node.kubernetes.io/unschedulable"

#: every form a toleration of the unschedulable taint can take; the first
#: four tolerate it
TOLERATION_FORMS = {
    "Exists, NoSchedule": Toleration(key=_KEY, operator="Exists",
                                     effect="NoSchedule"),
    "Exists, any effect": Toleration(key=_KEY, operator="Exists"),
    "Equal, empty value": Toleration(key=_KEY, operator="Equal", value=""),
    "wildcard": Toleration(key="", operator="Exists"),
    "Equal, non-empty value": Toleration(key=_KEY, operator="Equal",
                                         value="true"),
    "empty key, Equal": Toleration(key="", operator="Equal"),
    "NoExecute": Toleration(key=_KEY, operator="Exists", effect="NoExecute"),
    "PreferNoSchedule": Toleration(key=_KEY, operator="Exists",
                                   effect="PreferNoSchedule"),
    "other key": Toleration(key="dedicated", operator="Exists",
                            effect="NoSchedule"),
}


def select_case(seed: int, P: int, N: int, tie_heavy: bool = True
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(scores i32[P, N], mask bool[P, N], seeds u32[P])."""
    rng = np.random.default_rng(seed)
    if tie_heavy:
        scores = rng.choice(np.array([0, 10], np.int32), size=(P, N))
    else:
        scores = rng.integers(-50, 500, size=(P, N), dtype=np.int32)
    mask = rng.random((P, N)) < 0.7
    seeds = rng.integers(0, 1 << 32, size=P, dtype=np.uint64).astype(np.uint32)
    edge = [
        # no feasible node
        (np.zeros(N, np.int32), np.zeros(N, bool)),
        # every node feasible at one score: every node a candidate
        (np.full(N, 7, np.int32), np.ones(N, bool)),
        # the maximum only in the last column
        (np.where(np.arange(N) == N - 1, 1000,
                  rng.integers(0, 100, N)).astype(np.int32),
         np.ones(N, bool)),
        # ties at the max on both sides of 16- and 512-node boundaries
        (np.where(np.isin(np.arange(N), [15, 16, 511, 512, 513, N - 1]),
                  50, 0).astype(np.int32),
         (rng.random(N) < 0.5)
         | np.isin(np.arange(N), [15, 16, 511, 512, 513])),
        # feasible only at INT32_MIN
        (np.full(N, INT32_MIN, np.int32),
         (rng.random(N) < 0.5) | (np.arange(N) == N // 2)),
    ]
    for row, (s, m) in enumerate(edge[:P]):
        scores[row], mask[row] = s, m
    # seeds near 2**32 on the last rows
    tail = min(P, 3)
    seeds[P - tail:] = 0xFFFFFFFF - np.arange(tail, dtype=np.uint32)
    return scores, mask, seeds


def select_tensors(scores: np.ndarray, mask: np.ndarray, seeds: np.ndarray,
                   device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The numpy case as the port's tensors (seeds as int32 bits)."""
    return (torch.from_numpy(scores).to(device),
            torch.from_numpy(mask).to(device),
            torch.from_numpy(seeds.view(np.int32)).to(device))


def offset_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts 1 element past an
    allocation's start."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def toleration_cluster(seed: int, n_nodes: int, n_pods: int
                       ) -> Tuple[List[Any], List[Any]]:
    """(nodes, pods): 40% of nodes cordoned and one in eight without a
    numeric suffix; each pod carries up to three tolerations drawn from
    ``TOLERATION_FORMS``, and one in eight has no numeric suffix."""
    rng = np.random.default_rng(seed)
    forms = list(TOLERATION_FORMS.values())
    nodes = [
        make_node(f"node{i}" + ("x" if rng.random() < 0.125 else ""),
                  unschedulable=bool(rng.random() < 0.4))
        for i in range(n_nodes)
    ]
    pods = []
    for i in range(n_pods):
        k = int(rng.integers(0, 4))
        tols = [forms[int(j)] for j in rng.integers(0, len(forms), size=k)]
        name = f"pod{i}" + ("x" if rng.random() < 0.125 else "")
        pods.append(make_pod(name, tolerations=tols))
    return nodes, pods


def garble(pods: Any, seed: int) -> Any:
    """``pods`` with the toleration slots at or past ``num_tols`` of half
    the rows holding tolerations that would match (which must be ignored),
    and ``valid`` cleared on one row in eight."""
    rng = np.random.default_rng(seed)
    P, T = pods.tol_key.shape
    num = pods.num_tols.cpu().numpy()
    dead = (np.arange(T)[None, :] >= num[:, None]) & (rng.random((P, 1)) < 0.5)
    wildcard = rng.random((P, T)) < 0.5

    def fill(col: torch.Tensor, value) -> torch.Tensor:
        out = col.cpu().numpy().copy()
        out[dead] = np.broadcast_to(value, out.shape)[dead]
        return torch.from_numpy(out).to(col.device)

    valid = pods.valid.cpu().numpy() & (rng.random(P) >= 0.125)
    return replace(
        pods,
        tol_key=fill(pods.tol_key, np.where(wildcard, fnv1a32(""),
                                            fnv1a32(_KEY)).astype(np.int32)),
        tol_value=fill(pods.tol_value, np.int32(fnv1a32(""))),
        tol_effect=fill(pods.tol_effect, np.int32(tables.EFFECT_NO_SCHEDULE)),
        tol_op=fill(pods.tol_op, np.int32(tables.TOLERATION_OP_EXISTS_CODE)),
        tol_empty_key=fill(pods.tol_empty_key, wildcard),
        valid=torch.from_numpy(valid).to(pods.valid.device),
    )


def repair_planes(pods: Any, nodes: Any, evaluator: Any,
                  rounds_before: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, mask) that the repair route hands ``select_hosts`` in round
    ``rounds_before + 1`` of a wave: the pods committed in the earlier
    rounds are masked out (all-masked rows), and the node table holds
    their commits.  ``evaluator`` is an ``ops.repair.RepairingEvaluator``."""
    chains = (evaluator.filter_plugins, evaluator.pre_score_plugins,
              evaluator.score_plugins)
    if rounds_before:
        nodes, final = repair_wave_step(nodes, pods, *chains, evaluator.ctx,
                                        max_rounds=rounds_before)[:2]
        pods = replace(pods, valid=pods.valid & (final < 0))
    planes = wave_planes(pods, nodes, *chains, evaluator.ctx)
    return planes.totals, planes.mask


def scan_planes(scheduler: Any, pods: Any, nodes: Any, extra: Any,
                rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, mask) that a scan lane hands ``select_hosts`` at its first
    step: the first ``rows`` pod rows (1 for the exact scan, a block for
    the blocked lane) against the tables as given, with the scan's
    constraint flags.  ``scheduler`` is an ``ops.sequential``
    ``SequentialScheduler`` or ``BlockedSequentialScheduler``; the
    blocked lane's static split gives the same planes, so it is not
    made here."""
    idx = torch.arange(rows, device=pods.valid.device)
    row_extra = (None if extra is None else
                 extra_rows(extra, idx, {}, scan_use(extra.in_use)))
    planes = wave_planes(pod_rows(pods, idx), nodes,
                         scheduler.filter_plugins, scheduler.pre_score_plugins,
                         scheduler.score_plugins, scheduler.ctx,
                         extra=row_extra)
    return planes.totals, planes.mask
