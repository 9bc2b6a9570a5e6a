"""Inputs that reach every code path of the kernels, made with numpy
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
* ``commit_case``: one block of the blocked lane's commit
  (``ops/scan_commit.py``) with capacity races on a few hot nodes,
  zero-demand pods, repeated and contested host ports and nodes whose
  port slots overflow, volume families at their limit, read-only against
  writable mounts, hostname-like, zone-like and keyless combo keys with
  anti-affinity, affinity and preferred term slots, and padding rows; the
  slots past each count hold garbage that must be ignored.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from types import SimpleNamespace
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from minisched_tpu_torch.api.objects import Toleration, make_node, make_pod
from minisched_tpu_torch.models import tables
from minisched_tpu_torch.models.constraints import scan_use
from minisched_tpu_torch.ops.fused import wave_planes
from minisched_tpu_torch.ops.repair import repair_wave_step
from minisched_tpu_torch.ops.scan_commit import (
    COMBO_PLANES,
    VOLUME_PLANES,
    CommitRule,
)
from minisched_tpu_torch.ops.state import COMMITTED_COLUMNS
from minisched_tpu_torch.ops.sequential import (
    _ComboCommit,
    _VolumeCommit,
    extra_rows,
    pod_rows,
)
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


#: the acceptance rules of the commit cases: the full roster's, none, and
#: ports and volume restrictions without capacity
COMMIT_RULES = {
    "full": CommitRule(True, True, ((1, 4), (2, 3), (0, 8)), True),
    "bare": CommitRule(False, False, (), False),
    "ports-restr": CommitRule(False, True, (), True),
}


@dataclass
class CommitCase:
    """The arguments of ``scan_commit.block_commit`` but the state, which
    ``state()`` makes anew each time (the commit updates it in place)."""

    initial: Dict[str, torch.Tensor]
    nodes: Any
    pods: Any
    extra: Any
    rows: torch.Tensor
    choice: torch.Tensor
    best: torch.Tensor
    rule: CommitRule
    combos: Any
    volumes: Any

    def state(self) -> Dict[str, torch.Tensor]:
        return {k: v.clone() for k, v in self.initial.items()}

    def args(self, state: Dict[str, torch.Tensor]) -> tuple:
        """The arguments with ``state``; the node table's committed
        columns are the state's, as the lane's carried table."""
        nodes = replace(self.nodes,
                        **{c: state[c] for c in COMMITTED_COLUMNS})
        return (state, nodes, self.pods, self.extra, self.rows, self.choice,
                self.best, self.rule, self.combos, self.volumes)


def commit_case(seed: int, B: int, N: int, device, rule: str = "full",
                combos: bool = True, volumes: bool = True) -> CommitCase:
    """The middle block (rows B..2B-1) of a call of 3 blocks on N nodes;
    the same seed gives the same case on any device."""
    rng = np.random.default_rng(seed)
    P = 3 * B
    W = tables.MAX_PORTS
    i32 = np.int32

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def ints(lo, hi, size):
        return rng.integers(lo, hi, size=size).astype(i32)

    # nodes: a few hot ones near full, so the block's pods race for them
    hot = rng.choice(N, size=min(3, N), replace=False)
    alloc_cpu = ints(1000, 4001, N)
    req_cpu = (alloc_cpu * rng.random(N)).astype(i32)
    req_cpu[hot] = alloc_cpu[hot] - ints(0, 700, hot.size)
    alloc_mem = ints(4096, 32769, N)
    req_mem = (alloc_mem * rng.random(N)).astype(i32)
    alloc_eph = ints(0, 2, N) * 1000
    alloc_pods = ints(4, 111, N)
    req_pods = (alloc_pods * rng.random(N)).astype(i32)
    req_pods[hot[:1]] = alloc_pods[hot[:1]] - 2
    num_used = ints(0, W + 1, N)
    num_used[hot] = W - ints(0, 3, hot.size)  # ports past the slots drop
    nt, _ = tables.build_node_table([make_node(f"n{i:04d}")
                                     for i in range(N)], capacity=N,
                                    device=device)
    nodes = replace(
        nt, alloc_cpu=t(alloc_cpu), alloc_mem=t(alloc_mem),
        alloc_eph=t(alloc_eph.astype(i32)), alloc_pods=t(alloc_pods),
        req_cpu=t(req_cpu), req_mem=t(req_mem),
        req_eph=t(np.zeros(N, i32)), req_pods=t(req_pods),
        nzreq_cpu=t(req_cpu + 100), nzreq_mem=t(req_mem + 200),
        used_port=t(ints(1, 65536, (N, W))), num_used_ports=t(num_used))

    # the block: choices mostly on the hot nodes, some infeasible, some
    # padding rows (a padding row may still carry a choice)
    valid = rng.random(B) >= 0.15
    choice = np.where(rng.random(B) < 0.6, rng.choice(hot, size=B),
                      rng.integers(0, N, size=B)).astype(i32)
    choice[rng.random(B) < 0.1] = -1
    choice[~valid & (rng.random(B) < 0.7)] = -1
    pods = SimpleNamespace(
        valid=t(valid),
        req_cpu=t(rng.choice(np.array([0, 100, 500, 1000], i32), size=B)),
        req_mem=t(rng.choice(np.array([0, 128, 500, 2048], i32), size=B)),
        req_eph=t(rng.choice(np.array([0, 0, 0, 0, 0, 600], i32), size=B)),
        req_pods=t(np.zeros(B, i32)),
        port=t(rng.choice(np.array([80, 443, 8080, 9000], i32), size=(B, W))),
        num_ports=t(rng.choice(np.array([0, 0, 1, 2, 3, W], i32), size=B)))

    # topology: key 0 hostname-like, key 1 four zones, key 2 on no node;
    # a tenth of the nodes lack keys 0 and 1
    D = 64
    keyless = rng.random(N) < 0.1
    topo_domain = np.full((3, N), D, i32)
    topo_domain[0] = np.where(keyless, D, 0)
    topo_domain[1] = np.where(keyless, D, rng.integers(0, 4, size=N))
    topo_onehot = np.zeros((3, D, N), bool)
    for n in np.flatnonzero(~keyless):
        topo_onehot[1, topo_domain[1, n], n] = True
    C, T = 8, {"pan": 4, "ppa": 8, "pa": 4}

    def terms(kind):
        n = ints(0, T[kind] + 1, P)
        n[rng.random(P) < 0.4] = 0
        return ints(0, C, (P, T[kind])), n

    pan_combo, pan_n = terms("pan")
    ppa_combo, ppa_n = terms("ppa")
    pa_combo, pa_n = terms("pa")
    # volumes: 10 claims over 11 volume rows and the dummy row, 4 families
    C2, Vd, F, V = 10, 12, 4, 4
    claim_vol = ints(0, Vd - 1, C2)
    claim_vol[rng.random(C2) < 0.3] = -1  # unbound
    pod_claims = ints(0, C2, (P, V))
    pod_claims[:, 1] = np.where(rng.random(P) < 0.2, pod_claims[:, 0],
                                pod_claims[:, 1])  # one claim twice
    full = SimpleNamespace(
        combo_key=t(rng.integers(0, 3, size=C).astype(i32)),
        topo_unique=t(np.array([True, False, False])),
        topo_onehot=t(topo_onehot), topo_domain=t(topo_domain),
        pod_claims=t(pod_claims), pod_n_vols=t(ints(0, V + 1, P)),
        pod_claim_valid=t(rng.random((P, V)) < 0.85),
        claim_cnt=t(ints(0, Vd - 1, C2)), claim_vol=t(claim_vol),
        claim_ro=t(rng.random(C2) < 0.5),
        claim_family=t(ints(0, F, C2)))
    planes = {
        "combo_dsum": t(ints(0, 6, (C, N))),
        "combo_here": t(ints(0, 3, (C, N))),
        "combo_global": t(ints(0, 50, C)),
        "combo_excl": t(rng.random((C, N)) < 0.1),
        "rev_weight": t(ints(-50, 51, (C, N))),
        "vol_any": t(rng.random((Vd, N)) < 0.2),
        "vol_rw": t(rng.random((Vd, N)) < 0.1),
        "node_vols_fam": t(ints(0, 4, (F, N))),
    }
    for name, plane in planes.items():
        setattr(full, name, plane)
    rows = torch.arange(B, 2 * B, device=device)
    block = slice(B, 2 * B)
    extra = SimpleNamespace(
        pod_matches_combo=t(rng.random((B, C)) < 0.4),
        pod_vols_fam=t(rng.choice(np.array([0, 0, 0, 1, 2], i32),
                                  size=(B, F))),
        pod_missing=t(ints(0, 2, B) * (rng.random(B) < 0.3)),
        pan_combo=t(pan_combo[block]), pan_n=t(pan_n[block]),
        ppa_combo=t(ppa_combo[block]), ppa_n=t(ppa_n[block]),
        ppa_w=t(ints(-100, 101, (B, T["ppa"]))),
        pa_combo=t(pa_combo[block]), pa_n=t(pa_n[block]))
    state = {c: getattr(nodes, c).clone() for c in COMMITTED_COLUMNS}
    if combos:
        state.update({k: planes[k] for k in COMBO_PLANES})
    if volumes:
        state.update({k: planes[k] for k in VOLUME_PLANES})
    state["choice"] = t(ints(-1, N, P))
    state["best"] = t(ints(0, 100, P))
    state["accepted"] = t(rng.random(P) < 0.5)
    return CommitCase(
        initial=state, nodes=nodes, pods=pods, extra=extra, rows=rows,
        choice=t(choice), best=t(ints(-10, 300, B)),
        rule=COMMIT_RULES[rule],
        combos=_ComboCommit(full) if combos else None,
        volumes=_VolumeCommit(full) if volumes else None)
