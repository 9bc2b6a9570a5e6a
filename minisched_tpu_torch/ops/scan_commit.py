"""The blocked scan lane's commit of one block: accept, then apply.

A step of ``sequential.blocked_scan_schedule`` evaluates a block of B
pods against the carried state, then commits the subset that repair's
acceptance rule lets through.  The commit (``block_commit``) is:

* ``ops/repair.accept_placements`` over the block, from the node columns
  as the block found them (capacity, host ports, volume families,
  VolumeRestrictions, as the chain enforces them);
* the combo planes (``combo_dsum``, ``combo_here``, ``combo_global``,
  ``combo_excl``, ``rev_weight``) and the volume planes (``vol_any``,
  ``vol_rw``, ``node_vols_fam``) of the committed pods;
* ``ops/state.apply_placements`` on the carried node columns;
* the block's ``choice``, ``best`` and ``accepted`` at its rows.

``block_commit_plain`` is that composition in PyTorch (432 kernels a
block on a card at the benchmark cell's shape); ``csrc/scan_commit.cu``
computes the same integers in two launches (``block_commit_cuda``).  ``block_commit`` takes the twin
for CPU tensors and the kernel for CUDA tensors, with no fallback
between them.  The exact lane, the mesh lanes and repair waves keep
their own commits: one pod a step, shards of the node axis, waves of
thousands of pods need other shapes than one CTA's block rule.

Every function here updates ``state`` (the step's carried tensors) in
place and returns nothing; ``state`` holds the committed node columns
(``ops/state.COMMITTED_COLUMNS``), the tracked combo and volume planes,
and the outputs ``choice``, ``best``, ``accepted`` of the whole call.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from minisched_tpu_torch.models import tables
from minisched_tpu_torch.models.constraints import HARD_POD_AFFINITY_WEIGHT
from minisched_tpu_torch.ops import kernels
from minisched_tpu_torch.ops.repair import accept_placements
from minisched_tpu_torch.ops.state import COMMITTED_COLUMNS, apply_placements

State = Dict[str, torch.Tensor]

#: the most pods a block (one CTA of the accept kernel)
MAX_BLOCK = 1024
#: the most volume-limit plugins a chain may hold
MAX_FAMILIES = 8

#: the carried planes a step updates where the chain tracks combos, and
#: where it tracks volumes
COMBO_PLANES = ("combo_dsum", "combo_here", "combo_global", "combo_excl",
                "rev_weight")
VOLUME_PLANES = ("vol_any", "vol_rw", "node_vols_fam")


@dataclass(frozen=True)
class CommitRule:
    """What the chain's filters enforce, so acceptance enforces it too:
    NodeResourcesFit (``check_resources``), NodePorts (``check_ports``),
    (family index, max volumes) of each volume-limit plugin
    (``fam_limits``), VolumeRestrictions (``check_restr``)."""

    check_resources: bool
    check_ports: bool
    fam_limits: Tuple[Tuple[int, int], ...]
    check_restr: bool

    @staticmethod
    def of_chain(filter_plugins: Any) -> "CommitRule":
        names = {pl.name() for pl in filter_plugins}
        return CommitRule(
            check_resources="NodeResourcesFit" in names,
            check_ports="NodePorts" in names,
            fam_limits=tuple(
                (pl.volume_family_index, pl.max_volumes)
                for pl in filter_plugins
                if getattr(pl, "volume_family_index", None) is not None),
            check_restr=any(getattr(pl, "enforces_volume_restrictions", False)
                            for pl in filter_plugins))


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------


def block_commit_plain(state: State, nodes: Any, pods: Any, extra: Any,
                       rows: torch.Tensor, choice: torch.Tensor,
                       best: torch.Tensor, rule: CommitRule,
                       combos: Any = None, volumes: Any = None) -> None:
    """The commit as PyTorch operations.  ``nodes``: the call's NodeTable
    with its committed columns those of ``state``; ``pods`` and
    ``extra``: the block's rows of the pod and constraint tables;
    ``rows`` (long[B]) the block's rows of the call; ``choice``/``best``
    (i32[B]) the evaluation's; ``combos``/``volumes``: the lane's hoisted
    ``sequential._ComboCommit`` / ``_VolumeCommit``, None where the chain
    tracks no such plane."""
    accept = accept_placements(
        nodes, pods, choice, pods.valid,
        check_resources=rule.check_resources, check_ports=rule.check_ports,
        vol_state=([(extra.pod_vols_fam[:, f], state["node_vols_fam"][f], mx)
                    for f, mx in rule.fam_limits] if rule.fam_limits else None),
        restr_state=((volumes.slot_vol.index_select(0, rows),
                      volumes.slot_ro.index_select(0, rows),
                      volumes.n_rows) if rule.check_restr else None))
    committed = accept & (choice >= 0)
    n_b = choice.clamp(min=0).long()
    if combos is not None:
        combos.block(state, extra, n_b, committed)
    if volumes is not None:
        volumes(state, rows, extra.pod_missing, n_b, committed)
    new = apply_placements(nodes, pods, torch.where(committed, choice, -1))
    for c in COMMITTED_COLUMNS:
        state[c].copy_(getattr(new, c))
    state["choice"].index_copy_(0, rows, choice)
    state["best"].index_copy_(0, rows, best)
    state["accepted"].index_copy_(0, rows, accept)


# ---------------------------------------------------------------------------
# the kernel (CUDA tensors only)
# ---------------------------------------------------------------------------

_p = ctypes.c_void_p
_i = ctypes.c_int


class _Args(ctypes.Structure):
    """``BlockCommitArgs`` of ``csrc/scan_commit.cu``, field for field."""

    _fields_ = [(name, _p) for name in (
        "rows", "choice", "best", "valid", "req_cpu_p", "req_mem_p",
        "req_eph_p", "port", "num_ports",
        "alloc_cpu", "alloc_mem", "alloc_eph", "alloc_pods",
        "req_cpu", "req_mem", "req_eph", "req_pods", "nzreq_cpu", "nzreq_mem",
        "used_port", "num_used_ports",
        "choice_out", "best_out", "accepted_out",
        "pmc", "combo_key", "uniq", "topo_domain", "pan_combo", "pan_n",
        "ppa_combo", "ppa_w", "ppa_n", "pa_combo", "pa_n",
        "combo_dsum", "combo_here", "combo_global", "combo_excl",
        "rev_weight",
        "slot_cnt", "slot_vol", "slot_ro", "slot_fam", "slot_dup",
        "pod_missing", "pod_vols_fam", "vol_any", "vol_rw", "node_vols_fam",
        "scratch")] + [(name, _i) for name in (
            "B", "N", "W", "UP", "C", "D", "TPAN", "TPPA", "TPA", "V", "Vd",
            "F", "scratch_len", "check_resources", "check_ports",
            "check_restr", "track_combos", "track_vols", "n_fam")] + [
        ("fam_index", _i * MAX_FAMILIES), ("fam_max", _i * MAX_FAMILIES),
        ("nonzero_cpu", _i), ("nonzero_mem", _i), ("hard_weight", _i)]


def _checked(args: _Args, what: Dict[str, Tuple[torch.Tensor, torch.dtype,
                                                 tuple]],
             device: torch.device) -> None:
    """Check each (tensor, dtype, shape) and set its field to the
    tensor's address."""
    for field_name, (t, dtype, shape) in what.items():
        kernels._check(t, field_name, dtype, shape, device)
        setattr(args, field_name, t.data_ptr())


def block_commit_cuda(state: State, nodes: Any, pods: Any, extra: Any,
                      rows: torch.Tensor, choice: torch.Tensor,
                      best: torch.Tensor, rule: CommitRule,
                      combos: Any = None, volumes: Any = None) -> None:
    """``block_commit_plain`` in one call of ``csrc/scan_commit.cu`` (two
    launches on the current stream) over tensors on one card; raises on
    what the kernel does not take."""
    device = choice.device
    if device.type != "cuda":
        raise ValueError(f"block_commit_cuda needs CUDA tensors, got {device}")
    i32, i64, b8 = torch.int32, torch.int64, torch.bool
    B = int(choice.shape[0])
    N = int(nodes.valid.shape[0])
    P = int(state["choice"].shape[0])
    W = int(pods.port.shape[1])
    UP = int(state["used_port"].shape[1])
    args = _Args(B=B, N=N, W=W, UP=UP,
                 check_resources=rule.check_resources,
                 check_ports=rule.check_ports, check_restr=rule.check_restr,
                 track_combos=combos is not None,
                 track_vols=volumes is not None,
                 n_fam=len(rule.fam_limits),
                 nonzero_cpu=tables.DEFAULT_NONZERO_CPU,
                 nonzero_mem=tables.DEFAULT_NONZERO_MEM_MIB,
                 hard_weight=HARD_POD_AFFINITY_WEIGHT)
    for k, (f, mx) in enumerate(rule.fam_limits):
        args.fam_index[k], args.fam_max[k] = f, mx
    what = {
        "rows": (rows, i64, (B,)), "choice": (choice, i32, (B,)),
        "best": (best, i32, (B,)), "valid": (pods.valid, b8, (B,)),
        "req_cpu_p": (pods.req_cpu, i32, (B,)),
        "req_mem_p": (pods.req_mem, i32, (B,)),
        "req_eph_p": (pods.req_eph, i32, (B,)),
        "port": (pods.port, i32, (B, W)),
        "num_ports": (pods.num_ports, i32, (B,)),
        "used_port": (state["used_port"], i32, (N, UP)),
        "choice_out": (state["choice"], i32, (P,)),
        "best_out": (state["best"], i32, (P,)),
        "accepted_out": (state["accepted"], b8, (P,)),
    }
    for c in ("alloc_cpu", "alloc_mem", "alloc_eph", "alloc_pods"):
        what[c] = (getattr(nodes, c), i32, (N,))
    for c in COMMITTED_COLUMNS:
        if c != "used_port":
            what[c] = (state[c], i32, (N,))
    if combos is not None:
        C = int(state["combo_global"].shape[0])
        T = {k: int(getattr(extra, f"{k}_combo").shape[1])
             for k in ("pan", "ppa", "pa")}
        args.C, args.D = C, combos.D
        args.TPAN, args.TPPA, args.TPA = T["pan"], T["ppa"], T["pa"]
        what.update({
            "pmc": (extra.pod_matches_combo, b8, (B, C)),
            "combo_key": (combos.keys, i64, (C,)),
            "uniq": (combos.uniq, b8, (C,)),
            "topo_domain": (combos.topo_domain, i32,
                            (int(combos.topo_domain.shape[0]), N)),
            "ppa_w": (extra.ppa_w, i32, (B, T["ppa"])),
            "combo_global": (state["combo_global"], i32, (C,)),
            "combo_excl": (state["combo_excl"], b8, (C, N)),
        })
        for k in ("pan", "ppa", "pa"):
            what[f"{k}_combo"] = (getattr(extra, f"{k}_combo"), i32, (B, T[k]))
            what[f"{k}_n"] = (getattr(extra, f"{k}_n"), i32, (B,))
        for f in ("combo_dsum", "combo_here", "rev_weight"):
            what[f] = (state[f], i32, (C, N))
    if volumes is not None:
        V = int(volumes.slot_cnt.shape[1])
        Vd = int(state["vol_any"].shape[0])
        F = int(state["node_vols_fam"].shape[0])
        args.V, args.Vd, args.F = V, Vd, F
        if any(not 0 <= f < F for f, _ in rule.fam_limits):
            raise ValueError(f"a volume family of {rule.fam_limits} is not "
                             f"one of the {F} planes")
        what.update({
            "slot_cnt": (volumes.slot_cnt, i32, (P, V)),
            "slot_vol": (volumes.slot_vol, i32, (P, V)),
            "slot_ro": (volumes.slot_ro, b8, (P, V)),
            "slot_fam": (volumes.slot_fam, i32, (P, V)),
            "slot_dup": (volumes.slot_dup, b8, (P, V)),
            "pod_missing": (extra.pod_missing, i32, (B,)),
            "pod_vols_fam": (extra.pod_vols_fam, i32, (B, F)),
            "vol_any": (state["vol_any"], b8, (Vd, N)),
            "vol_rw": (state["vol_rw"], b8, (Vd, N)),
            "node_vols_fam": (state["node_vols_fam"], i32, (F, N)),
        })
    # the committed flags and the combo lists (``Scratch`` in the source)
    args.scratch_len = (3 + B + 4 * B * (args.C + args.TPAN)
                        + 5 * B * (args.TPPA + args.TPA))
    what["scratch"] = (torch.empty(args.scratch_len, dtype=i32,
                                   device=device), i32, (args.scratch_len,))
    _checked(args, what, device)
    kernels._launch("minisched_block_commit", device, ctypes.addressof(args))


# ---------------------------------------------------------------------------
# the dispatcher: the tensors' device decides the route
# ---------------------------------------------------------------------------


def _validate(state: State, choice: torch.Tensor, rows: torch.Tensor,
              rule: CommitRule, combos: Any, volumes: Any) -> None:
    """Refuse, on either route, what the kernel does not take."""
    if choice.dim() != 1 or choice.dtype != torch.int32:
        raise TypeError(f"choice must be i32[B], got {choice.dtype} "
                        f"{tuple(choice.shape)}")
    B = int(choice.shape[0])
    if not 1 <= B <= MAX_BLOCK:
        raise ValueError(f"a block holds 1 to {MAX_BLOCK} pods, got {B}")
    if rows.dtype != torch.int64 or tuple(rows.shape) != (B,):
        raise TypeError(f"rows must be i64[{B}], got {rows.dtype} "
                        f"{tuple(rows.shape)}")
    if len(rule.fam_limits) > MAX_FAMILIES:
        raise ValueError(f"at most {MAX_FAMILIES} volume-limit plugins, got "
                         f"{len(rule.fam_limits)}")
    need = set(COMMITTED_COLUMNS) | {"choice", "best", "accepted"}
    need |= set(COMBO_PLANES) if combos is not None else set()
    need |= set(VOLUME_PLANES) if volumes is not None else set()
    if rule.fam_limits or rule.check_restr:
        if volumes is None:
            raise ValueError("volume limits and VolumeRestrictions need the "
                             "volume planes")
    missing = sorted(need - set(state))
    if missing:
        raise ValueError(f"the state lacks {missing}")


def block_commit(state: State, nodes: Any, pods: Any, extra: Any,
                 rows: torch.Tensor, choice: torch.Tensor, best: torch.Tensor,
                 rule: CommitRule, combos: Optional[Any] = None,
                 volumes: Optional[Any] = None) -> None:
    """Commit one block of the blocked lane into ``state`` (arguments as
    ``block_commit_plain``): the kernel for tensors on a card, the plain
    twin for tensors on the CPU."""
    _validate(state, choice, rows, rule, combos, volumes)
    if choice.device.type == "cuda":
        block_commit_cuda(state, nodes, pods, extra, rows, choice, best, rule,
                          combos, volumes)
    elif choice.device.type == "cpu":
        with kernels._count_lock:
            kernels.plain_calls["block_commit"] += 1
        block_commit_plain(state, nodes, pods, extra, rows, choice, best,
                           rule, combos, volumes)
    else:
        raise ValueError(f"no block_commit route for tensors on "
                         f"{choice.device}")
