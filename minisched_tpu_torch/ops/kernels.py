"""The seeded masked argmax, as hand-written Hopper kernels and plain twins.

Counterpart of ``minisched_tpu/ops/pallas_kernels.py``.  Each kernel of
``csrc/select_hosts.cu`` has a wrapper here that checks its inputs,
launches on PyTorch's current stream and counts the launch, and a plain
PyTorch twin (``*_plain``) that computes the same function with tensor
ops.  The twin runs the CPU tests and is what ``chip_smoke.py`` holds each
kernel against on the card.  A wrapper takes CUDA tensors only; the
dispatchers at the end of this module (``select_hosts``,
``nodenumber_select_hosts``) pick the twin for a CPU tensor and the kernel
for a CUDA tensor, at any shape, with no fallback between them.

Rule shared by every function here (== ``engine.tiebreak.select_host``):
per pod, among feasible nodes take the max score; among those the least
``mix32(seed, node_idx)``; on an equal hash the lowest index.  A pod with
no feasible node gets ``(choice, best) = (-1, 0)``.

Seeds are u32 values carried as ``torch.int32`` holding the same bits.

Under a device mesh (``parallel/sharding.py``) each node shard runs the
argmax over its own columns with ``node_base`` (its first global node
index): the hash and the returned index are the whole row's, so the
shards' partials merge exactly (``select_hosts_merge``).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Any, Dict, Sequence, Tuple

import torch

from minisched_tpu_torch.models import tables
from minisched_tpu_torch.plugins.nodeunschedulable import (
    _EMPTY_VALUE_HASH,
    _UNSCHED_KEY_HASH,
    tolerates_unschedulable,
)
from minisched_tpu_torch.utils import build

INT32_MIN = -(1 << 31)
UINT32_MAX = 0xFFFFFFFF

#: launches of each kernel since the last ``reset_launch_counts``; a
#: wrapper adds one where it launches its kernel and nowhere else
launch_counts = {"select_hosts": 0, "nodenumber_select_hosts": 0}
#: calls the dispatchers below routed to a plain twin (CPU tensors): a
#: path that runs on the card must leave these at 0
plain_calls = {"select_hosts": 0, "nodenumber_select_hosts": 0}
#: calls made while a CUDA graph was being captured: each records its
#: kernel into the graph, which launches it at every replay; whoever
#: replays the graph counts those launches (``count_replays``)
captured_counts = {"select_hosts": 0, "nodenumber_select_hosts": 0}
#: the counts are bumped from a mesh's tile threads too
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    """Set the launch counts and the plain-twin calls to 0."""
    for name in launch_counts:
        launch_counts[name] = 0
        plain_calls[name] = 0


def count_replays(captured: Dict[str, int], replays: int) -> None:
    """Count the launches of ``replays`` replays of a graph into which
    ``captured`` (kernel name → calls) were recorded."""
    for name, calls in captured.items():
        launch_counts[name] += calls * replays


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32): the constant is
    split into 16-bit halves so no product leaves int64's range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & UINT32_MAX


def mix32_plain(seed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``engine.tiebreak.mix32`` on tensors, in int64 holding u32 values.

    ``seed`` may be int32 (u32 bits) or int64; the result is int64 in
    [0, 2**32), so ordinary int64 compares order it as unsigned."""
    x = seed.to(torch.int64) & UINT32_MAX
    x = x ^ _mul32(idx.to(torch.int64) & UINT32_MAX, 0x9E3779B9)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def select_hosts_plain(
    scores: torch.Tensor, mask: torch.Tensor, seeds: torch.Tensor,
    node_base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The XLA tail of ``minisched_tpu/ops/fused.py:179-196`` in torch;
    ``node_base`` is added to each column's index before it is hashed and
    to the returned choice."""
    P, N = scores.shape
    if N == 0:
        return (torch.full((P,), -1, dtype=torch.int32, device=scores.device),
                torch.zeros((P,), dtype=torch.int32, device=scores.device))
    masked = torch.where(mask, scores, INT32_MIN)
    best = masked.max(dim=1).values  # i32[P]
    cand = mask & (masked == best[:, None])
    idx = torch.arange(node_base, node_base + N, device=scores.device)
    h = mix32_plain(seeds[:, None], idx[None, :])
    hkey = torch.where(cand, h, UINT32_MAX)
    minh = hkey.min(dim=1).values
    # among positions at the min hash, prefer real candidates (guards the
    # h == UINT32_MAX collision), then the lowest index
    is_min = hkey == minh[:, None]
    pref = is_min & cand
    has_pref = pref.any(dim=1)
    pick_from = torch.where(has_pref[:, None], pref, is_min)
    # argmax returns the first maximal position
    choice = pick_from.to(torch.uint8).argmax(dim=1).to(torch.int32)
    if node_base:
        choice = choice + node_base
    feasible_any = mask.any(dim=1)
    choice = torch.where(feasible_any, choice, -1).to(torch.int32)
    best = torch.where(feasible_any, best, 0).to(torch.int32)
    return choice, best


def nodenumber_planes(tol: torch.Tensor, pods: Any, nodes: Any,
                      match_score: int):
    """(scores i32[P, N], mask bool[P, N]) of the flagship chain, given
    ``tol = tolerates_unschedulable(pods)``."""
    mask = (pods.valid[:, None] & nodes.valid[None, :]) & (
        (~nodes.unschedulable)[None, :] | tol[:, None]
    )
    ps, ns = pods.suffix[:, None], nodes.suffix[None, :]
    match = (ps == ns) & (ps >= 0) & (ns >= 0)
    scores = torch.where(match, match_score, 0).to(torch.int32)
    return scores, mask


def nodenumber_select_hosts_plain(
    pods: Any, nodes: Any, match_score: int = 10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused flagship chain with its ``tolerates_unschedulable``
    prologue and its (P, N) planes written out."""
    scores, mask = nodenumber_planes(tolerates_unschedulable(pods), pods,
                                     nodes, match_score)
    return select_hosts_plain(scores, mask, pods.seed)


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

_ptr = ctypes.c_void_p
_int = ctypes.c_int
_SIGNATURES = {
    # scores, mask, seeds, P, N, node_base, choice, best, stream
    "minisched_select_hosts": (_ptr, _ptr, _ptr, _int, _int, _int, _ptr,
                               _ptr, _ptr),
    # unsched, nsuffix, nvalid, N, psuffix, seeds, pvalid, tol_key,
    # tol_value, tol_effect, tol_op, tol_empty_key, num_tols, T, P,
    # match_score, unsched_key_hash, empty_value_hash, effect_none,
    # effect_no_schedule, op_exists, choice, best, stream
    "minisched_nodenumber_select_hosts": (
        _ptr, _ptr, _ptr, _int, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
        _ptr, _ptr, _int, _int, _int, _int, _int, _int, _int, _int, _ptr,
        _ptr, _ptr,
    ),
    "minisched_nodenumber_smem_bytes": (),
    "minisched_nodenumber_resident_blocks": (),
}


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """The C entry point ``name`` of the kernels' library (built at first
    use) with its argument types declared."""
    fn = getattr(build.load_library(), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


def _launch(name: str, device: torch.device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    counts = (captured_counts if torch.cuda.is_current_stream_capturing()
              else launch_counts)
    with _count_lock:
        counts[name.removeprefix("minisched_")] += 1


def select_hosts_cuda(
    scores: torch.Tensor, mask: torch.Tensor, seeds: torch.Tensor,
    node_base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``select_hosts_kernel``: scores i32[P, N], mask bool[P, N], seeds
    i32[P] (u32 bits), all on one card → (choice i32[P], best i32[P]);
    column j is node ``node_base + j``."""
    device = scores.device
    if device.type != "cuda":
        raise ValueError(f"select_hosts_cuda needs CUDA tensors, got {device}")
    if scores.dim() != 2:
        raise ValueError(f"scores must be 2-D, got shape {tuple(scores.shape)}")
    P, N = scores.shape
    if node_base < 0 or node_base + N >= 1 << 31:
        raise ValueError(f"node_base {node_base} + {N} columns out of range")
    _check(scores, "scores", torch.int32, (P, N), device)
    _check(mask, "mask", torch.bool, (P, N), device)
    _check(seeds, "seeds", torch.int32, (P,), device)
    choice = torch.empty(P, dtype=torch.int32, device=device)
    best = torch.empty(P, dtype=torch.int32, device=device)
    _launch("minisched_select_hosts", device, scores.data_ptr(),
            mask.data_ptr(), seeds.data_ptr(), P, N, node_base,
            choice.data_ptr(), best.data_ptr())
    return choice, best


def nodenumber_select_hosts_cuda(
    pods: Any, nodes: Any, match_score: int = 10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nodenumber_select_hosts_kernel`` over table columns on one card,
    in one launch: the kernel evaluates ``tolerates_unschedulable`` from
    the pod's toleration columns itself.  The taint's hashes and the code
    constants come from ``plugins/nodeunschedulable.py`` and
    ``models/tables.py`` as kernel arguments."""
    device = nodes.valid.device
    if device.type != "cuda":
        raise ValueError(
            f"nodenumber_select_hosts_cuda needs CUDA tables, got {device}"
        )
    N = int(nodes.valid.shape[0])
    P = int(pods.valid.shape[0])
    T = int(pods.tol_key.shape[1]) if pods.tol_key.dim() == 2 else -1
    _check(nodes.unschedulable, "nodes.unschedulable", torch.bool, (N,), device)
    _check(nodes.suffix, "nodes.suffix", torch.int32, (N,), device)
    _check(nodes.valid, "nodes.valid", torch.bool, (N,), device)
    _check(pods.suffix, "pods.suffix", torch.int32, (P,), device)
    _check(pods.seed, "pods.seed", torch.int32, (P,), device)
    _check(pods.valid, "pods.valid", torch.bool, (P,), device)
    for name in ("tol_key", "tol_value", "tol_effect", "tol_op"):
        _check(getattr(pods, name), f"pods.{name}", torch.int32, (P, T), device)
    _check(pods.tol_empty_key, "pods.tol_empty_key", torch.bool, (P, T), device)
    _check(pods.num_tols, "pods.num_tols", torch.int32, (P,), device)
    choice = torch.empty(P, dtype=torch.int32, device=device)
    best = torch.empty(P, dtype=torch.int32, device=device)
    _launch("minisched_nodenumber_select_hosts", device,
            nodes.unschedulable.data_ptr(), nodes.suffix.data_ptr(),
            nodes.valid.data_ptr(), N, pods.suffix.data_ptr(),
            pods.seed.data_ptr(), pods.valid.data_ptr(),
            pods.tol_key.data_ptr(), pods.tol_value.data_ptr(),
            pods.tol_effect.data_ptr(), pods.tol_op.data_ptr(),
            pods.tol_empty_key.data_ptr(), pods.num_tols.data_ptr(), T, P,
            match_score, _UNSCHED_KEY_HASH, _EMPTY_VALUE_HASH,
            tables.EFFECT_NONE, tables.EFFECT_NO_SCHEDULE,
            tables.TOLERATION_OP_EXISTS_CODE, choice.data_ptr(),
            best.data_ptr())
    return choice, best


def nodenumber_launch_shape(device: torch.device) -> Tuple[int, int]:
    """(dynamic shared bytes a block, blocks resident at once) of the
    fused kernel on ``device``: the size of its persistent grid."""
    with torch.cuda.device(device):
        return (_kernel("minisched_nodenumber_smem_bytes")(),
                _kernel("minisched_nodenumber_resident_blocks")())


# ---------------------------------------------------------------------------
# dispatchers: the tensor's device decides the route
# ---------------------------------------------------------------------------


def select_hosts(
    scores: torch.Tensor, mask: torch.Tensor, seeds: torch.Tensor,
    node_base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched deterministic selectHost.

    scores i32[P, N] weighted totals; mask bool[P, N] feasibility; seeds
    i32[P] holding the u32 tie-break seeds.  Returns (choice i32[P], node
    index or -1; best_score i32[P]).  Among feasible max-score nodes the
    one minimizing mix32(seed, node_index) wins; hash ties go to the
    lowest index.  Column j is node ``node_base + j`` (a node shard's
    columns under a mesh).
    """
    if scores.device.type == "cuda":
        return select_hosts_cuda(scores, mask, seeds, node_base)
    if scores.device.type == "cpu":
        with _count_lock:
            plain_calls["select_hosts"] += 1
        return select_hosts_plain(scores, mask, seeds, node_base)
    raise ValueError(f"no select_hosts route for tensors on {scores.device}")


def select_hosts_merge(
    partials: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    seeds: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge node shards' ``select_hosts`` results (each with its shard's
    ``node_base``) into the whole row's: per pod, over the shards whose
    choice is >= 0, the lexicographic least (-best, mix32(seed, choice),
    choice) — the rule of ``_reduce_and_merge``
    (``minisched_tpu/ops/pallas_kernels.py:61``) across shards.  No
    feasible shard gives (-1, 0).  Plain torch on the partials' device: a
    merge step over (P, shards) values, not a kernel."""
    choice, best = partials[0]
    have = choice >= 0
    h = mix32_plain(seeds, choice.clamp(min=0))
    for c, b in partials[1:]:
        ok = c >= 0
        hc = mix32_plain(seeds, c.clamp(min=0))
        wins = ok & (~have | (b > best) | ((b == best) & (
            (hc < h) | ((hc == h) & (c < choice)))))
        choice = torch.where(wins, c, choice)
        best = torch.where(wins, b, best)
        h = torch.where(wins, hc, h)
        have = have | ok
    return (torch.where(have, choice, -1).to(torch.int32),
            torch.where(have, best, 0).to(torch.int32))


def nodenumber_select_hosts(
    pods: Any, nodes: Any, match_score: int = 10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(choice, best) of the NodeUnschedulable + NodeNumber chain, fused:
    the kernel for tables on a card, the plain twin for tables on the CPU."""
    device = nodes.valid.device
    if device.type == "cuda":
        return nodenumber_select_hosts_cuda(pods, nodes, match_score)
    if device.type == "cpu":
        with _count_lock:
            plain_calls["nodenumber_select_hosts"] += 1
        return nodenumber_select_hosts_plain(pods, nodes, match_score)
    raise ValueError(f"no route for tables on {device}")
