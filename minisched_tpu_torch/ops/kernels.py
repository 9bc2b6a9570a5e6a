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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Tuple

import torch

from minisched_tpu_torch.plugins.nodeunschedulable import tolerates_unschedulable
from minisched_tpu_torch.utils import build

INT32_MIN = -(1 << 31)
UINT32_MAX = 0xFFFFFFFF

#: launches of each kernel since the last ``reset_launch_counts``; a
#: wrapper adds one where it launches its kernel and nowhere else
launch_counts = {"select_hosts": 0, "nodenumber_select_hosts": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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
    scores: torch.Tensor, mask: torch.Tensor, seeds: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The XLA tail of ``minisched_tpu/ops/fused.py:179-196`` in torch."""
    P, N = scores.shape
    if N == 0:
        return (torch.full((P,), -1, dtype=torch.int32, device=scores.device),
                torch.zeros((P,), dtype=torch.int32, device=scores.device))
    masked = torch.where(mask, scores, INT32_MIN)
    best = masked.max(dim=1).values  # i32[P]
    cand = mask & (masked == best[:, None])
    idx = torch.arange(N, device=scores.device)
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
    """The fused flagship chain with its (P, N) planes written out."""
    return nodenumber_body_plain(tolerates_unschedulable(pods), pods, nodes,
                                 match_score)


def nodenumber_body_plain(
    tol: torch.Tensor, pods: Any, nodes: Any, match_score: int = 10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin of the fused kernel's body: the chain after its
    ``tolerates_unschedulable`` prologue."""
    scores, mask = nodenumber_planes(tol, pods, nodes, match_score)
    return select_hosts_plain(scores, mask, pods.seed)


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

_ptr = ctypes.c_void_p
_int = ctypes.c_int
_SIGNATURES = {
    # scores, mask, seeds, P, N, choice, best, stream
    "minisched_select_hosts": (_ptr, _ptr, _ptr, _int, _int, _ptr, _ptr,
                               _ptr),
    # unsched, nsuffix, nvalid, N, tol, psuffix, seeds, pvalid, P,
    # match_score, choice, best, stream
    "minisched_nodenumber_select_hosts": (
        _ptr, _ptr, _ptr, _int, _ptr, _ptr, _ptr, _ptr, _int, _int, _ptr,
        _ptr, _ptr,
    ),
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
    launch_counts[name.removeprefix("minisched_")] += 1


def select_hosts_cuda(
    scores: torch.Tensor, mask: torch.Tensor, seeds: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``select_hosts_kernel``: scores i32[P, N], mask bool[P, N], seeds
    i32[P] (u32 bits), all on one card → (choice i32[P], best i32[P])."""
    device = scores.device
    if device.type != "cuda":
        raise ValueError(f"select_hosts_cuda needs CUDA tensors, got {device}")
    if scores.dim() != 2:
        raise ValueError(f"scores must be 2-D, got shape {tuple(scores.shape)}")
    P, N = scores.shape
    _check(scores, "scores", torch.int32, (P, N), device)
    _check(mask, "mask", torch.bool, (P, N), device)
    _check(seeds, "seeds", torch.int32, (P,), device)
    choice = torch.empty(P, dtype=torch.int32, device=device)
    best = torch.empty(P, dtype=torch.int32, device=device)
    _launch("minisched_select_hosts", device, scores.data_ptr(),
            mask.data_ptr(), seeds.data_ptr(), P, N, choice.data_ptr(),
            best.data_ptr())
    return choice, best


def nodenumber_select_hosts_cuda(
    pods: Any, nodes: Any, match_score: int = 10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nodenumber_select_hosts_kernel`` over table columns on one card.
    ``tolerates_unschedulable`` is a small tensor prologue, as on the TPU."""
    return nodenumber_body_cuda(tolerates_unschedulable(pods), pods, nodes,
                                match_score)


def nodenumber_body_cuda(
    tol: torch.Tensor, pods: Any, nodes: Any, match_score: int = 10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel alone, given its prologue's ``tol`` bool[P]."""
    device = nodes.valid.device
    if device.type != "cuda":
        raise ValueError(
            f"nodenumber_select_hosts_cuda needs CUDA tables, got {device}"
        )
    N = int(nodes.valid.shape[0])
    P = int(pods.valid.shape[0])
    _check(nodes.unschedulable, "nodes.unschedulable", torch.bool, (N,), device)
    _check(nodes.suffix, "nodes.suffix", torch.int32, (N,), device)
    _check(nodes.valid, "nodes.valid", torch.bool, (N,), device)
    _check(tol, "tolerates_unschedulable", torch.bool, (P,), device)
    _check(pods.suffix, "pods.suffix", torch.int32, (P,), device)
    _check(pods.seed, "pods.seed", torch.int32, (P,), device)
    _check(pods.valid, "pods.valid", torch.bool, (P,), device)
    choice = torch.empty(P, dtype=torch.int32, device=device)
    best = torch.empty(P, dtype=torch.int32, device=device)
    _launch("minisched_nodenumber_select_hosts", device,
            nodes.unschedulable.data_ptr(), nodes.suffix.data_ptr(),
            nodes.valid.data_ptr(), N, tol.data_ptr(), pods.suffix.data_ptr(),
            pods.seed.data_ptr(), pods.valid.data_ptr(), P, match_score,
            choice.data_ptr(), best.data_ptr())
    return choice, best


# ---------------------------------------------------------------------------
# dispatchers: the tensor's device decides the route
# ---------------------------------------------------------------------------


def select_hosts(
    scores: torch.Tensor, mask: torch.Tensor, seeds: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched deterministic selectHost.

    scores i32[P, N] weighted totals; mask bool[P, N] feasibility; seeds
    i32[P] holding the u32 tie-break seeds.  Returns (choice i32[P], node
    index or -1; best_score i32[P]).  Among feasible max-score nodes the
    one minimizing mix32(seed, node_index) wins; hash ties go to the
    lowest index.
    """
    if scores.device.type == "cuda":
        return select_hosts_cuda(scores, mask, seeds)
    if scores.device.type == "cpu":
        return select_hosts_plain(scores, mask, seeds)
    raise ValueError(f"no select_hosts route for tensors on {scores.device}")


def nodenumber_select_hosts(
    pods: Any, nodes: Any, match_score: int = 10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(choice, best) of the NodeUnschedulable + NodeNumber chain, fused:
    the kernel for tables on a card, the plain twin for tables on the CPU."""
    device = nodes.valid.device
    if device.type == "cuda":
        return nodenumber_select_hosts_cuda(pods, nodes, match_score)
    if device.type == "cpu":
        return nodenumber_select_hosts_plain(pods, nodes, match_score)
    raise ValueError(f"no route for tables on {device}")
