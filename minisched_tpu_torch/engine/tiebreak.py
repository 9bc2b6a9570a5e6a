"""Deterministic host-selection tie-break, scalar form.

A copy of ``minisched_tpu/engine/tiebreak.py``: among max-score nodes,
pick the node minimizing ``mix32(pod_seed, node_index)``; remaining ties
go to the lowest index.  The kernels and their plain twins
(``ops/kernels.py``) evaluate the same 32-bit ops.
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF


def mix32(seed: int, idx: int) -> int:
    """murmur3-finalizer-style mix of (seed, idx) → uint32."""
    x = (seed ^ ((idx * 0x9E3779B9) & _M32)) & _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    x ^= x >> 16
    return x


def select_host(scores, feasible, seed: int) -> int:
    """Argmax score over feasible node indices; ties broken by minimal
    mix32(seed, idx).  Returns -1 if nothing is feasible."""
    best_idx = -1
    best_score = None
    best_hash = None
    for idx, (score, ok) in enumerate(zip(scores, feasible)):
        if not ok:
            continue
        h = mix32(seed, idx)
        if (
            best_idx < 0
            or score > best_score
            or (score == best_score and h < best_hash)
        ):
            best_idx, best_score, best_hash = idx, score, h
    return best_idx
