"""Vectorized host oracle for the headline chain, in plain NumPy.

A copy of ``minisched_tpu/engine/oracle.py:38-115``: it re-derives the
decision rule of the NodeUnschedulable filter + NodeNumber score with the
seeded tie-break straight from the API objects — no tables, no torch, no
kernels — fast enough to check every placement of a 100k-pod run.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from minisched_tpu_torch.utils.hashing import pod_seed_batch


class OracleUnsupported(Exception):
    """The workload uses features outside this oracle's modeled chain."""


def mix32_np(seed, idx: np.ndarray) -> np.ndarray:
    """``engine.tiebreak.mix32`` vectorized (uint32 wraparound)."""
    x = np.asarray(seed, np.uint32) ^ (
        np.asarray(idx, np.uint32) * np.uint32(0x9E3779B9)
    )
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def _suffix(name: str) -> int:
    return int(name[-1]) if name and name[-1].isdigit() else -1


def headline_oracle(pods: Sequence[Any], nodes: Sequence[Any]) -> np.ndarray:
    """Choices (node row index, -1 = unschedulable) for the chain
    [NodeUnschedulable] / [NodeNumber], for every pod: among schedulable
    nodes prefer those whose trailing digit matches the pod's, then the
    minimal mix32(pod_seed, node_index), then the lowest index.  Pods
    without a digit suffix error in the scalar Score, so they raise."""
    n = len(nodes)
    unsched = np.fromiter(
        (node.spec.unschedulable for node in nodes), bool, count=n
    )
    node_suf = np.fromiter(
        (_suffix(node.metadata.name) for node in nodes), np.int64, count=n
    )
    feasible = np.flatnonzero(~unsched)
    pod_suf = np.fromiter(
        (_suffix(p.metadata.name) for p in pods), np.int64, count=len(pods)
    )
    if (pod_suf < 0).any():
        raise OracleUnsupported("pod without digit suffix (Score errors)")
    seeds = pod_seed_batch([p.metadata.uid or p.metadata.name for p in pods])

    choices = np.full(len(pods), -1, np.int64)
    if feasible.size == 0:
        return choices
    for d in range(10):
        rows = np.flatnonzero(pod_suf == d)
        if rows.size == 0:
            continue
        cand = feasible[node_suf[feasible] == d]
        if cand.size == 0:
            cand = feasible
        # argmin is the first minimum: lowest index wins hash ties
        hm = mix32_np(seeds[rows, None], cand[None, :])
        choices[rows] = cand[np.argmin(hm, axis=1)]
    return choices
