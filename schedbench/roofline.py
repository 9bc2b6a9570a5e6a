"""The yardstick of the kernels: the card's peaks and the work of a launch.

Frozen here so that a change to the program cannot move it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside
the tensor cores.  The data sheet gives no integer rate; the int32 rate
below is derived, not published: 67 TFLOP/s counts a fused multiply-add
as two operations, so 33.5 T float32 instructions a second, and an SM
issues int32 arithmetic on 64 lanes a clock against float32's 128, which
halves it to 16.75 T operations a second.

``select_hosts`` (``csrc/select_hosts.cu``) takes a (P, N) int32 score
plane and a (P, N) bool mask at the node table's width N, the node count
padded to 128 lanes, and each pod's seed, and writes each pod's choice
and best score.  Its least work: a 4-byte score and a 1-byte mask read per
pair, the seed read and two 4-byte outputs written per pod; a compare and
a running max per pair, and a ``mix32`` (3 multiplies, 3 shifts, 4 xors)
and a compare per candidate at the row's maximum.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
#: derived (see the module docstring), not a published figure
INT32_OPS_PER_S = 67e12 / 2 / 2
MIX32_OPS = 11
LANES = 128


def node_width(n_nodes: int) -> int:
    """The node table's width: the node count padded to 128 lanes."""
    return max(-(-n_nodes // LANES), 1) * LANES


def select_work(p: int, n: int, candidates: int) -> Tuple[int, int]:
    """(bytes, int32 operations) of one ``select_hosts`` launch over a
    (p, n) plane with ``candidates`` pairs at their row's maximum."""
    return (p * n * 5 + p * 4 + 2 * p * 4,
            2 * p * n + MIX32_OPS * candidates)


def least_seconds(p: int, n: int, candidates: int) -> Tuple[float, str]:
    """The least time of one launch and what bounds it."""
    nbytes, ops = select_work(p, n, candidates)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
