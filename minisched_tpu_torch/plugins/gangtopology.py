"""GangTopology: torus locality for gang members.

Counterpart of ``minisched_tpu/plugins/gangtopology.py``, both halves.  A
score plugin (no filter half: locality is a preference, never
feasibility) that pulls each gang member toward its placed peers.  The
scalar half builds the gang's placed aggregate from the snapshot in
PreScore (``engine.gang.gang_view_from_infos``) and scores each node with
``_score_one``; in the batch form the aggregate rides in five pod-table
columns (``engine/gang.py``) and the node side is the static slice
columns.

Scoring rule, in pure integers:

* singleton pods (``gang_id == 0``) and sliceless nodes score 0, so with no
  gang present the plane is all zero and placements are bit-identical to
  the chain without the plugin;
* warm gang (``gang_n > 0``): ``SLICE_BONUS`` on the gang's majority slice
  plus ``clamp(TORUS_MAX - dist, 0, TORUS_MAX)``, ``dist`` the ring
  distance to the placed centroid scaled by n: per axis
  ``a = |x·n − Σx|``, ``min(a mod n·D, n·D − a mod n·D)`` for the node's
  slice dimension ``D > 0``, else ``a``; ``dist = Σ axes // n``;
* cold gang: ``mix32(gang_id, slice_hash) >> 27`` (0..31), so every member
  of a gang ranks the slices alike.

Every (P, N) intermediate is int32, as in JAX, except the cold branch's
hash: CPU torch has no uint32 shift, so ``mix32`` runs on int64 holding
u32 values (``ops/kernels.mix32_plain``).  The plugin reads no committed
state, so the repair loop computes its plane once per wave.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from minisched_tpu_torch.api.objects import gang_key
from minisched_tpu_torch.engine.tiebreak import mix32 as mix32_py
from minisched_tpu_torch.framework.events import ActionType, ClusterEvent, GVK
from minisched_tpu_torch.framework.plugin import BatchEvaluable
from minisched_tpu_torch.framework.types import CycleState, Status
from minisched_tpu_torch.ops.kernels import mix32_plain
from minisched_tpu_torch.utils.hashing import fnv1a32

NAME = "GangTopology"
PRE_SCORE_STATE_KEY = "PreScore" + NAME

#: same-slice bonus: dominates the proximity term, so members pack onto
#: one slice before optimizing the distance inside it
SLICE_BONUS = 64
#: proximity band: nodes further than this many torus hops from the placed
#: centroid score 0 on the proximity term
TORUS_MAX = 32
_M32 = 0xFFFFFFFF


def _ring_scaled(delta: int, n: int, dim: int) -> int:
    """Scaled-by-n ring distance along one axis: ``delta`` is ``x·n − Σ``,
    ``dim`` the axis's ring size (0: the non-wrapping ``|delta|``)."""
    a = abs(delta)
    if dim <= 0:
        return a
    m = n * dim
    r = a % m
    return min(r, m - r)


def _score_one(gang_id: int, agg: Optional[Tuple[int, ...]], slice_hash: int,
               x: int, y: int, z: int,
               dims: Tuple[int, int, int] = (0, 0, 0)) -> int:
    """The scalar rule for one (pod, node): ``agg`` is the gang aggregate
    or None (cold), ``dims`` the node's slice dimensions
    (``engine.gang.node_dims``)."""
    if gang_id == 0 or slice_hash == 0:
        return 0
    if agg is None or agg[4] <= 0:
        return mix32_py(gang_id & _M32, slice_hash & _M32) >> 27
    maj, sx, sy, sz, n = agg
    score = SLICE_BONUS if (maj and slice_hash == maj) else 0
    dist = (_ring_scaled(x * n - sx, n, dims[0])
            + _ring_scaled(y * n - sy, n, dims[1])
            + _ring_scaled(z * n - sz, n, dims[2])) // n
    return score + min(max(TORUS_MAX - dist, 0), TORUS_MAX)


def _ring(coord: torch.Tensor, ssum: torch.Tensor, dim: torch.Tensor,
          n: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """The scaled ring distance of every (pod, node) along one axis."""
    a = (coord[None, :] * n).sub_(ssum[:, None]).abs_()  # (P, N)
    m = (nz * dim[None, :]).clamp_(min=1)
    r = a.remainder(m)
    wrapped = torch.minimum(r, m.sub_(r))
    return torch.where(dim[None, :] > 0, wrapped, a)


class GangTopology(BatchEvaluable):
    def events_to_register(self) -> List[ClusterEvent]:
        """The cluster events that may make a pod this plugin rejected
        schedulable again (the JAX plugin's registration)."""
        return [
            ClusterEvent(GVK.POD, ActionType.UPDATE),
            ClusterEvent(GVK.NODE, ActionType.ADD),
        ]

    def name(self) -> str:
        return NAME

    def pre_score(self, state: CycleState, pod: Any,
                  nodes: List[Any]) -> Status:
        key = gang_key(pod)
        if key is None:
            return Status.success()
        from minisched_tpu_torch.engine.gang import gang_view_from_infos

        try:
            node_infos = state.read("nodeinfos")
        except KeyError:
            return Status.success()  # no snapshot: the cold-start rule
        state.write(PRE_SCORE_STATE_KEY,
                    gang_view_from_infos(node_infos, keys={key}).get(key))
        return Status.success()

    def score(self, state: CycleState, pod: Any,
              node_name: str) -> Tuple[int, Status]:
        key = gang_key(pod)
        if key is None:
            return 0, Status.success()
        try:
            agg = state.read(PRE_SCORE_STATE_KEY)
        except KeyError:
            agg = None
        from minisched_tpu_torch.engine.gang import node_dims, node_topo

        node = state.read("nodeinfo/" + node_name).node
        sh, x, y, z = node_topo(node)
        return (_score_one(fnv1a32(key), agg, sh, x, y, z, node_dims(node)),
                Status.success())

    def score_extensions(self) -> None:
        return None

    def batch_score(self, ctx: Any, pods: Any, nodes: Any,
                    aux: Dict[str, Any]) -> torch.Tensor:
        P, N = pods.valid.shape[0], nodes.valid.shape[0]
        if not pods.use.gangs:  # no gang member in the table: all zero
            return torch.zeros((P, N), dtype=torch.int32,
                               device=pods.valid.device)
        sh = nodes.slice_hash[None, :]  # (1, N)
        gid = pods.gang_id[:, None]  # (P, 1)
        n = pods.gang_n[:, None]
        nz = n.clamp(min=1)
        dist = _ring(nodes.torus_x, pods.gang_sx, nodes.slice_dx, n, nz)
        dist += _ring(nodes.torus_y, pods.gang_sy, nodes.slice_dy, n, nz)
        dist += _ring(nodes.torus_z, pods.gang_sz, nodes.slice_dz, n, nz)
        dist = dist.div_(nz, rounding_mode="floor")
        warm = dist.neg_().add_(TORUS_MAX).clamp_(0, TORUS_MAX)  # proximity
        gs = pods.gang_slice[:, None]
        warm += ((sh == gs) & (gs != 0)).to(torch.int32) * SLICE_BONUS
        cold = (mix32_plain(gid, sh) >> 27).to(torch.int32)
        raw = torch.where(n > 0, warm, cold)
        live = (gid != 0) & (sh != 0)
        return raw.masked_fill_(~live, 0)
