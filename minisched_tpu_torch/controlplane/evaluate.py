"""The body of the gRPC ``Evaluate`` call: schedule one cluster, statelessly.

Counterpart of ``minisched_tpu/controlplane/grpcserver.py:109-188``
(``_mode_evaluator``, ``evaluate_cluster``).  A request is a dict of JSON
objects (``controlplane/codec.py``): ``nodes``, ``pods`` (pending),
``assigned``, ``pvcs``, ``pvs`` and ``mode``.  The pods are placed with the
full default roster, in one ``"wave"`` (``FusedEvaluator``) or in
conflict-repairing rounds (``"repair"``, the default:
``RepairingEvaluator``), and the answer is::

    {"placements": {"namespace/name": node name or None}, "rounds": n}

The gRPC servicer around it is ``controlplane/grpcserver.py``.

Usage::

    from minisched_tpu_torch.controlplane.evaluate import evaluate_cluster
    out = evaluate_cluster({"nodes": [...], "pods": [...], "mode": "repair"})
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import torch

from minisched_tpu_torch import resolve_device
from minisched_tpu_torch.controlplane.codec import KIND_TYPES, _decode
from minisched_tpu_torch.headline import pods_by_node
from minisched_tpu_torch.models.constraints import build_constraint_tables
from minisched_tpu_torch.models.tables import build_node_table, build_pod_table
from minisched_tpu_torch.ops.fused import FusedEvaluator
from minisched_tpu_torch.ops.repair import RepairingEvaluator
from minisched_tpu_torch.plugins.registry import build_plugins
from minisched_tpu_torch.service.config import default_full_roster_config
from minisched_tpu_torch.utils import build

MODES = ("wave", "repair")

#: (mode, device) → evaluator, built once: a repair evaluator's
#: construction runs the static-classification probe
_EVALUATORS: Dict[Any, Any] = {}
_EVALUATORS_LOCK = threading.Lock()


def _mode_evaluator(mode: str, device: torch.device):
    """The full default roster's evaluator of ``mode``, cached by (mode,
    device)."""
    with _EVALUATORS_LOCK:
        key = (mode, device)
        if key not in _EVALUATORS:
            cfg = default_full_roster_config()
            chains = build_plugins(cfg)
            cls = FusedEvaluator if mode == "wave" else RepairingEvaluator
            _EVALUATORS[key] = cls(chains.filter, chains.pre_score,
                                   chains.score, weights=cfg.score_weights())
        return _EVALUATORS[key]


def evaluate_cluster(request: dict, device=None,
                     times: Optional[Dict[str, float]] = None) -> dict:
    """Schedule the request's pending pods against its nodes: a pure
    function of the request.  ``device=None`` means the card.  Raises
    ``ValueError`` for an unknown mode or a malformed request.
    ``times``, if given, receives the host seconds of the call's parts:
    ``decode``, ``build`` (tables) and ``evaluate`` (the device call and
    the read of its choices)."""
    mode = request.get("mode", "repair")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (wave|repair)")
    device = resolve_device(device)
    times = {} if times is None else times

    def decode_list(key: str, kind: str):
        return [_decode(KIND_TYPES[kind], o) for o in request.get(key, ())]

    # decoding and the table builds read the caller's payload: a failure
    # there is a bad argument; one in the evaluator is not
    try:
        t0 = time.monotonic()
        nodes = sorted(decode_list("nodes", "Node"),
                       key=lambda n: n.metadata.name)
        pods = decode_list("pods", "Pod")
        assigned = decode_list("assigned", "Pod")
        pvcs = decode_list("pvcs", "PersistentVolumeClaim")
        pvs = decode_list("pvs", "PersistentVolume")
        times["decode"] = time.monotonic() - t0
        if not nodes or not pods:
            return {"placements": {}, "rounds": 0}
        t0 = time.monotonic()
        node_table, node_names = build_node_table(
            nodes, pods_by_node(assigned), device=device)
        pod_table, _ = build_pod_table(pods, device=device)
        extra = build_constraint_tables(
            pods, nodes, assigned, pod_capacity=pod_table.capacity,
            node_capacity=node_table.capacity, pvcs=pvcs, pvs=pvs,
            scan_planes=False, device=device)
        times["build"] = time.monotonic() - t0
    except (TypeError, AttributeError) as err:
        raise ValueError(f"malformed request: {err}") from err
    t0 = time.monotonic()
    if device.type == "cuda":
        build.load_library()
    ev = _mode_evaluator(mode, device)
    if mode == "wave":
        choice, rounds = ev(pod_table, node_table, extra).choice, 1
    else:
        out = ev(pod_table, node_table, extra)
        choice, rounds = out.choice, out.rounds
    rows = choice[: len(pods)].tolist()
    times["evaluate"] = time.monotonic() - t0
    placements = {pod.metadata.key: (node_names[c] if c >= 0 else None)
                  for pod, c in zip(pods, rows)}
    return {"placements": placements, "rounds": rounds}
