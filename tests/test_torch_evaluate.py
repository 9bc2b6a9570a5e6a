"""The body of gRPC ``Evaluate`` and the score matrices, against the JAX
package's.

The same request dict, encoded from the JAX package's objects with every
feature the port's plugins read (slices, gangs, taints and tolerations,
node selectors, host ports, images, pod (anti-)affinity, topology spread,
claims and volumes), goes through both packages' ``evaluate_cluster`` in
both modes: equal placements and rounds.  The port's codec keeps every
field its objects have.  A bad mode and a malformed request raise
``ValueError`` (``tests/test_grpc.py`` ``test_bad_mode_is_invalid_argument``
raises ``INVALID_ARGUMENT`` from the same check), and repair never
overcommits a node (``test_evaluate_repair_never_overcommits``).
``PlacementResult.score_matrices`` and ``raw_score_matrices`` with
diagnostics equal JAX's, plane for plane.  Tolerance 0.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from minisched_tpu.api import objects as jobj
from minisched_tpu.controlplane import checkpoint as jcodec
from minisched_tpu.controlplane.grpcserver import evaluate_cluster as jevaluate
from minisched_tpu.ops import fused as jfused
from minisched_tpu.plugins.registry import build_plugins as jbuild_plugins
from minisched_tpu.service import config as jconfig

from minisched_tpu_torch.api import objects as tobj
from minisched_tpu_torch.controlplane import codec as tcodec
from minisched_tpu_torch.controlplane.evaluate import evaluate_cluster
from minisched_tpu_torch.ops import fused as tfused
from minisched_tpu_torch.plugins.registry import build_plugins
from minisched_tpu_torch.service import config as tconfig

from tests.test_torch_constraints import constraint_cluster
from tests.test_torch_crosspod import both_waves


def feature_request(seed: int = 4):
    """(request dict, JAX objects by kind) of a cluster with every feature
    the port reads."""
    nodes, assigned, pods, pvcs, pvs = constraint_cluster(
        jobj, seed, n_nodes=48, n_assigned=40, n_pods=96,
        requests={"cpu": "2", "memory": "1Gi"})
    for i, node in enumerate(sorted(nodes, key=lambda n: n.metadata.name)):
        node.spec.slice_id, node.spec.host_index = f"slice{i // 8}", i % 8
        node.spec.torus_x, node.spec.torus_y = i % 4, (i // 4) % 2
        if i % 16 < 8:
            node.spec.slice_dx, node.spec.slice_dy, node.spec.slice_dz = 4, 2, 1
        if i % 5 == 0:
            node.spec.taints = [jobj.Taint("dedicated", "infra", "NoSchedule")]
    for i, pod in enumerate(pods):
        if i % 4 == 0:
            pod.spec.tolerations = [jobj.Toleration(
                key="dedicated", operator="Equal", value="infra",
                effect="NoSchedule")]
        if i % 7 == 0:
            pod.spec.gang = jobj.GangSpec(f"gang{i % 3}", 4)
        if i % 6 == 0:
            pod.spec.containers[0].ports = [8000 + i % 2]
            pod.spec.containers[0].image = f"img{i % 3}"
        if i % 11 == 0:
            pod.spec.node_selector = {"disk": "ssd"}
    objects = {"nodes": nodes, "pods": pods, "assigned": assigned,
               "pvcs": pvcs, "pvs": pvs}
    request = {key: [jcodec._encode(o) for o in objs]
               for key, objs in objects.items()}
    return request, objects


@pytest.fixture(scope="module")
def request_():
    return feature_request()


@pytest.mark.parametrize("mode", ["wave", "repair"])
def test_evaluate_matches_jax(mode, request_):
    request, _ = request_
    request = dict(request, mode=mode)
    want = jevaluate(copy.deepcopy(request))
    got = evaluate_cluster(request, device="cpu")
    assert got == want
    placed = [v for v in got["placements"].values() if v is not None]
    assert 0 < len(placed) < len(request["pods"])
    assert got["rounds"] == (1 if mode == "wave" else want["rounds"])


def test_codec_keeps_every_field_the_port_has(request_):
    """A JAX-encoded object decodes into the port's objects and encodes
    back to the same document, less the fields the port's objects lack."""
    request, _ = request_

    def strip(doc, kind):
        doc = copy.deepcopy(doc)
        if kind == "Pod":
            doc["status"].pop("conditions")
            doc["spec"].pop("scheduler_name")
        return doc

    kinds = {"nodes": "Node", "pods": "Pod", "assigned": "Pod",
             "pvcs": "PersistentVolumeClaim", "pvs": "PersistentVolume"}
    for key, kind in kinds.items():
        for doc in request[key]:
            obj = tcodec._decode(tcodec.KIND_TYPES[kind], doc)
            assert tcodec._encode(obj) == strip(doc, kind), kind
    gang = [tcodec._decode(tobj.Pod, d) for d in request["pods"]]
    assert any(isinstance(p.spec.gang, tobj.GangSpec) for p in gang)
    assert {tobj.gang_key(p) for p in gang} - {None}
    node = tcodec._decode(tobj.Node, request["nodes"][0])
    assert node.spec.slice_id and node.spec.taints


def test_bad_mode_and_malformed_request_raise_value_error(request_):
    request, _ = request_
    for evaluate in (jevaluate, lambda r: evaluate_cluster(r, device="cpu")):
        with pytest.raises(ValueError, match="unknown mode"):
            evaluate({"nodes": [], "pods": [], "mode": "bogus"})
        bad = dict(request, mode="wave", nodes=[{"metadata": 5}])
        with pytest.raises(ValueError, match="malformed request"):
            evaluate(bad)
    assert evaluate_cluster({"nodes": request["nodes"], "pods": []},
                            device="cpu") == {"placements": {}, "rounds": 0}


def test_evaluate_repair_never_overcommits():
    nodes = [tobj.make_node(f"n{i}", capacity={"cpu": "1", "memory": "4Gi",
                                               "pods": 110})
             for i in range(3)]
    pods = [tobj.make_pod(f"p{i}", requests={"cpu": "600m"}) for i in range(6)]
    out = evaluate_cluster({"nodes": [tcodec._encode(n) for n in nodes],
                            "pods": [tcodec._encode(p) for p in pods],
                            "mode": "repair"}, device="cpu")
    per_node = {}
    for node in out["placements"].values():
        if node is not None:
            per_node[node] = per_node.get(node, 0) + 1
    assert sum(per_node.values()) == 3 and set(per_node.values()) == {1}
    assert out["rounds"] >= 1


def test_score_matrices_match_jax(request_):
    """The full roster with diagnostics: filter masks, weighted score
    planes and raw score planes equal the JAX evaluate's."""
    _, objs = request_
    (jn, jp, je), (tn, tp, te) = both_waves(
        objs["nodes"], objs["assigned"], objs["pods"], objs["pvcs"],
        objs["pvs"], scan_planes=False)
    cfg = jconfig.default_full_roster_config()
    jchains = jbuild_plugins(cfg)
    want = jfused.FusedEvaluator(jchains.filter, jchains.pre_score,
                                 jchains.score, weights=cfg.score_weights(),
                                 with_diagnostics=True)(jp, jn, je)
    tcfg = tconfig.default_full_roster_config()
    chains = build_plugins(tcfg)
    got = tfused.FusedEvaluator(chains.filter, chains.pre_score, chains.score,
                                weights=tcfg.score_weights(),
                                with_diagnostics=True)(tp, tn, te)
    for name in ("choice", "best_score", "feasible_count", "filter_masks",
                 "score_matrices", "raw_score_matrices"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.score_matrices.dtype == got.raw_score_matrices.dtype == torch.int32
    assert got.score_matrices.shape[0] == len(chains.score) == 7
    # a weighted plane differs from its raw one where normalize or the
    # weight changes it (PodTopologySpread weighs 2)
    assert not torch.equal(got.score_matrices, got.raw_score_matrices)
    plain = tfused.FusedEvaluator(chains.filter, chains.pre_score,
                                  chains.score,
                                  weights=tcfg.score_weights())(tp, tn, te)
    assert plain.score_matrices is None and plain.raw_score_matrices is None
    assert torch.equal(plain.choice, got.choice)
