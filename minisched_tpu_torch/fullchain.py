"""Config 5 of the JAX package: repair waves with the node-local roster.

Counterpart of the config-5 flow of ``bench.py`` (``_c5_cluster`` and the
live wave's ``RepairingEvaluator``): the cluster's objects, and
``schedule_repair_waves``, which runs them through the wave driver's
``"repair"`` route (``headline.schedule_waves``): every wave runs
evaluate-accept-commit rounds (``ops/repair.py``) until its pods are
placed or have no feasible node, and the updated table carries to the
next wave.  Every round ends in ``select_hosts``, the hand-written
seeded-argmax kernel on a card.  The roster is
``service.config.node_local_roster_config``: the full default roster
without the plugins that read constraint tables.

Usage (on the card)::

    from minisched_tpu_torch.fullchain import mk_c5_cluster, schedule_repair_waves
    nodes, pods = mk_c5_cluster()
    run = schedule_repair_waves(nodes, pods)
    print(run.rounds, run.schedule_s, len(pods) / run.schedule_s)
"""

from __future__ import annotations

import random
from typing import Any, List, Sequence, Tuple

from minisched_tpu_torch.api.objects import make_node, make_pod
from minisched_tpu_torch.headline import WaveRun, schedule_waves

WAVE = 16_384  # pods per wave of the config-5 run
C5_REQUESTS = {"cpu": "500m", "memory": "256Mi"}


def mk_c5_cluster(n_nodes: int = 10_000,
                  n_pods: int = 100_000) -> Tuple[List[Any], List[Any]]:
    """The config-5 cluster (the objects of ``bench.py`` ``_c5_cluster``,
    without the control plane): ``n_nodes`` nodes ``node00000`` … of 8
    CPU, 16 Gi and 110 pods, zone labels ``z0`` … ``z15``, each cordoned
    with probability 0.2 from ``random.Random(55)``; ``n_pods`` pods asking
    for 500m and 256 Mi, of which the last 2% (``special*``) carry a node
    selector no node matches."""
    rng = random.Random(55)
    nodes = [
        make_node(
            f"node{i:05d}",
            unschedulable=rng.random() < 0.2,
            capacity={"cpu": "8", "memory": "16Gi", "pods": 110},
            labels={"zone": f"z{i % 16}"},
        )
        for i in range(n_nodes)
    ]
    n_special = max(n_pods // 50, 1)
    pods = [make_pod(f"pod{i:06d}", requests=C5_REQUESTS)
            for i in range(n_pods - n_special)]
    pods += [make_pod(f"special{i:05d}", requests=C5_REQUESTS,
                      node_selector={"special": "true"})
             for i in range(n_special)]
    return nodes, pods


def schedule_repair_waves(nodes: Sequence[Any], pods: Sequence[Any],
                          wave: int = WAVE, device=None) -> WaveRun:
    """Schedule ``pods`` against ``nodes`` in repair waves of ``wave``
    (``schedule_waves`` on the ``"repair"`` route).  ``device=None`` means
    the card (and raises without one); ``device="cpu"`` runs the plain
    twins on the host."""
    return schedule_waves(nodes, pods, wave=wave, route="repair",
                          device=device)
