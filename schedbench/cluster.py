"""The cluster of a configuration and the pods' shapes, made from the seed
as plain data.

Both sides take what this module makes: the harness turns it into the
program's API objects (``harness.py``) and the reference
(``reference.py``) reads it as it is.  Nothing here imports the program.

A configuration file (``configs/<name>.json``) gives:

* ``nodes``, ``node_name`` (a ``str.format`` pattern of the index,
  zero-padded so that name order is index order), ``node_allocatable``
  (``cpu_m``, ``memory_mib``, ``pods``);
* ``node_labels``: a list of ``{"key": k, "from": "name"}`` (the node's
  own name, as ``kubernetes.io/hostname`` is) and ``{"key": k,
  "round_robin": [values]}`` (node ``i`` takes value ``i % len``);
* ``initial_pods``: ``{"count": n, "pod": <pod template>}``, pods bound
  at set-up, each to a node drawn from the seed among those that still
  have room for it;
* ``namespace``: every pod's.

A pod template (here and in a traffic mix) is ``{"requests": {"cpu_m",
"memory_mib"}, "labels": {...}, "spread": [constraint, ...]}``, each
constraint ``{"topology_key", "max_skew", "when_unsatisfiable",
"match_labels"}``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of the seed (any whole
    number; negative ones and those past 64 bits are folded in)."""
    return np.random.default_rng([seed % (1 << 64), stream])


@dataclass(frozen=True)
class Spread:
    """One topology-spread constraint of a pod."""

    topology_key: str
    max_skew: int
    when_unsatisfiable: str
    #: the label selector's ``matchLabels``, as sorted (key, value) pairs
    match_labels: Tuple[Tuple[str, str], ...]

    @property
    def hard(self) -> bool:
        return self.when_unsatisfiable == "DoNotSchedule"

    def selects(self, labels: Tuple[Tuple[str, str], ...]) -> bool:
        return set(self.match_labels) <= set(labels)


@dataclass(frozen=True)
class PodTemplate:
    """The shape of a pod: its requests, labels and spread constraints."""

    cpu_m: int
    memory_mib: int
    labels: Tuple[Tuple[str, str], ...] = ()
    spread: Tuple[Spread, ...] = ()

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "PodTemplate":
        req = d["requests"]
        return PodTemplate(
            cpu_m=int(req["cpu_m"]), memory_mib=int(req["memory_mib"]),
            labels=tuple(sorted(d.get("labels", {}).items())),
            spread=tuple(
                Spread(c["topology_key"], int(c["max_skew"]),
                       c.get("when_unsatisfiable", "DoNotSchedule"),
                       tuple(sorted(c["match_labels"].items())))
                for c in d.get("spread", ())))


@dataclass(frozen=True)
class PodPlan:
    """One pod a traffic generator creates: its name, its uid (the seed
    enters here, and through it the tie-break) and its shape."""

    name: str
    uid: str
    pod: PodTemplate


@dataclass
class Cluster:
    """Nodes in name order (the order of the program's node table) and the
    pods bound at set-up."""

    names: List[str]
    cpu_m: np.ndarray  # int64[N] allocatable
    memory_mib: np.ndarray  # int64[N]
    pods: np.ndarray  # int64[N]
    #: label key → each node's value, in node order
    labels: Dict[str, List[str]]
    namespace: str
    initial_pod: PodTemplate
    #: (pod name, node index) of the pods bound at set-up
    initial: List[tuple]

    def node_labels(self, i: int) -> Dict[str, str]:
        return {k: v[i] for k, v in self.labels.items()}


def make_cluster(config: Dict[str, Any], seed: int) -> Cluster:
    n = int(config["nodes"])
    alloc = config["node_allocatable"]
    names = [config["node_name"].format(i) for i in range(n)]
    if names != sorted(names):
        raise ValueError("node names must sort in index order")
    labels: Dict[str, List[str]] = {}
    for spec in config.get("node_labels", ()):
        if spec.get("from") == "name":
            labels[spec["key"]] = list(names)
        else:
            values = spec["round_robin"]
            labels[spec["key"]] = [values[i % len(values)]
                                   for i in range(n)]
    cpu = np.full(n, int(alloc["cpu_m"]), np.int64)
    mem = np.full(n, int(alloc["memory_mib"]), np.int64)
    cap = np.full(n, int(alloc["pods"]), np.int64)
    init = config["initial_pods"]
    pod = PodTemplate.from_json(init["pod"])
    room = cap.copy()
    if pod.cpu_m:
        room = np.minimum(room, cpu // pod.cpu_m)
    if pod.memory_mib:
        room = np.minimum(room, mem // pod.memory_mib)
    initial = _fill(room, int(init["count"]), rng_for(seed, 2))
    return Cluster(
        names=names, cpu_m=cpu, memory_mib=mem, pods=cap, labels=labels,
        namespace=config.get("namespace", "default"), initial_pod=pod,
        initial=[(f"init{i:06d}", int(j)) for i, j in enumerate(initial)])


def _fill(room: np.ndarray, count: int, rng: np.random.Generator
          ) -> np.ndarray:
    """``count`` node indices, each drawn uniformly among the nodes that
    still have room when its turn comes (drawn in rounds: a round's
    draws that overflow a node are drawn again)."""
    if count > int(room.sum()):
        raise ValueError(f"{count} initial pods do not fit the cluster")
    left = room.copy()
    out = np.empty(count, np.int64)
    todo = np.arange(count)
    while todo.size:
        open_nodes = np.flatnonzero(left > 0)
        pick = open_nodes[rng.integers(0, open_nodes.size, todo.size)]
        # keep, per node, only as many of this round's draws as it has room
        order = np.argsort(pick, kind="stable")
        sorted_pick = pick[order]
        first = np.searchsorted(sorted_pick, sorted_pick, side="left")
        rank = np.empty_like(order)
        rank[order] = np.arange(order.size) - first
        ok = rank < left[pick]
        out[todo[ok]] = pick[ok]
        np.subtract.at(left, pick[ok], 1)
        todo = todo[~ok]
    return out
