"""Recreate rollouts of one Deployment, closed loop.

A mix file (``traffic/<name>.json``, ``"generator": "recreate"``) gives:

* ``replicas``: the pods of one rollout, created in one call;
* ``pod``: their template (``cluster.PodTemplate``);
* ``warm_rollouts``: rollouts made in set-up, before the window, so the
  window meets no lane shape for the first time;
* ``trace_rollouts``: in a traced run, the rollouts the traced interval
  spans (it opens at the first creation past a third of the window);
* ``drain_s``: how long the drain after the window may wait for the last
  binds.

One controller rolls the Deployment with the Recreate strategy: once
every pod of a rollout is seen bound, it deletes them all and creates the
next rollout's, so each rollout starts from the cluster of set-up.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set, Tuple

from schedbench.cluster import PodPlan, PodTemplate

Actions = List[Tuple[str, List[PodPlan]]]


def rollout(index: int, replicas: int, seed: int, pod: PodTemplate
            ) -> List[PodPlan]:
    """The pods of rollout ``index``.  The seed enters the uids (and
    through them the program's tie-break seeds), never the sizes."""
    stem = f"r{index:05d}"
    tag = f"{seed % (1 << 64):x}"
    return [PodPlan(f"{stem}-{i:05d}", f"{tag}-{stem}-{i:05d}", pod)
            for i in range(replicas)]


class Recreate:
    """The controller's state, driven by the harness (which owns the
    store, the watch and the clock): ``start()``, ``on_bound(name)`` and
    ``release()`` return the actions to take in order, ``("delete",
    pods)`` and ``("create", pods)``.  While ``allow_new`` is off (the
    window's end), or once ``budget`` rollouts have started (set-up's warm
    ones), a completed rollout is held instead of followed; ``release``
    goes on."""

    def __init__(self, traffic: Dict[str, Any], seed: int):
        self.replicas = int(traffic["replicas"])
        self.pod = PodTemplate.from_json(traffic["pod"])
        self.seed = seed
        self.allow_new = True
        self.budget: Optional[int] = None
        self.holding = False
        #: rollouts wholly bound
        self.completed = 0
        self._started = 0
        self._live: List[PodPlan] = []
        self._pending: Set[str] = set()

    def start(self) -> Actions:
        return self._next()

    def _next(self) -> Actions:
        if not self.allow_new or (self.budget is not None
                                  and self._started >= self.budget):
            self.holding = True
            return []
        out: Actions = []
        if self._live:
            out.append(("delete", self._live))
        self._live = rollout(self._started, self.replicas, self.seed,
                             self.pod)
        self._started += 1
        self._pending = {p.name for p in self._live}
        out.append(("create", self._live))
        return out

    def on_bound(self, name: str) -> Actions:
        """A bind the watch saw: the next rollout's actions once it
        completes the current one."""
        if name not in self._pending:
            return []
        self._pending.discard(name)
        if self._pending:
            return []
        self.completed += 1
        return self._next()

    def release(self) -> Actions:
        if not self.holding:
            return []
        self.holding = False
        return self._next()

    def in_flight(self) -> int:
        return len(self._pending)


def make(traffic: Dict[str, Any], seed: int) -> Recreate:
    return Recreate(traffic, seed)
