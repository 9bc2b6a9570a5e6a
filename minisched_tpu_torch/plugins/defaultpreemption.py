"""DefaultPreemption: the in-tree PostFilter plugin.

A copy of ``minisched_tpu/plugins/defaultpreemption.py`` (upstream v1.22
``defaultpreemption``, simplified as the JAX package simplifies it):

* Runs when filtering leaves no feasible node.  Candidate nodes are those
  whose filter verdict was not UnschedulableAndUnresolvable (no eviction
  fixes those), capped at ``max(min_candidate_nodes_absolute, pct% of
  nodes)``.
* Victims on a candidate node follow upstream's ``selectVictimsOnNode``:
  remove every assigned pod of lower priority; if the pod still fails the
  filter chain, the node is no candidate; otherwise reprieve the removed
  pods one at a time, most important first (higher priority, then earlier
  creation, then name), keeping each that leaves the pod feasible.  The
  pods that cannot come back are the victims.  A gang member is never a
  victim (``gang.preempt_shielded`` counts the ones skipped).
* The best candidate follows ``pickOneNodeForPreemption`` (no PDBs):
  least highest victim priority, then least priority sum, then fewest
  victims, then the latest earliest creation among the highest-priority
  victims, then node name.  Its victims are deleted through the client
  and recorded in ``last_victims``; the nominated node is returned, and
  the pod requeues once the informer sees the deletions.

The dry run calls the scalar filter halves of the engine's filter chain
(``h.filter_plugins``; ``h`` is the engine, injected as the waiting-pod
handle is).  One pre-filter pass per loser is shared by every probe when
the pod's own terms cannot change with evictions; a NodeResourcesFit
probe on an incrementally kept NodeInfo marks a reprieve that overcommits
the node without running the whole chain.

The live engines call ``post_filter`` only behind the gate
``preemption_might_help`` (``NODE_STATIC_PLUGINS``): a loser that failed
only on filters whose verdict no eviction can change never reaches it.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from minisched_tpu_torch.api.objects import gang_key
from minisched_tpu_torch.engine.scheduler import (
    run_filter_plugins,
    run_pre_filter_plugins,
)
from minisched_tpu_torch.framework.nodeinfo import NodeInfo, build_node_infos
from minisched_tpu_torch.framework.plugin import Plugin, implements_pre_filter
from minisched_tpu_torch.framework.types import CycleState, Status, is_success
from minisched_tpu_torch.observability import counters
from minisched_tpu_torch.plugins.noderesources import NodeResourcesFit
from minisched_tpu_torch.plugins.simulator import SUFFIX

NAME = "DefaultPreemption"

DEFAULT_MIN_CANDIDATE_NODES_PERCENTAGE = 10
DEFAULT_MIN_CANDIDATE_NODES_ABSOLUTE = 100

REASON_NO_CANDIDATES = "preemption: no candidate node frees enough resources"
REASON_CANNOT_HELP = "preemption: pod failures are not pod-dependent"

#: in-tree filters whose verdict never depends on which pods are assigned —
#: evicting pods cannot flip them, so a pod that failed ONLY on these is
#: ineligible for preemption (the batch analog of upstream's per-node
#: UnschedulableAndUnresolvable statuses).  Unknown plugin names are
#: conservatively treated as resolvable.
NODE_STATIC_PLUGINS = frozenset(
    {
        "NodeUnschedulable",
        "NodeName",
        "NodeAffinity",
        "TaintToleration",
        "VolumeZone",
        "VolumeBinding",
    }
)


def preemption_might_help(diagnosis: Any) -> bool:
    """False when every recorded failure is a node-static filter (see
    NODE_STATIC_PLUGINS).  An empty failure set is conservatively True.

    Simulator-wrapped plugins fail under their ``<name>ForSimulator``
    alias (``plugins/simulator.py``): the comparison strips the suffix, so
    ``record_results`` keeps the same preemption gating."""
    failed = getattr(diagnosis, "unschedulable_plugins", None)
    if not failed:
        return True
    return bool({name.removesuffix(SUFFIX) for name in failed}
                - NODE_STATIC_PLUGINS)


class DefaultPreemption(Plugin):
    def __init__(
        self,
        min_candidate_nodes_percentage: int = DEFAULT_MIN_CANDIDATE_NODES_PERCENTAGE,
        min_candidate_nodes_absolute: int = DEFAULT_MIN_CANDIDATE_NODES_ABSOLUTE,
    ):
        self.min_candidate_nodes_percentage = min_candidate_nodes_percentage
        self.min_candidate_nodes_absolute = min_candidate_nodes_absolute
        #: the engine (filter chain and client), injected by its builder
        self.h: Any = None
        #: victims deleted by the most recent post_filter call (the
        #: engine's wave-loser pass reads and clears it)
        self.last_victims: List[Any] = []

    def name(self) -> str:
        return NAME

    def _max_candidates(self, n_nodes: int) -> int:
        by_pct = n_nodes * self.min_candidate_nodes_percentage // 100
        return max(min(max(by_pct, self.min_candidate_nodes_absolute),
                       n_nodes), 1)

    @staticmethod
    def _own_terms_trivial(pod: Any) -> bool:
        """True when evictions cannot change the pod's OWN pre-filter
        state: no pod (anti-)affinity terms and no DoNotSchedule spread
        constraint.  What remains of the pre-filter (the assigned pods'
        reverse anti-affinity) is reused across probes conservatively: a
        victim's ban may outlive its dry-run eviction, so a feasible
        candidate can be missed but never wrongly accepted."""
        aff = pod.spec.affinity
        if aff is not None and (aff.pod_affinity is not None
                                or aff.pod_anti_affinity is not None):
            return False
        return not any(c.when_unsatisfiable == "DoNotSchedule"
                       for c in pod.spec.topology_spread_constraints)

    def _shared_prefilter_state(self, pod: Any, node_infos: List[NodeInfo]
                                ) -> Optional[CycleState]:
        """ONE pre-filter pass against the base snapshot, reused by every
        probe of this loser (see ``_own_terms_trivial``).  None when the
        chain has no pre-filter or the pod's own terms need an exact pass
        per probe; a state marked infeasible when the pre-filter itself
        rejects."""
        filters = self.h.filter_plugins
        if not any(implements_pre_filter(pl) for pl in filters):
            return None
        if not self._own_terms_trivial(pod):
            return None
        # no "nodeinfo/*" writes: the filters read their pre-filter keys
        # only (scoring, which reads those, never runs in a probe)
        state = CycleState()
        status, _ = run_pre_filter_plugins(filters, state, pod, node_infos)
        if not is_success(status):
            state.write("preempt/prefilter-failed", True)
        return state

    def _feasible_after(self, pod: Any, target: NodeInfo, remaining: List[Any],
                        node_infos: List[NodeInfo],
                        shared_state: Optional[CycleState] = None) -> bool:
        """Would the pod pass the whole filter chain on ``target`` with only
        ``remaining`` assigned there?  With ``shared_state`` the probe reads
        the loser's shared pre-filter artifacts; otherwise, where some
        filter pre-filters, the pre-filter runs against the snapshot with
        ``target`` substituted, so cross-pod counts see the evictions."""
        filters = self.h.filter_plugins
        [trimmed] = build_node_infos([target.node], remaining)
        if shared_state is not None:
            try:
                if shared_state.read("preempt/prefilter-failed"):
                    return False
            except KeyError:
                pass
            state = shared_state
        else:
            state = CycleState()
            if any(implements_pre_filter(pl) for pl in filters):
                infos = [trimmed if ni.name == target.name else ni
                         for ni in node_infos]
                for ni in infos:
                    state.write("nodeinfo/" + ni.name, ni)
                state.write("nodeinfos", infos)
                status, _ = run_pre_filter_plugins(filters, state, pod, infos)
                if not is_success(status):
                    return False
            else:
                state.write("nodeinfo/" + trimmed.name, trimmed)
                state.write("nodeinfos", [trimmed])
        try:
            feasible, _ = run_filter_plugins(filters, state, pod, [trimmed])
        except Exception:
            return False
        return bool(feasible)

    def _select_victims(self, pod: Any, ni: NodeInfo,
                        node_infos: List[NodeInfo],
                        shared_state: Optional[CycleState] = None
                        ) -> Optional[List[Any]]:
        # gang shield: a gang member is never a victim (evicting one
        # strands its bound siblings as a partial gang)
        lower, shielded = [], 0
        for p in ni.pods:
            if p.spec.priority >= pod.spec.priority:
                continue
            if gang_key(p) is not None:
                shielded += 1
            else:
                lower.append(p)
        if shielded:
            counters.inc("gang.preempt_shielded", shielded)
        if not lower:
            return None
        evictable = {id(p) for p in lower}
        remaining = [p for p in ni.pods if id(p) not in evictable]
        if not self._feasible_after(pod, ni, remaining, node_infos,
                                    shared_state):
            return None  # no fit even with every lower-priority pod gone
        # reprieve most important first: higher priority, then earlier
        # creation (the status.startTime analog), then name
        lower.sort(key=lambda p: (-p.spec.priority,
                                  p.metadata.creation_timestamp,
                                  p.metadata.name))
        # probe gate: with NodeResourcesFit in the chain, a reprieve that
        # overcommits the node must fail the whole probe, so the real Fit
        # filter on an incrementally kept NodeInfo marks it a victim
        # without running the chain
        fit = next((f for f in self.h.filter_plugins
                    if isinstance(f, NodeResourcesFit)), None)
        probe_ni = None
        if fit is not None and ni.node is not None:
            [probe_ni] = build_node_infos([ni.node], remaining)
        victims: List[Any] = []
        for v in lower:
            if probe_ni is not None:
                probe_ni.add_pod(v)
                if not is_success(fit.filter(CycleState(), pod, probe_ni)):
                    probe_ni.remove_pod(v)
                    victims.append(v)
                    continue
            remaining.append(v)
            if not self._feasible_after(pod, ni, remaining, node_infos,
                                        shared_state):
                remaining.pop()
                victims.append(v)
                if probe_ni is not None:
                    probe_ni.remove_pod(v)
        return victims  # possibly empty: the pod fits with no eviction

    def post_filter(self, state: CycleState, pod: Any,
                    node_infos: List[NodeInfo],
                    diagnosis: Any) -> Tuple[Optional[str], Status]:
        self.last_victims = []
        if self.h is None:
            return None, Status.error(f"{NAME}: no engine handle injected")
        if not preemption_might_help(diagnosis):
            return None, Status.unschedulable(REASON_CANNOT_HELP).with_plugin(
                NAME)
        cap = self._max_candidates(len(node_infos))
        candidates: List[Tuple[NodeInfo, List[Any]]] = []
        statuses = getattr(diagnosis, "node_to_status", {}) or {}
        shared_state = self._shared_prefilter_state(pod, node_infos)
        for ni in node_infos:  # name-sorted snapshot: deterministic order
            st = statuses.get(ni.name)
            if (st is not None
                    and st.code.name == "UNSCHEDULABLE_AND_UNRESOLVABLE"):
                continue  # no eviction fixes these
            victims = self._select_victims(pod, ni, node_infos, shared_state)
            if victims is not None:
                if not victims:
                    # every reprieve succeeded: the pod fits with no
                    # eviction (the snapshot drifted since it failed)
                    return ni.name, Status.success()
                candidates.append((ni, victims))
                if len(candidates) >= cap:
                    break
        if not candidates:
            return None, Status.unschedulable(
                REASON_NO_CANDIDATES).with_plugin(NAME)

        def _pick_key(c):
            victims = c[1]
            top = max(v.spec.priority for v in victims)
            return (top,
                    sum(v.spec.priority for v in victims),
                    len(victims),
                    -min(v.metadata.creation_timestamp for v in victims
                         if v.spec.priority == top),
                    c[0].name)

        best_ni, best_victims = min(candidates, key=_pick_key)
        for v in best_victims:
            try:
                self.h.client.pods(v.metadata.namespace).delete(v.metadata.name)
                self.last_victims.append(v)
            except KeyError:
                pass  # already gone (stale snapshot): the capacity is free
        return best_ni.name, Status.success()
