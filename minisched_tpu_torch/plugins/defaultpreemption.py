"""DefaultPreemption: the in-tree PostFilter plugin, up to its body.

Counterpart of ``minisched_tpu/plugins/defaultpreemption.py``.  The port
keeps the gate the live engine applies before it calls the plugin
(``preemption_might_help`` over ``NODE_STATIC_PLUGINS``, ``:57-95``): a
wave loser that failed only on filters whose verdict no eviction can
change never reaches PostFilter.  The plugin's body — a dry run of every
filter against each candidate node with victims removed — needs the
scalar per-(pod, node) filter halves, which the port does not have
(ROADMAP item 10e), so ``post_filter`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from minisched_tpu_torch.framework.plugin import Plugin
from minisched_tpu_torch.framework.types import CycleState, Status

NAME = "DefaultPreemption"

DEFAULT_MIN_CANDIDATE_NODES_PERCENTAGE = 10
DEFAULT_MIN_CANDIDATE_NODES_ABSOLUTE = 100

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
    NODE_STATIC_PLUGINS).  An empty failure set is conservatively True."""
    failed = getattr(diagnosis, "unschedulable_plugins", None)
    if not failed:
        return True
    return bool(set(failed) - NODE_STATIC_PLUGINS)


class DefaultPreemption(Plugin):
    def __init__(
        self,
        min_candidate_nodes_percentage: int = DEFAULT_MIN_CANDIDATE_NODES_PERCENTAGE,
        min_candidate_nodes_absolute: int = DEFAULT_MIN_CANDIDATE_NODES_ABSOLUTE,
    ):
        self.min_candidate_nodes_percentage = min_candidate_nodes_percentage
        self.min_candidate_nodes_absolute = min_candidate_nodes_absolute
        #: victims deleted by the most recent post_filter call (the
        #: engine's wave-loser pass reads and clears it)
        self.last_victims: List[Any] = []

    def name(self) -> str:
        return NAME

    def post_filter(self, state: CycleState, pod: Any, node_infos: List[Any],
                    diagnosis: Any) -> Tuple[Optional[str], Status]:
        raise NotImplementedError(
            "DefaultPreemption's dry run needs the scalar filter halves of "
            "every plugin: ROADMAP item 10e"
        )
